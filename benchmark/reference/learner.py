"""The D4PG update and the first grad steps of a fused learner, in plain
PyTorch.

One grad step over R data-parallel ranks (R = 1 for one card), each with
its own rows:

  - the DrQ shift of obs and next_obs at the given offsets (pixels):
    edge-padded by ``pad`` and cropped back at an offset in [0, 2 pad];
  - the target distribution Z'(s', pi'(s')) from the target nets;
  - its categorical Bellman projection onto the support (each atom's
    mass split linearly between its two neighbouring bins after
    ``clip(r + d z, v_min, v_max)``) and the per-row cross-entropy
    ``-sum proj log(q + 1e-10)`` against the critic's distribution, the
    TD error;
  - the critic loss, the mean of IS weight times TD error, and its
    gradient, averaged over ranks; Adam (bias-corrected, eps 1e-8);
  - the policy loss -E[Z(s, pi(s))] through the stepped critic, its
    gradient with respect to the actor alone, averaged over ranks; Adam;
  - the soft target update ``t <- (1 - tau) t + tau o``.

With a shared pixel encoder the actor's encoder is the critic's after
each Adam step, and the target actor's the target critic's.

``follow`` runs the first grad steps of a fused chunk: per step and rank
a stratified PER draw (or the given uniform slots), the ring rows, the
IS weights, the update, the priority write-back.
"""

from __future__ import annotations

import torch

from reference import nets
from reference.per import Trees, beta_schedule, is_weights, \
    sharded_is_weights

LOG_EPS = 1e-10


def shift(frames: torch.Tensor, pad: int, offsets: torch.Tensor):
    """[B, H, W, C] frames moved by ``offsets`` [B, 2] (row, column) in
    [0, 2 pad], with edge-replicated fill."""
    b, h, w, _ = frames.shape
    dev = frames.device
    off = offsets.to(device=dev, dtype=torch.long)
    rows = (torch.arange(h, device=dev) + off[:, :1] - pad).clamp(0, h - 1)
    cols = (torch.arange(w, device=dev) + off[:, 1:] - pad).clamp(0, w - 1)
    return frames[torch.arange(b, device=dev)[:, None, None],
                  rows[:, :, None], cols[:, None, :]]


def projection(cfg: dict, probs: torch.Tensor, reward: torch.Tensor,
               discount: torch.Tensor) -> torch.Tensor:
    """The projected target distribution [B, A]."""
    v_min, v_max, n = float(cfg["v_min"]), float(cfg["v_max"]), \
        int(cfg["n_atoms"])
    dev = probs.device
    atoms = torch.linspace(v_min, v_max, n, dtype=torch.float32, device=dev)
    tz = torch.clamp(reward[:, None] + discount[:, None] * atoms, v_min,
                     v_max)
    delta = torch.tensor((v_max - v_min) / (n - 1), dtype=torch.float32,
                         device=dev)
    b = (tz - v_min) / delta
    j = torch.arange(n, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(b[:, :, None] - j), 0.0, 1.0)
    return torch.einsum("bi,bij->bj", probs, w)


class Adam:
    def __init__(self, params: dict, lr: float, b1: float, b2: float,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)


class Learner:
    """The learner's networks, targets and optimizers from initial
    weights ``params`` (``{"actor": {...}, "critic": {...}}``)."""

    def __init__(self, cfg: dict, params: dict):
        self.cfg = cfg
        self.p = {net: {k: v.clone() for k, v in params[net].items()}
                  for net in ("actor", "critic")}
        self.target = {net: {k: v.clone() for k, v in params[net].items()}
                       for net in ("actor", "critic")}
        self.opt = {net: Adam(self.p[net], float(cfg[f"lr_{net}"]),
                              float(cfg["adam_b1"]), float(cfg["adam_b2"]))
                    for net in ("actor", "critic")}
        self.grads: list[dict] = []  # the averaged gradients of each step

    def _tie(self, nets: dict) -> None:
        if self.cfg.get("pixels"):
            for k in nets["actor"]:
                if k.startswith("encoder."):
                    nets["actor"][k] = nets["critic"][k].clone()

    def _mean_grads(self, loss_fn, params: dict, rows: list) -> tuple:
        names = list(params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        total = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, extras = [], []
        for r in rows:
            loss, extra = loss_fn(leaves, r)
            # a leaf the loss does not reach (the detached shared encoder
            # in the policy loss) gets a zero gradient
            gs = torch.autograd.grad(loss, [leaves[k] for k in names],
                                     allow_unused=True)
            for k, g in zip(names, gs):
                if g is not None:
                    total[k] += g
            losses.append(loss.detach())
            extras.append(extra)
        n = torch.tensor(float(len(rows)), dtype=torch.float32,
                         device=total[names[0]].device)
        return ({k: g / n for k, g in total.items()},
                torch.stack(losses).mean(), extras)

    def _critic_loss(self, leaves, r):
        cfg = self.cfg
        with torch.no_grad():
            na = nets.actor(self.target["actor"], r["next_obs"], cfg)
            tp = nets.critic_probs(self.target["critic"], r["next_obs"], na,
                                   cfg)
            proj = projection(cfg, tp, r["reward"], r["discount"])
        q = nets.critic_probs(leaves, r["obs"], r["action"], cfg)
        td = -torch.sum(proj * torch.log(q + LOG_EPS), dim=-1)
        w = r.get("weights")
        return torch.mean(td if w is None else w * td), td.detach()

    def _actor_loss(self, leaves, r):
        cfg = self.cfg
        a = nets.actor(leaves, r["obs"], cfg)
        atoms = torch.linspace(float(cfg["v_min"]), float(cfg["v_max"]),
                               int(cfg["n_atoms"]), dtype=torch.float32,
                               device=a.device)
        q = torch.sum(nets.critic_probs(self.p["critic"], r["obs"], a, cfg)
                      * atoms, dim=-1)
        return -torch.mean(q), None

    def step(self, rows: list[dict]) -> dict:
        """One grad step over the ranks' rows (each a dict of obs, action,
        reward, next_obs, discount and optional weights, already
        shifted). Returns the losses (means over ranks) and each rank's
        TD errors."""
        g_c, critic_loss, tds = self._mean_grads(self._critic_loss,
                                                 self.p["critic"], rows)
        self.opt["critic"].step(self.p["critic"], g_c)
        self._tie(self.p)
        g_a, actor_loss, _ = self._mean_grads(self._actor_loss,
                                              self.p["actor"], rows)
        self.opt["actor"].step(self.p["actor"], g_a)
        self._tie(self.p)
        tau = float(self.cfg["tau"])
        with torch.no_grad():
            for net in ("actor", "critic"):
                for k, t in self.target[net].items():
                    t.mul_(1.0 - tau).add_(self.p[net][k], alpha=tau)
        self._tie(self.target)
        self.grads.append({"actor": g_a, "critic": g_c})
        return {"critic_loss": float(critic_loss),
                "actor_loss": float(actor_loss), "td": tds}


def follow(cfg: dict, traffic: dict, params: dict, rows_of, draws: dict,
           steps: int, slots: torch.Tensor | None = None) -> dict:
    """The first ``steps`` grad steps of the fused chunk on every rank.

    ``rows_of(rank, slots)`` returns that rank's ring rows at ``slots``
    (a dict of tensors); ``draws`` holds per step and rank the PER
    uniforms ``u`` [steps][ranks] or uniform ``slots``, and, for pixels,
    the shift offsets ``shift`` [steps] -> (obs [R b, 2], next [R b, 2]).

    ``slots`` ([steps, R b], rank-major), when given, are the slots the
    program drew: each is judged against this reference's own draw from
    the same uniforms (``own_idx``; for PER, ``slot_gap``: how far the
    uniform's mass lies outside the slot's stretch of this reference's
    priorities, in units of the slot's priority, at worst), and the
    steps go on with the program's slots, as a served model's tokens are
    followed to judge the next. A float32 sum over a million priorities
    moves a stratum's mass by a few hundredths of a priority between two
    correct runs, enough to move a slot across a boundary, and from then
    on the batches would differ. Without ``slots`` the reference follows
    its own draws. Returns what ``harness/check.py`` compares."""
    ranks = int(traffic.get("ranks", 1))
    per = bool(traffic["prioritized"])
    dev = params["critic"][next(iter(params["critic"]))].device
    fill = int(traffic["fill_rows"])
    b = int(traffic["batch_size"])
    trees = ([Trees(int(cfg["memory_size"]) // ranks, fill, dev)
              for _ in range(ranks)] if per else None)
    learner = Learner(cfg, params)
    out = {"critic_loss": [], "actor_loss": [], "td": [], "idx": [],
           "own_idx": []}
    slot_gap = 0.0
    for t in range(steps):
        if per:
            masses = [trees[r].masses(draws["u"][t][r]) for r in range(ranks)]
            own = [trees[r].sample(draws["u"][t][r]) for r in range(ranks)]
        else:
            own = [draws["slots"][t][r].long() for r in range(ranks)]
        idx = own if slots is None else [
            slots[t, r * b:(r + 1) * b].to(dev).long() for r in range(ranks)]
        if per:
            if slots is not None:
                slot_gap = max(slot_gap, *[
                    float(trees[r].outside(idx[r], masses[r]).max())
                    for r in range(ranks)])
            beta = beta_schedule(t, float(cfg["per_beta0"]),
                                 int(cfg["per_beta_steps"]))
            w = ([is_weights(trees[0], idx[0], beta)] if ranks == 1 else
                 sharded_is_weights(trees, idx, beta))
        else:
            w = [None] * ranks
        rows = []
        for r in range(ranks):
            row = rows_of(r, idx[r])
            if cfg.get("pixels"):
                obs_off, next_off = draws["shift"][t]
                sl = slice(r * b, (r + 1) * b)
                pad = int(cfg["augment_pad"])
                row["obs"] = shift(row["obs"], pad, obs_off[sl])
                row["next_obs"] = shift(row["next_obs"], pad, next_off[sl])
            row["weights"] = w[r]
            rows.append(row)
        res = learner.step(rows)
        if per:
            for r in range(ranks):
                trees[r].write_back(idx[r], res["td"][r],
                                    float(cfg["per_alpha"]))
        out["critic_loss"].append(res["critic_loss"])
        out["actor_loss"].append(res["actor_loss"])
        out["td"].append(torch.cat(res["td"]))
        out["idx"].append(torch.cat(idx))
        out["own_idx"].append(torch.cat(own))
    for key in ("td", "idx", "own_idx"):
        out[key] = torch.stack(out[key]).cpu()
    if per:
        out["slot_gap"] = slot_gap

    def norm(x):
        return float(x.double().norm())

    out["grad1"] = {f"{net}/{k}": norm(g)
                    for net, gs in learner.grads[0].items()
                    for k, g in gs.items()}
    out["change3"], out["target3"], out["moments3"] = {}, {}, {}
    for net in ("actor", "critic"):
        for k, p0 in params[net].items():
            key = f"{net}/{k}"
            out["change3"][key] = norm(learner.p[net][k] - p0)
            out["target3"][key] = norm(learner.target[net][k] - p0)
            out["moments3"][key + "/m"] = norm(learner.opt[net].m[k])
            out["moments3"][key + "/v"] = norm(learner.opt[net].v[k])
    if per:
        out["roots"] = [float(t.sum_tree[1]) for t in trees]
        out["leaves"] = [t.leaves.cpu() for t in trees]
    return out
