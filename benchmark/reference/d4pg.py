"""The D4PG grad step over R data-parallel ranks (R = 1 for one card), each
with its own rows, in plain PyTorch:

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

A family subclasses ``Learner`` with its networks (``actor``,
``critic``) and what they share (``tie``, applied after each Adam step
and after the soft update).
"""

from __future__ import annotations

import torch

from reference.learner import Adam

LOG_EPS = 1e-10


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


class Learner:
    """The learner's networks, targets and optimizers from initial
    weights ``params`` (``{"actor": {...}, "critic": {...}}``).

    ``p``, ``target`` and ``opt`` are keyed by network, ``grads`` holds
    each step's averaged gradients by network, and ``step`` returns the
    step's losses by name, as ``reference.learner.follow`` reads them.
    ``FIRST`` names the networks the step differentiates before its
    first optimizer step."""

    FIRST = ("critic",)

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

    def actor(self, p: dict, obs: torch.Tensor) -> torch.Tensor:
        """pi(s) in (-1, 1)^act_dim."""
        raise NotImplementedError

    def critic(self, p: dict, obs: torch.Tensor,
               action: torch.Tensor) -> torch.Tensor:
        """Z(s, a) as [B, n_atoms] probabilities."""
        raise NotImplementedError

    def tie(self, nets: dict) -> None:
        """Make the leaves the networks share equal again (none here)."""

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
            na = self.actor(self.target["actor"], r["next_obs"])
            tp = self.critic(self.target["critic"], r["next_obs"], na)
            proj = projection(cfg, tp, r["reward"], r["discount"])
        q = self.critic(leaves, r["obs"], r["action"])
        td = -torch.sum(proj * torch.log(q + LOG_EPS), dim=-1)
        w = r.get("weights")
        return torch.mean(td if w is None else w * td), td.detach()

    def _actor_loss(self, leaves, r):
        cfg = self.cfg
        a = self.actor(leaves, r["obs"])
        atoms = torch.linspace(float(cfg["v_min"]), float(cfg["v_max"]),
                               int(cfg["n_atoms"]), dtype=torch.float32,
                               device=a.device)
        q = torch.sum(self.critic(self.p["critic"], r["obs"], a) * atoms,
                      dim=-1)
        return -torch.mean(q), None

    def step(self, rows: list[dict]) -> dict:
        """One grad step over the ranks' rows (each a dict of obs, action,
        reward, next_obs, discount and optional weights, the family's
        draws already applied). Returns the losses (means over ranks) by
        name and each rank's TD errors."""
        g_c, critic_loss, tds = self._mean_grads(self._critic_loss,
                                                 self.p["critic"], rows)
        self.opt["critic"].step(self.p["critic"], g_c)
        self.tie(self.p)
        g_a, actor_loss, _ = self._mean_grads(self._actor_loss,
                                              self.p["actor"], rows)
        self.opt["actor"].step(self.p["actor"], g_a)
        self.tie(self.p)
        tau = float(self.cfg["tau"])
        with torch.no_grad():
            for net in ("actor", "critic"):
                for k, t in self.target[net].items():
                    t.mul_(1.0 - tau).add_(self.p[net][k], alpha=tau)
        self.tie(self.target)
        self.grads.append({"actor": g_a, "critic": g_c})
        return {"losses": {"critic_loss": float(critic_loss),
                           "actor_loss": float(actor_loss)},
                "td": tds}
