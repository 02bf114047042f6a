"""Adam and the first grad steps of a fused learner, in plain PyTorch.

``follow`` runs the first grad steps of a fused chunk: per step and rank
a stratified PER draw (or the given uniform slots), the ring rows with
the family's own draws applied, the IS weights, the family's grad step
(``families/<family>.py``'s ``Learner``; ``reference/d4pg.py`` for
D4PG), the priority write-back.
"""

from __future__ import annotations

import torch

from reference.per import Trees, beta_schedule, is_weights, \
    sharded_is_weights


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


def follow(cfg: dict, traffic: dict, learner, params: dict, rows_of,
           prepare, draws: dict, steps: int,
           slots: torch.Tensor | None = None) -> dict:
    """The first ``steps`` grad steps of the fused chunk on every rank.

    ``learner`` is the family's grad step, made from the initial weights
    ``params`` (``{net: {name: tensor}}``): ``step(rows)`` returns the
    step's ``losses`` by name and each rank's ``td``, and it keeps ``p``,
    ``target`` (the networks that have one) and ``opt`` by network,
    ``grads``, each step's gradients by network, and ``FIRST``, the
    networks it differentiates before its first optimizer step. ``rows_of(rank, slots)``
    returns that rank's ring rows at ``slots`` (a dict of tensors), and
    ``prepare(row, draws, t, rows)`` applies the family's draws of step
    ``t`` to the row of the batch's rows ``rows`` (a slice). ``draws``
    holds per step and rank the PER uniforms ``u`` [steps][ranks] or
    uniform ``slots``, and the family's own.

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
    dev = next(iter(next(iter(params.values())).values())).device
    fill = int(traffic["fill_rows"])
    b = int(traffic["batch_size"])
    trees = ([Trees(int(cfg["memory_size"]) // ranks, fill, dev)
              for _ in range(ranks)] if per else None)
    out = {"losses": {}, "td": [], "idx": [], "own_idx": []}
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
            row = prepare(rows_of(r, idx[r]), draws, t,
                          slice(r * b, (r + 1) * b))
            row["weights"] = w[r]
            rows.append(row)
        res = learner.step(rows)
        if per:
            for r in range(ranks):
                trees[r].write_back(idx[r], res["td"][r],
                                    float(cfg["per_alpha"]))
        for name, loss in res["losses"].items():
            out["losses"].setdefault(name, []).append(loss)
        out["td"].append(torch.cat(res["td"]))
        out["idx"].append(torch.cat(idx))
        out["own_idx"].append(torch.cat(own))
    for key in ("td", "idx", "own_idx"):
        out[key] = torch.stack(out[key]).cpu()
    if per:
        out["slot_gap"] = slot_gap

    def norm(x):
        return float(x.double().norm())

    out["first_nets"] = list(learner.FIRST)
    out["grad1"] = {f"{net}/{k}": norm(g)
                    for net, gs in learner.grads[0].items()
                    for k, g in gs.items()}
    out["change3"], out["target3"], out["moments3"] = {}, {}, {}
    for net, leaves0 in params.items():
        for k, p0 in leaves0.items():
            key = f"{net}/{k}"
            out["change3"][key] = norm(learner.p[net][k] - p0)
            if net in learner.target:
                out["target3"][key] = norm(learner.target[net][k] - p0)
            out["moments3"][key + "/m"] = norm(learner.opt[net].m[k])
            out["moments3"][key + "/v"] = norm(learner.opt[net].v[k])
    if per:
        out["roots"] = [float(t.sum_tree[1]) for t in trees]
        out["leaves"] = [t.leaves.cpu() for t in trees]
    return out
