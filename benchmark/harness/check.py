"""The numbers that decide ``correct``: what the program's first grad
steps produced against what the reference works out from the same
inputs. Each is 0 for a perfect match; each has a limit per cell in
``limits/<cell>.json``, and every number is compared (how the limits
were set: ``PERF.md``).

  - ``loss_gap``: the largest relative gap of a step's loss, over every
    loss the family's grad step reports (for D4PG the critic and the
    policy loss);
  - ``td_gap``: the largest over steps of ``||td_p - td_r|| / ||td_r||``;
  - ``slots_differ``: the share of the program's slots that differ from
    the reference's own draws where those are exact: PER's first step,
    every step of uniform replay;
  - ``slot_gap`` (PER): how far a uniform's mass lies outside the stretch
    of cumulative priority of the slot the program drew for it, in units
    of that slot's priority, at worst (the reference follows the
    program's slots: see ``reference/learner.follow``);
  - ``change3_gap``, ``target3_gap``: by the worst leaf of every network
    of the family, the gap between the program's and the reference's
    norm of the leaf's change over the steps and of its target's change
    (networks with a target), each over the larger of the reference's
    norm of that leaf and of the median leaf. They leave out leaves whose
    reference gradient is below a thousandth of the median leaf's (they
    move by round-off alone under Adam);
  - ``grad1_gap``, ``moments3_gap``: the same gaps of the leaf's first
    gradient (as Adam got it) and of Adam's two moments after the steps,
    by the worst leaf of the networks the grad step differentiates
    before its first optimizer step (the reference learner's ``FIRST``:
    D4PG's critic). A later network's first gradient is taken through
    parameters that one Adam step has moved, and Adam's first step moves
    each element by about the learning rate whatever its gradient's
    size: on a few seeds and runs that gap comes out a thousand times
    wider than on the rest, with no fault;
  - ``change3_median_gap``, ``target3_median_gap``, ``grad1_median_gap``,
    ``moments3_median_gap``: the same gaps at the median leaf of every
    network, held beside the worst leaf's: steady from seed to seed;
  - ``tree_gap`` (PER): the largest relative gap of a tree's total and of
    a priority written back;
  - ``replica_gap`` (data-parallel): the largest relative distance of a
    rank's parameters from rank 0's after the steps.
"""

from __future__ import annotations

import statistics

import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_gaps(prog: dict, ref: dict, keys=None) -> list[float]:
    keys = list(ref) if keys is None else keys
    if not keys:
        return [0.0]
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def _worst_leaf(prog: dict, ref: dict, keys=None) -> float:
    return max(_leaf_gaps(prog, ref, keys))


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf behind each worst-leaf number, with its gap."""
    out = {}
    for name in ("grad1", "change3", "target3", "moments3"):
        med = statistics.median(ref[name].values())
        gaps = {k: abs(prog[name][k] - r) / max(r, med, 1e-30)
                for k, r in ref[name].items()}
        k = max(gaps, key=gaps.get)
        out[name] = [k, gaps[k], prog[name][k], ref[name][k], med]
    return out


def numbers(prog: dict, ref: dict, per: bool,
            replicas: list | None = None) -> dict:
    """The numbers of the program's outputs ``prog`` against the
    reference's ``ref``, which followed the program's slots."""
    if set(prog["losses"]) != set(ref["losses"]):
        raise ValueError(f"the program reports the losses "
                         f"{sorted(prog['losses'])}, the reference "
                         f"{sorted(ref['losses'])}")
    out = {"loss_gap": max(
        _rel(p, r) for name in ref["losses"]
        for p, r in zip(prog["losses"][name], ref["losses"][name]))}
    # the draws the reference's own sampler reproduces exactly: PER's
    # first step (every priority is 1), every uniform step
    drawn = prog["idx"][:1] if per else prog["idx"]
    out["slots_differ"] = float(
        (drawn != ref["own_idx"][:drawn.shape[0]]).float().mean())
    out["td_gap"] = max(
        float((p.double() - r.double()).norm()
              / r.double().norm().clamp_min(1e-30))
        for p, r in zip(prog["td"], ref["td"]))
    first = set(ref["first_nets"])
    for name in ("grad1", "moments3"):
        gaps = dict(zip(ref[name], _leaf_gaps(prog[name], ref[name])))
        out[f"{name}_gap"] = max(g for k, g in gaps.items()
                                 if k.split("/")[0] in first)
        out[f"{name}_median_gap"] = statistics.median(gaps.values())
    med = statistics.median(ref["grad1"].values())
    moving = [k for k, g in ref["grad1"].items()
              if g >= EXCLUDE_BELOW * med]
    targeted = [k for k in moving if k in ref["target3"]]
    out["change3_gap"] = _worst_leaf(prog["change3"], ref["change3"],
                                     moving)
    out["target3_gap"] = _worst_leaf(prog["target3"], ref["target3"],
                                     targeted)
    out["change3_median_gap"] = statistics.median(
        _leaf_gaps(prog["change3"], ref["change3"], moving))
    out["target3_median_gap"] = statistics.median(
        _leaf_gaps(prog["target3"], ref["target3"], targeted))
    if per:
        out["slot_gap"] = ref["slot_gap"]
        tree = [_rel(p, r) for p, r in zip(prog["roots"], ref["roots"])]
        b = ref["idx"].shape[1] // len(ref["roots"])
        for r, (lp, lr) in enumerate(zip(prog["leaves"], ref["leaves"])):
            slots = torch.unique(prog["idx"][:, r * b:(r + 1) * b])
            lp, lr = lp[slots].double(), lr[slots].double()
            tree.append(float(((lp - lr).abs() / lr.abs()).max()))
        out["tree_gap"] = max(tree)
    if replicas is not None:
        base = replicas[0].double()
        out["replica_gap"] = max(
            float((p.double() - base).norm() / base.norm()) for p in replicas)
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number the run
    read within its limit, and every number finite. A number without a
    limit, or a limit without a number, is an error: nothing passes
    uncompared."""
    if set(values) != set(limits):
        raise ValueError(
            f"numbers without a limit: {sorted(set(values) - set(limits))}; "
            f"limits without a number: {sorted(set(limits) - set(values))}")
    shown = {name: {"value": values[name], "limit": lim}
             for name, lim in limits.items()}
    ok = (all(v == v for v in values.values())
          and all(s["value"] <= s["limit"] for s in shown.values()))
    return ok, shown
