"""The readings a cell's limits are set from, on the card at the cell's
own size (``PERF.md`` gives them for every limit).

    python3 benchmark/tests/calibrate.py --workload <name> \
        --seeds 1,2,... --control-seeds 7,8,9

prints one JSON line per reading with the numbers of
``harness/check.py``:

  - ``program``: the program's first grad steps, through the window's own
    ``FusedLoop.run`` after the cell's set-up, against the reference (the
    lower readings);
  - ``control``: the reference itself in the program's place, computed
    in TF32 (the nearest precision below the configuration's float32
    with TF32 off), against the reference in float32;
  - ``half_batch``: the reference in the program's place with its critic
    loss the mean over the first half of each rank's rows alone;
  - ``no_exchange`` (several ranks): the reference in the program's place
    with every rank stepping on its own gradients, never averaged;
  - ``slot_shift`` (PER): the reference in the program's place with every
    slot its sampler draws moved to the next leaf.

A state left unchanged reads 1 on ``grad1_gap``, ``change3_gap``,
``target3_gap``, ``moments3_gap`` and their median gaps by their
definition and needs no run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import check, learn, spec  # noqa: E402
from reference import per as ref_per  # noqa: E402


class HalfBatch:
    """The critic loss over the first half of each rank's rows alone
    (its TD errors, for the write-back, over all of them)."""

    def _critic_loss(self, leaves, r):
        _, td = super()._critic_loss(leaves, r)
        half = td.shape[0] // 2
        head = {k: v[:half] if torch.is_tensor(v) else v
                for k, v in r.items()}
        loss, _ = super()._critic_loss(leaves, head)
        return loss, td


class NoExchange:
    """Every rank steps on its own rows' gradients: one learner per rank,
    the losses still the ranks' mean, rank 0's state reported."""

    last = None

    def __init__(self, cfg, params):
        super().__init__(cfg, params)
        self.ranks: list | None = None
        NoExchange.last = self

    def step(self, rows):
        if self.ranks is None:
            self.ranks = [self.plain(self.cfg, self.p) for _ in rows]
        res = [lr.step([r]) for lr, r in zip(self.ranks, rows)]
        zero = self.ranks[0]
        self.p, self.target, self.opt = zero.p, zero.target, zero.opt
        self.grads = zero.grads
        return {"losses": {name: sum(r["losses"][name] for r in res)
                           / len(res) for name in res[0]["losses"]},
                "td": [r["td"][0] for r in res]}

    def replicas(self) -> list:
        return [torch.cat([lr.p[n][k].reshape(-1).cpu()
                           for n in lr.p for k in lr.p[n]])
                for lr in self.ranks]


class SlotShift:
    """A sampler whose every slot is its neighbour's: the reference's
    descent moved one leaf on (``planted``)."""


def readings(cell) -> list:
    """``(kind, learner class, lower)`` of the cell's control and each
    fault it can have, over the family's grad step (``Learner`` of
    ``families/<family>.py``)."""
    plain = spec.family(cell.config).Learner

    def over(fault):
        return type(fault.__name__, (fault, plain), {"plain": plain})

    kinds = [("control", plain, True), ("half_batch", over(HalfBatch), False)]
    if int(cell.traffic.get("ranks", 1)) > 1:
        kinds.append(("no_exchange", over(NoExchange), False))
    if cell.traffic["prioritized"]:
        kinds.append(("slot_shift", over(SlotShift), False))
    return kinds


@contextlib.contextmanager
def planted(cls):
    saved = ref_per.Trees.descend
    if issubclass(cls, SlotShift):
        ref_per.Trees.descend = lambda self, mass: torch.clamp(
            saved(self, mass) + 1, max=self.size - 1)
    try:
        yield
    finally:
        ref_per.Trees.descend = saved


def program_readings(cell, seeds, device):
    """The program's check outputs per seed (one process; ranks spawned
    once for every seed on a mesh)."""
    ranks = int(cell.traffic.get("ranks", 1))
    if ranks == 1:
        out = []
        for seed in seeds:
            res = learn.learn(cell, seed, 0.0, False, device, time.time())
            out.append([res["prog"]])
        return out
    from d4pg_tpu_torch.parallel.multihost import spawn_local
    import os

    os.environ["NCCL_SHM_DISABLE"] = "1"
    per_rank = spawn_local(seeds_rank, ranks, args=(cell, seeds),
                           device_type=device.type, timeout_s=1800.0)
    return [[r[i] for r in per_rank] for i in range(len(seeds))]


def seeds_rank(mesh, cell, seeds):
    return [learn.learn(cell, seed, 0.0, False, mesh.device, time.time(),
                        mesh)["prog"] for seed in seeds]


def joined(progs: list) -> dict:
    prog = dict(progs[0])
    if len(progs) > 1:
        for key in ("td", "idx"):
            prog[key] = torch.cat([p[key] for p in progs], dim=1)
        if "roots" in prog:
            prog["roots"] = [x for p in progs for x in p["roots"]]
            prog["leaves"] = [x for p in progs for x in p["leaves"]]
    return prog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    runner = spec.plugin("runners", cell.traffic["runner"])
    per = bool(cell.traffic["prioritized"])
    ranks = int(cell.traffic.get("ranks", 1))
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    progs = program_readings(cell, seeds, device) if seeds else []
    for seed, prog in zip(seeds, progs):
        p = joined(prog)
        ref = runner.reference(cell, seed, device, p["idx"])
        nums = check.numbers(p, ref, per, [x["params"] for x in prog]
                             if ranks > 1 else None)
        print(json.dumps({"kind": "program", "seed": seed, **nums,
                          "worst": check.worst_leaves(p, ref)}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for kind, cls, lower in readings(cell):
            with planted(cls):
                fake = runner.reference(cell, seed, device, lower=lower,
                                        learner=cls)
            replicas = (NoExchange.last.replicas()
                        if issubclass(cls, NoExchange) else None)
            ref = runner.reference(cell, seed, device, fake["idx"])
            nums = check.numbers(fake, ref, per, replicas)
            print(json.dumps({"kind": kind, "seed": seed, **nums,
                              "worst": check.worst_leaves(fake, ref)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
