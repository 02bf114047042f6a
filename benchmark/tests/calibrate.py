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
``target3_gap`` and ``moments3_gap`` by their definition and needs no
run.
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
from reference import learner as ref_learner  # noqa: E402
from reference import per as ref_per  # noqa: E402


Plain = ref_learner.Learner


class HalfBatch(Plain):
    """The critic loss over the first half of each rank's rows alone
    (its TD errors, for the write-back, over all of them)."""

    def _critic_loss(self, leaves, r):
        _, td = super()._critic_loss(leaves, r)
        half = td.shape[0] // 2
        head = {k: v[:half] if torch.is_tensor(v) else v
                for k, v in r.items()}
        loss, _ = super()._critic_loss(leaves, head)
        return loss, td


class NoExchange(Plain):
    """Every rank steps on its own rows' gradients: one learner per rank,
    the losses still the ranks' mean, rank 0's state reported."""

    last = None

    def __init__(self, cfg, params):
        super().__init__(cfg, params)
        self.ranks: list | None = None
        NoExchange.last = self

    def step(self, rows):
        if self.ranks is None:
            self.ranks = [Plain(self.cfg, self.p)
                          for _ in rows]
        res = [lr.step([r]) for lr, r in zip(self.ranks, rows)]
        zero = self.ranks[0]
        self.p, self.target, self.opt = zero.p, zero.target, zero.opt
        self.grads = zero.grads
        return {"critic_loss": sum(r["critic_loss"] for r in res) / len(res),
                "actor_loss": sum(r["actor_loss"] for r in res) / len(res),
                "td": [r["td"][0] for r in res]}

    def replicas(self) -> list:
        return [torch.cat([lr.p[n][k].reshape(-1).cpu()
                           for n in ("actor", "critic") for k in lr.p[n]])
                for lr in self.ranks]


class SlotShift(Plain):
    """A sampler whose every slot is its neighbour's: the reference's
    descent moved one leaf on."""


@contextlib.contextmanager
def planted(cls):
    saved = ref_learner.Learner, ref_per.Trees.descend
    ref_learner.Learner = cls
    if cls is SlotShift:
        ref_per.Trees.descend = lambda self, mass: torch.clamp(
            saved[1](self, mass) + 1, max=self.size - 1)
    try:
        yield
    finally:
        ref_learner.Learner, ref_per.Trees.descend = saved


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
    kinds = [("control", Plain, True),
             ("half_batch", HalfBatch, False)]
    if ranks > 1:
        kinds.append(("no_exchange", NoExchange, False))
    if per:
        kinds.append(("slot_shift", SlotShift, False))
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for kind, cls, lower in kinds:
            with planted(cls):
                fake = runner.reference(cell, seed, device, lower=lower)
            replicas = (NoExchange.last.replicas() if cls is NoExchange
                        else None)
            ref = runner.reference(cell, seed, device, fake["idx"])
            nums = check.numbers(fake, ref, per, replicas)
            print(json.dumps({"kind": kind, "seed": seed, **nums,
                              "worst": check.worst_leaves(fake, ref)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
