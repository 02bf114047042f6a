"""Runner of the fused learner cells: ``FusedLoop.run`` over a full
device replay ring, on one card or on one rank per card.

On one card the whole run is this process (``harness/learn.py``). With
``ranks > 1`` the ranks are ``parallel.multihost.spawn_local``'s, the
program's own launcher for ``--data_parallel``: rank r on ``cuda:r``,
NCCL between them (shared memory off, so nothing lands in /dev/shm), and
this process waits without touching a card. Once the program's state is
gone (the ranks have exited, or this process dropped it) the reference
follows the first grad steps on the first card from the same inputs,
and the numbers of ``harness/check.py`` decide ``correct``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import os

import torch

from harness import check, inputs, learn, spec
from reference.learner import follow

RANK_TIMEOUT_S = 330.0


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 (``on``) or in float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def draws(cell, seed: int, device, steps: int) -> dict:
    """The random draws the program's first steps took: the loop's PER
    uniforms or uniform slots per rank, and the family's own from the
    state's generator."""
    cfg, traffic = cell.config, cell.traffic
    ranks, b = int(traffic.get("ranks", 1)), int(traffic["batch_size"])
    gens = [inputs.generator(device, seed, "loop", r) for r in range(ranks)]
    out = {}
    if traffic["prioritized"]:
        out["u"] = [[torch.rand(b, generator=g, device=device) for g in gens]
                    for _ in range(steps)]
    else:
        size = max(int(traffic["fill_rows"]), 1)
        out["slots"] = [[torch.randint(0, size, (b,), generator=g,
                                       dtype=torch.int32, device=device)
                         for g in gens] for _ in range(steps)]
    out.update(spec.family(cfg).draws(
        cfg, traffic, inputs.generator(device, seed, "state"), device, steps))
    return out


def reference(cell, seed: int, device, slots=None,
              steps: int = learn.CHECK_STEPS, lower: bool = False,
              learner=None) -> dict:
    """The reference's first ``steps`` grad steps of ``cell`` for
    ``seed``, judging and following the program's ``slots`` (in TF32
    when ``lower``: the control), with the family's grad step or the
    ``learner`` class given in its place."""
    cfg, traffic = cell.config, cell.traffic
    family = spec.family(cfg)
    with tf32(lower):
        params = inputs.make_params(cfg, seed, device)
        return follow(
            cfg, traffic, (learner or family.Learner)(cfg, params), params,
            lambda r, idx: inputs.rows_at(cfg, traffic, seed, r, idx,
                                          device),
            functools.partial(family.apply_draws, cfg),
            draws(cell, seed, device, steps), steps, slots)


def run(cell, seed: int, seconds: float, traced: bool, t_start: float,
        device: torch.device | None = None, prepare: str | None = None
        ) -> dict:
    """Run the cell; returns rank 0's measurements, the busy seconds
    averaged over ranks, the peak over ranks and the check's numbers."""
    ranks = int(cell.traffic.get("ranks", 1))
    device = device or torch.device("cuda", 0)
    descent = spec.plugin("flops", "descent").bytes_per_query_set
    if ranks == 1:
        res = [learn.learn(cell, seed, seconds, traced, device, t_start,
                           descent_bytes=descent)]
    else:
        from d4pg_tpu_torch.parallel.multihost import spawn_local

        os.environ["NCCL_SHM_DISABLE"] = "1"
        res = spawn_local(learn.rank_main, ranks,
                          args=(cell, seed, seconds, traced, t_start,
                                prepare),
                          device_type=device.type,
                          timeout_s=RANK_TIMEOUT_S)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    progs = [r.pop("prog") for r in res]
    out = dict(res[0])
    prog = progs[0]
    if ranks > 1:
        prog = dict(prog)
        for key in ("td", "idx"):
            prog[key] = torch.cat([p[key] for p in progs], dim=1)
        if "roots" in prog:
            prog["roots"] = [x for p in progs for x in p["roots"]]
            prog["leaves"] = [x for p in progs for x in p["leaves"]]
    out["memory_peak_bytes"] = max(r.get("memory_peak_bytes", 0)
                                   for r in res)
    out["banned"] = sorted({m for r in res for m in r["banned"]})
    if traced:
        out["busy_s"] = sum(r["trace"].busy_s for r in res) / len(res)
    ref_device = device if device.type == "cuda" else torch.device("cpu")
    ref = reference(cell, seed, ref_device, prog["idx"])
    out["numbers"] = check.numbers(
        prog, ref, bool(cell.traffic["prioritized"]),
        [p["params"] for p in progs] if ranks > 1 else None)
    return out
