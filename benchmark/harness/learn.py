"""One learner process: set-up, the checked first steps, the warm-up, the
timed window and the traced slice, on one device (one rank of a mesh, or
the only one).

The window runs ``FusedLoop.run(state, K)`` chunk after chunk until the
host clock passes ``seconds``; it starts after a synchronize (and, on a
mesh, a barrier) and ends with the synchronize that closes the last
chunk, so the rate counts every step it queued. On a mesh the ranks
agree after each chunk whether to stop (a host-side ``all_reduce`` of a
flag), so every rank queues the same collectives.
"""

from __future__ import annotations

import sys
import time

import torch

from harness import program, trace

CHECK_STEPS = 3
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "d4pg_tpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is a banned one (compared
    whole: ``d4pg_tpu_torch`` is not ``d4pg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _agree(stop: bool, mesh) -> bool:
    if mesh is None or mesh.world == 1:
        return stop
    import torch.distributed as dist

    flag = torch.tensor([1 if stop else 0], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.cpu_group)
    return bool(flag.item())


def learn(cell, seed: int, seconds: float, traced: bool, device,
          t_start: float, mesh=None, descent_bytes=None) -> dict:
    """Everything one process measures and checks; small host values
    only (the program's state is gone when it returns)."""
    cfg, traffic = cell.config, cell.traffic
    k = int(traffic["k"])
    lrn = program.learner(cfg, traffic, seed, device, mesh)
    prog = program.check_steps(lrn, cfg, CHECK_STEPS)
    state, loop = lrn.state, lrn.loop
    loop.run(state, k)  # warm-up: one chunk at the cell's shapes
    _sync(device)
    if mesh is not None:
        mesh.barrier()
    window_start = time.time()
    steps = 0
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        metrics = loop.run(state, k)
        steps += k
        marks.append(time.perf_counter())
        if _agree(marks[-1] - t0 >= seconds, mesh):
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    finite = [torch.isfinite(metrics[name]) for name in lrn.family.LOSSES]
    bad = int((~torch.stack(finite).all(dim=0)).sum())
    out = {"steps": steps, "elapsed": elapsed,
           "chunk_s": [b - a for a, b in zip(marks, marks[1:])],
           "setup_s": window_start - t_start, "fill_s": lrn.fill_s,
           "nonfinite": bad, "prog": prog, "trace": None}
    if traced:
        slots = []

        def chunks():
            for _ in range(int(traffic["trace_chunks"])):
                slots.append(loop.run(state, k)["idx"])

        out["trace"] = trace.traced(chunks, device)
        out["trace_steps"] = k * len(slots)
        trees = lrn.buffer.trees
        if descent_bytes is not None and trees is not None:
            cap = trees.sum_tree.shape[-1] // 2
            per_step = [descent_bytes(s, cap) for c in slots for s in c]
            out["descent_bytes_per_step"] = sum(per_step) / len(per_step)
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    loop.close()
    out["banned"] = banned_modules()
    return out


def rank_main(mesh, cell, seed, seconds, traced, t_start, prepare):
    """One rank of a mesh cell (``parallel.multihost.spawn_local``'s
    ``fn``). ``prepare`` (``"module:function"`` or ``None``) runs first:
    the tests break the program underneath through it."""
    if prepare:
        import importlib

        mod, fn = prepare.split(":")
        getattr(importlib.import_module(mod), fn)()
    from harness import spec

    descent = spec.plugin("flops", "descent").bytes_per_query_set
    return learn(cell, seed, seconds, traced, mesh.device, t_start, mesh,
                 descent_bytes=descent)
