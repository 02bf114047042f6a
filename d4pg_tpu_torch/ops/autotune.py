"""Startup micro-autotuner: the categorical-projection implementation and
the sample-on-ingest sampler.

Counterpart of ``d4pg_tpu/ops/autotune.py`` (``select_projection``,
``autotune_projection``, ``select_sampler``, ``autotune_sampler``, the
shared ``autotune_block`` record). ``projection="auto"`` times the candidates
on the real shape and picks the winner; an explicit ``einsum``,
``pallas`` or ``pallas_ce`` passes through untouched.

What gets timed: the critic-loss core each arm changes, one forward and
backward of the projected-Bellman cross-entropy at [B, A] with respect
to the predicted distribution (the plain ``categorical_projection`` then
the cross-entropy for ``einsum``, the projection kernel then the
cross-entropy for ``pallas``, the fused forward and backward kernels for
``pallas_ce``), warmed up, best of ``repeats`` windows of ``iters``
calls, each window ended by a synchronize on the card. Each of the three
arms is timed on its own.

Each timing run reports to ``io/profiling.record_build`` (the port's
``RecompileSentinel`` counts it); a cached decision reports nothing.

Static policy (no timing, reason recorded), as the reference's off its
accelerator: ``auto`` on the CPU, where each wrapper runs its plain
version and no kernel exists to time, and for a mesh learner, resolves
to ``einsum``.

A candidate that fails to build or to launch raises: it does not
quietly lose the race. Results are cached per (batch, support, mesh,
card): the card is the device type and its index, with ``cuda``
resolved to the current index, so ``cuda`` and ``cuda:0`` share one
race, as the reference keys by backend.

The sampler surface (``select_sampler``, ``--sampler``): arms ``scan``
(the plain torch descent on the card), ``pallas`` (the CUDA descent
kernel, ``ops/sampler_descent``) and ``host`` (the host dealer).
Explicit flags pass through. ``auto`` applies the reference's policy
with the card in the TPU's place: on the CPU it resolves to ``host``
without timing, as the reference's non-TPU backends do; on the card it
times the two device descents at the real [K * B] queries over the
tree's capacity and picks the faster (``host`` is never auto-selected
there: it would ship the sampled rows to the card again). The CUDA
kernel reads the tree from device memory, so no residency budget (the
Pallas kernel's VMEM) applies.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.core.distribution import (
    CategoricalSupport,
    categorical_projection,
)
from d4pg_tpu_torch.core.losses import categorical_td_loss, weighted_mean
from d4pg_tpu_torch.io.profiling import record_build
from d4pg_tpu_torch.ops.projection import projection
from d4pg_tpu_torch.ops.projection_ce import projection_ce

CANDIDATES = ("einsum", "pallas", "pallas_ce")


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    selected: str
    reason: str
    timings_ms: dict | None = None  # per-candidate best step time (None =
    #                                 static policy, nothing was timed)

    def as_json(self) -> dict:
        return {"selected": self.selected, "reason": self.reason,
                "timings_ms": self.timings_ms}


_CACHE: dict[tuple, AutotuneResult] = {}
_LOGGED: set[tuple] = set()

# Every select_* surface records its latest decision here; a bench
# persists the whole record as one schema-versioned ``autotune`` block.
AUTOTUNE_SCHEMA = 1
_SURFACES: dict[str, AutotuneResult] = {}


def _record(surface: str, result: AutotuneResult) -> AutotuneResult:
    _SURFACES[surface] = result
    return result


def autotune_block() -> dict:
    """The ``autotune`` block: chosen arm and timings of every surface
    that ran in this process, one schema under one key."""
    return {
        "metric": "autotune",
        "schema": AUTOTUNE_SCHEMA,
        "surfaces": {name: r.as_json() for name, r in _SURFACES.items()},
    }


def _loss_fn(variant: str, support: CategoricalSupport):
    """The variant's critic-loss core ``loss(pred, tp, r, d)``."""
    if variant == "pallas_ce":
        def loss(pred, tp, r, d):
            return weighted_mean(projection_ce(support, tp, r, d, pred))

        return loss

    project = projection if variant == "pallas" else categorical_projection

    def loss(pred, tp, r, d):
        with torch.no_grad():
            proj = project(support, tp, r, d)
        return categorical_td_loss(proj, pred)[0]

    return loss


def _time_variant(variant: str, support: CategoricalSupport,
                  batch_size: int, repeats: int, iters: int,
                  device: torch.device) -> float:
    """Best-of-``repeats`` time (ms) of one value-and-grad step of the
    variant's loss core at [batch_size, n_atoms] on ``device``."""
    rng = np.random.default_rng(0)
    a = support.n_atoms
    tp = rng.random((batch_size, a)).astype(np.float32)
    tp /= tp.sum(-1, keepdims=True)
    tp = torch.from_numpy(tp).to(device)
    pred = tp.clone().requires_grad_(True)
    r = torch.from_numpy(
        rng.standard_normal(batch_size).astype(np.float32)).to(device)
    d = torch.full((batch_size,), 0.99, dtype=torch.float32, device=device)
    loss_fn = _loss_fn(variant, support)

    def step():
        loss = loss_fn(pred, tp, r, d)
        return loss.detach(), torch.autograd.grad(loss, pred)[0]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step()  # warm-up (the first CUDA call builds the kernels)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        sync()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


def autotune_projection(batch_size: int, v_min: float, v_max: float,
                        n_atoms: int, repeats: int = 3, iters: int = 20,
                        device: str | torch.device | None = None,
                        ) -> AutotuneResult:
    """Time each candidate at the given shape on ``device`` (default
    ``cuda``) and return the winner. The caller gates by policy (see the
    module docstring); this function times whatever device it is
    given."""
    dev = resolve_device(device)
    record_build(f"autotune_projection [{batch_size}, {n_atoms}] on {dev}")
    support = CategoricalSupport(float(v_min), float(v_max), int(n_atoms))
    timings = {variant: round(_time_variant(variant, support, batch_size,
                                            repeats, iters, dev), 4)
               for variant in CANDIDATES}
    best = min(timings, key=timings.get)
    return AutotuneResult(
        best, f"measured fastest grad step at shape [{batch_size}, "
        f"{n_atoms}] on {dev.type}", timings)


def card_key(dev: torch.device) -> tuple[str, int | None]:
    """``(type, index)`` of the card ``dev`` names; ``cuda`` without an
    index is the current CUDA device."""
    if dev.type == "cuda" and dev.index is None:
        return dev.type, torch.cuda.current_device()
    return dev.type, dev.index


def select_projection(flag: str, *, batch_size: int, v_min: float,
                      v_max: float, n_atoms: int, mesh: bool = False,
                      device: str | torch.device | None = None,
                      ) -> AutotuneResult:
    """Resolve a ``projection`` flag to a concrete implementation.

    Explicit flags pass through untouched; ``auto`` applies the static
    policy, then measures on the card. ``device`` defaults to ``cuda``
    and raises without one. Logs the selection (once per distinct
    choice) so every run names the arm it trains with."""
    dev = resolve_device(device)
    if flag != "auto":
        return _record("projection",
                       AutotuneResult(flag, "explicit projection override"))
    key = ("sel", int(batch_size), float(v_min), float(v_max), int(n_atoms),
           bool(mesh), card_key(dev))
    if key not in _CACHE:
        if mesh:
            result = AutotuneResult(
                "einsum", "mesh learner: the port's kernels have no "
                "partitioning rule (einsum is the only legal candidate)")
        elif dev.type != "cuda":
            result = AutotuneResult(
                "einsum", f"{dev.type} device: every arm runs its plain "
                "version, there is no kernel to time")
        else:
            result = autotune_projection(batch_size, v_min, v_max, n_atoms,
                                         device=dev)
        _CACHE[key] = result
    result = _CACHE[key]
    log_key = (key, result.selected)
    if log_key not in _LOGGED:
        _LOGGED.add(log_key)
        timed = (f" timings_ms={result.timings_ms}"
                 if result.timings_ms else "")
        print(f"[autotune] projection='{result.selected}' "
              f"({result.reason}){timed}", flush=True)
    return _record("projection", result)


SAMPLER_ARMS = ("scan", "pallas", "host")


def autotune_sampler(capacity: int, k: int, batch_size: int,
                     repeats: int = 3, iters: int = 20,
                     device: str | torch.device | None = None,
                     ) -> AutotuneResult:
    """Time the two device descents (``scan``: the plain torch descent;
    ``pallas``: the CUDA kernel) on ``device`` at [K * B] stratified
    queries over a tree of random positive priorities at ``capacity``
    (rounded up to a power of two); return the faster."""
    from d4pg_tpu_torch.ops.sampler_descent import descend, descend_plain
    from d4pg_tpu_torch.replay import device_per as dper

    dev = resolve_device(device)
    record_build(f"autotune_sampler [{k * batch_size}] over {capacity} on "
                 f"{dev}")
    rng = np.random.default_rng(0)
    trees = dper.init(capacity, dev)
    n = trees.capacity
    trees = dper.set_leaves(
        trees, torch.arange(n, device=dev),
        torch.from_numpy(rng.random(n).astype(np.float32) + 1e-3).to(dev))
    q = k * batch_size
    mass = torch.from_numpy(
        (rng.random(q) * float(trees.sum_tree[1])).astype(np.float32)
    ).to(dev)

    def _time(fn) -> float:
        fn()  # warm-up (the first CUDA call builds the kernels)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, (time.perf_counter() - t0) / iters)
        return best * 1e3

    timings = {
        "scan": round(_time(lambda: descend_plain(trees.sum_tree, mass)), 4),
        "pallas": round(_time(lambda: descend(trees.sum_tree, mass)), 4)}
    best = min(timings, key=timings.get)
    return AutotuneResult(best, "measured fastest descent at "
                          f"[{q}] queries over {n} slots on {dev.type}",
                          timings)


def select_sampler(flag: str, *, capacity: int, k: int, batch_size: int,
                   device: str | torch.device | None = None,
                   ) -> AutotuneResult:
    """Resolve a ``--sampler`` flag to an arm (see the module docstring).
    ``device`` defaults to ``cuda`` and raises without one."""
    if flag != "auto":
        if flag not in SAMPLER_ARMS:
            raise ValueError(f"unknown --sampler arm {flag!r} "
                             f"(want one of {('auto',) + SAMPLER_ARMS})")
        return _record("sampler",
                       AutotuneResult(flag, "explicit --sampler override"))
    dev = resolve_device(device)
    key = ("sampler", int(capacity), int(k), int(batch_size), card_key(dev))
    if key not in _CACHE:
        if dev.type != "cuda":
            result = AutotuneResult(
                "host", f"{dev.type} device: the descent arms would run "
                "their plain versions on the commit thread; the host "
                "dealer is the arm here (force --sampler scan/pallas to "
                "override)")
        else:
            result = autotune_sampler(capacity, k, batch_size, device=dev)
        _CACHE[key] = result
    result = _CACHE[key]
    log_key = (key, result.selected)
    if log_key not in _LOGGED:
        _LOGGED.add(log_key)
        timed = (f" timings_ms={result.timings_ms}"
                 if result.timings_ms else "")
        print(f"[autotune] sampler='{result.selected}' "
              f"({result.reason}){timed}", flush=True)
    return _record("sampler", result)
