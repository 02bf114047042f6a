#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; the first call builds the kernels from
``d4pg_tpu_torch/ops/csrc`` into ``d4pg_tpu_torch/ops/_build``.

Phases (any failure raises and exits non-zero; nothing is caught):

  1. the card's name and power limit (nvidia-smi) and torch's CUDA version;
  2. build the CUDA kernels;
  3. projection kernel vs its plain version (max abs error <= 1e-5, rows
     sum to 1): B = 256 and ragged B = 100, A = 51 on [0, 800], rewards
     past both ends of the support, ~30% terminal rows; plus the
     terminal-delta case;
  4. descent kernel vs its plain version, bitwise: cap = 262,144,
     Q = 256 and Q = 40 * 256, leaves with zero runs, masses equal to
     left-subtree sums, and the all-zero tree;
  5. device time of each kernel, its plain version and, where one torch
     call computes the same function, that call (CUDA events, warmed up);
     each kernel's bound from bytes and operations, and the descent's
     latency floor from a one-query descent (18 dependent L2 loads);
  6. the fused chunk on the card vs the same chunk on the CPU (plain
     versions), at full width on a small ring with injected uniforms;
  7. the slice: ``FusedDeviceReplay(200_000, 376, 17)`` filled in
     4,096-row blocks, ``init_state`` on cuda, ``make_fused_chunk(k=40,
     batch_size=256, projection="pallas")``; one warm-up chunk, then timed
     chunks with the launch counters set to 0 just before and read just
     after (each kernel must launch exactly K times per chunk); then the
     step's breakdown: host queueing time, and device time by kernel from
     one profiled chunk;
  8. a ``kernels`` JSON line, then the result line.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent

# the slice's shape: Humanoid-v4 at the repo's north-star learner config
OBS, ACT, HIDDEN, ATOMS = 376, 17, (256, 256, 256), 51
V_MIN, V_MAX = 0.0, 800.0
BATCH, CAPACITY, K, FILL_BLOCK = 256, 200_000, 40, 4096
TIMED_CHUNKS = 10
CAP = 262_144  # next_pow2(CAPACITY): the sum tree's leaf count
LEVELS = 18  # log2(CAP): dependent loads per descent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(fn, calls: int, windows: int = 10,
              warmup: int = 5) -> tuple[float, float]:
    """(device ms per call, host enqueue ms per call). Each window queues
    ``calls`` calls behind a sleep kernel, so the CUDA events around them
    bracket device work alone; the median over windows is kept. ``calls``
    keeps a window's launches well inside the device's launch queue (once
    it fills, the host waits for the device). A window whose start event
    was no longer pending when the last call was queued (the host stalled
    past the sleep) is discarded and queued again behind a sleep twice as
    long; after three such windows in a row the measurement fails."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_s = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    sleep_cycles = int((4 * enqueue_s * calls + 2e-3) * 2e9)
    times, stalls = [], 0
    while len(times) < windows:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles << stalls)
        start.record()
        for _ in range(calls):
            fn()
        pending = not start.query()
        end.record()
        end.synchronize()
        if not pending:
            stalls += 1
            check(stalls < 3, "timing window: device idle while queueing, "
                  "three windows in a row")
            continue
        stalls = 0
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times)), enqueue_s * 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def projection_inputs(gen, batch, atoms, v_min, v_max, dev):
    p = torch.rand(batch, atoms, generator=gen, device=dev)
    p = (p / p.sum(-1, keepdim=True)).contiguous()
    span = v_max - v_min
    r = (v_min - 0.2 * span) + 1.4 * span * torch.rand(
        batch, generator=gen, device=dev)
    done = torch.rand(batch, generator=gen, device=dev) < 0.3
    d = torch.where(done, 0.0, 0.99 ** 3).to(torch.float32)
    return p, r, d


def phase_projection(dev) -> dict:
    from d4pg_tpu_torch.core.distribution import CategoricalSupport
    from d4pg_tpu_torch.ops import projection as proj

    gen = torch.Generator(device=dev).manual_seed(1)
    sup = CategoricalSupport(V_MIN, V_MAX, ATOMS)
    worst = 0.0
    for batch in (BATCH, 100):
        args = projection_inputs(gen, batch, ATOMS, V_MIN, V_MAX, dev)
        got = proj.projection(sup, *args)
        want = proj.projection_plain(sup, *args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rows = (got.sum(-1) - 1.0).abs().max().item()
        print(f"projection B={batch}: max abs err {err:.3e}, "
              f"max |row sum - 1| {rows:.3e}")
        check(err <= 1e-5 and rows <= 1e-5, f"projection B={batch}")
        worst = max(worst, err)
    # terminal rows collapse to a delta at clip(r)
    sup11 = CategoricalSupport(0.0, 10.0, 11)
    p = torch.rand(8, 11, generator=gen, device=dev)
    p = p / p.sum(-1, keepdim=True)
    got = proj.projection(sup11, p, torch.full((8,), 5.0, device=dev),
                          torch.zeros(8, device=dev))
    want = torch.zeros(8, 11, device=dev)
    want[:, 5] = 1.0
    check((got - want).abs().max().item() <= 1e-6, "projection delta")

    args = projection_inputs(gen, BATCH, ATOMS, V_MIN, V_MAX, dev)
    ms, enq = device_ms(lambda: proj.projection(sup, *args), calls=100)
    # ~12 launches per call of the plain version
    plain_ms, _ = device_ms(lambda: proj.projection_plain(sup, *args),
                            calls=20)
    n_bytes = 4 * (2 * BATCH * ATOMS + 2 * BATCH)
    # what the function needs, not what the gather-form kernel does: per
    # source atom the Bellman map and clip (3), the bin position (2), the
    # floor/ceil split (3) and two multiply-adds into its two bins (2)
    n_ops = 10 * BATCH * ATOMS
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"name": "projection", "route": "cuda",
            "source": "d4pg_tpu_torch/ops/csrc/projection.cu",
            "replaces": "d4pg_tpu/ops/projection.py:87",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "enqueue_ms": enq}


def _tree_with_zero_runs(dev, gen):
    from d4pg_tpu_torch.replay import device_per as dper

    leaves = torch.rand(CAP, generator=gen, device=dev)
    # zero runs: blocks of 64 leaves zeroed at random, plus single zeros
    blocks = torch.rand(CAP // 64, generator=gen, device=dev) < 0.2
    leaves = torch.where(blocks.repeat_interleave(64), 0.0, leaves)
    leaves = torch.where(torch.rand(CAP, generator=gen, device=dev) < 0.1,
                         0.0, leaves)
    trees = dper.set_leaves(dper.init(CAP, dev),
                            torch.arange(CAP, device=dev), leaves)
    return trees.sum_tree, leaves


def _left_sum_masses(tree):
    """Masses equal to a left-subtree sum: along the all-left path
    (prefix 0) the mass tree[2^k] ties node 2^(k-1) exactly; the root's
    left sum plus each node on the path of its right child adds more."""
    levels = int(math.log2(tree.shape[0] // 2))
    firsts = torch.stack([tree[2 ** k] for k in range(1, levels + 1)])
    rights = torch.stack([tree[2] + tree[3 * 2 ** k]
                          for k in range(1, levels)])
    return torch.cat([firsts, rights]).contiguous()


def phase_descent(dev) -> dict:
    from d4pg_tpu_torch.ops import sampler_descent as desc

    gen = torch.Generator(device=dev).manual_seed(2)
    tree, leaves = _tree_with_zero_runs(dev, gen)
    total = tree[1]
    cases = {
        "Q=256": torch.rand(BATCH, generator=gen, device=dev) * total,
        "Q=40*256": torch.rand(K * BATCH, generator=gen, device=dev) * total,
        "left sums": _left_sum_masses(tree),
    }
    cases = [(name, tree, mass) for name, mass in cases.items()]
    cases.append(("all-zero tree", torch.zeros(2 * CAP, device=dev),
                  torch.zeros(5, device=dev)))
    worst = 0
    for name, t, mass in cases:
        got, want = desc.descend(t, mass), desc.descend_plain(t, mass)
        torch.cuda.synchronize()
        worst = max(worst, (got.long() - want.long()).abs().max().item())
        check(torch.equal(got, want), f"descent {name} bitwise")
        print(f"descent {name}: bitwise equal ({mass.numel()} queries)")

    mass = cases[0][2]
    ms, enq = device_ms(lambda: desc.descend(tree, mass), calls=100)
    # ~130 launches per call of the plain version (18 levels)
    plain_ms, _ = device_ms(lambda: desc.descend_plain(tree, mass), calls=2)
    cumsum = torch.cumsum(leaves, 0)
    library_ms, _ = device_ms(
        lambda: torch.searchsorted(cumsum, mass, right=True), calls=100)
    # bytes this run's queries need: every distinct tree node read on the
    # way down, the masses in and the slots out
    node = torch.ones(BATCH, dtype=torch.int64, device=dev)
    p, seen = mass.clone(), []
    for _ in range(LEVELS):
        left = node << 1
        seen.append(left)
        go = p >= tree[left]
        p = torch.where(go, p - tree[left], p)
        node = torch.where(go, left | 1, left)
    nodes = torch.unique(torch.cat(seen)).numel()
    n_bytes = 4 * nodes + 4 * BATCH + 4 * BATCH
    n_ops = 2 * BATCH * LEVELS  # compare + subtract per level
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    # latency floor: every query is a chain of 18 dependent loads. Time a
    # one-query descent of the warm tree (a fresh mass each call) and a
    # zero-level launch (a 2-node tree); the difference is one chain of
    # 18 dependent loads served from L2 (the whole 2 MB tree is read into
    # the 50 MB L2 first), the launch cost cancelled.
    one = torch.rand(1000, 1, generator=gen, device=dev) * total
    tree.sum()
    pick = itertools.count()
    chain_ms, _ = device_ms(
        lambda: desc.descend(tree, one[next(pick) % 1000]), calls=100)
    stub = torch.zeros(2, device=dev)
    stub_ms, _ = device_ms(lambda: desc.descend(stub, one[0]), calls=100)
    latency_ms = chain_ms - stub_ms
    print(f"descent chain: one query {chain_ms * 1e3:.3f} us, zero levels "
          f"{stub_ms * 1e3:.3f} us -> {latency_ms * 1e6 / LEVELS:.1f} ns "
          f"per dependent load")
    return {"name": "descent", "route": "cuda",
            "source": "d4pg_tpu_torch/ops/csrc/sampler_descent.cu",
            "replaces": "d4pg_tpu/ops/sampler_descent.py:96",
            "max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "latency_bound_ms": latency_ms,
            "load_latency_ns": latency_ms * 1e6 / LEVELS,
            "enqueue_ms": enq, "distinct_nodes": nodes}


def random_rows(rng, n):
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    return TransitionBatch(
        obs=rng.standard_normal((n, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, OBS)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32),
    )


def config():
    from d4pg_tpu_torch.learner.state import D4PGConfig

    return D4PGConfig(obs_dim=OBS, act_dim=ACT, v_min=V_MIN, v_max=V_MAX,
                      n_atoms=ATOMS, hidden=HIDDEN, projection="pallas")


def phase_reference(dev) -> None:
    """The fused chunk with the kernels on the card against the same chunk
    with the plain versions on the CPU: same weights, ring and uniforms.
    Slots must agree exactly; losses and TD errors within rtol 1e-4
    (float32 products summed in another order, over 3 Adam steps)."""
    from d4pg_tpu_torch.learner.fused import make_fused_chunk
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    k, cap = 3, 2048
    rng = np.random.default_rng(3)
    rows = random_rows(rng, cap)
    u = torch.from_numpy(rng.random((k, BATCH)).astype(np.float32))
    out = {}
    for where in ("cpu", dev):
        buf = FusedDeviceReplay(cap, OBS, ACT, device=where, block_rows=512)
        buf.add(rows)
        buf.drain()
        state = init_state(config(), seed=0, device=where)
        fn = make_fused_chunk(config(), k=k, batch_size=BATCH)
        trees, m = fn(state, buf.trees, buf.storage, buf.size,
                      u=u.to(where))
        out[str(where)] = {n: v.cpu() for n, v in m.items()}
        out[str(where)]["root"] = trees.sum_tree[1].cpu()
    cpu, gpu = out["cpu"], out[str(dev)]
    check(torch.equal(cpu["idx"], gpu["idx"]), "chunk slots, card vs CPU")
    for name in ("critic_loss", "actor_loss", "td_error", "root"):
        err = ((gpu[name] - cpu[name]).abs()
               / cpu[name].abs().clamp_min(1e-30)).max().item()
        print(f"chunk card vs CPU {name}: max rel err {err:.3e}")
        check(err <= 1e-4, f"chunk {name} card vs CPU")


def phase_slice(dev) -> dict:
    from d4pg_tpu_torch.learner.fused import make_fused_chunk
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.ops.projection import projection
    from d4pg_tpu_torch.ops.sampler_descent import descend
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    t0 = time.perf_counter()
    buf = FusedDeviceReplay(CAPACITY, OBS, ACT, alpha=0.6, device=dev)
    rng = np.random.default_rng(0)
    for _ in range(CAPACITY // FILL_BLOCK):
        buf.add(random_rows(rng, FILL_BLOCK))
        buf.drain()
    torch.cuda.synchronize()
    print(f"ring filled: {buf.size} rows in {time.perf_counter() - t0:.2f} s")
    leaves = buf.trees.sum_tree[CAP:].double().sum().item()
    check(abs(buf.trees.sum_tree[1].item() - leaves) <= 1e-4 * leaves,
          "tree root == sum of leaves after fill")

    state = init_state(config(), seed=0, device=dev)
    fn = make_fused_chunk(config(), k=K, batch_size=BATCH,
                          projection="pallas")
    gen = torch.Generator(device=dev).manual_seed(0)

    def chunk():
        nonlocal metrics
        buf.trees, metrics = fn(state, buf.trees, buf.storage, buf.size,
                                generator=gen)

    def run(chunks):
        projection.launches = descend.launches = 0
        for _ in range(chunks):
            chunk()
        torch.cuda.synchronize()
        return {"projection": projection.launches,
                "descent": descend.launches}

    metrics = None
    t0 = time.perf_counter()
    warm = run(1)
    print(f"warm-up chunk: {time.perf_counter() - t0:.3f} s, launches {warm}")
    check(warm == {"projection": K, "descent": K}, "warm-up launches == K")
    t0 = time.perf_counter()
    launches = run(TIMED_CHUNKS)
    dt = time.perf_counter() - t0
    check(launches == {"projection": K * TIMED_CHUNKS,
                       "descent": K * TIMED_CHUNKS},
          f"launches == K per chunk: {launches}")
    for name in ("critic_loss", "actor_loss", "td_error"):
        check(bool(torch.isfinite(metrics[name]).all()), f"finite {name}")
    check(tuple(metrics["td_error"].shape) == (K, BATCH), "td_error shape")
    idx = metrics["idx"]
    check(bool(((idx >= 0) & (idx < buf.size)).all()), "slots in range")
    leaves = buf.trees.sum_tree[CAP:].double().sum().item()
    check(abs(buf.trees.sum_tree[1].item() - leaves) <= 1e-4 * leaves,
          "tree root == sum of leaves after chunks")
    steps_per_s = K * TIMED_CHUNKS / dt
    print(f"slice: {K * TIMED_CHUNKS} grad steps in {dt:.3f} s = "
          f"{steps_per_s:.1f} grad-steps/s (K={K}, B={BATCH}, "
          f"step {state.step}, critic_loss "
          f"{metrics['critic_loss'][-1].item():.4f})")
    # where a step's time goes: the host's time to queue one chunk, and
    # the device's kernel time in one chunk from the profiler's device
    # events, both against the unprofiled wall clock per step
    wall_ms = 1e3 * dt / (K * TIMED_CHUNKS)
    t0 = time.perf_counter()
    for _ in range(3):
        chunk()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / (3 * K)
    torch.cuda.synchronize()
    print(f"per grad step: wall {wall_ms:.3f} ms, host enqueue "
          f"{enqueue_ms:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if not e.is_user_annotation]
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in on_device)
    if not device_us:
        print("per grad step: device time not measured (the profiler "
              "recorded no device events)")
    else:
        print(f"per grad step (profiled chunk): device busy "
              f"{device_us / 1e3 / K:.3f} ms (share of unprofiled wall "
              f"{device_us / 1e3 / K / wall_ms:.3f}), "
              f"{sum(e.count for e in on_device) / K:.1f} kernels")
        for e in sorted(on_device,
                        key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  device {e.self_device_time_total / K:9.2f} us/step "
                  f"{e.count / K:7.2f} launches/step  {e.key[:80]}")
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  host {e.self_cpu_time_total / K:9.2f} us/step "
              f"{e.count / K:7.2f} calls/step  {e.key[:80]}")
    return {"grad_steps_per_s": steps_per_s, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from d4pg_tpu_torch.ops.kernels import library

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    lib = library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    kernels = [phase_projection(dev), phase_descent(dev)]
    phase_reference(dev)
    result = phase_slice(dev)
    for kern in kernels:
        kern["launches"] = result["launches"][kern["name"]]
    print(f"grad_steps_per_s {result['grad_steps_per_s']:.1f} on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
