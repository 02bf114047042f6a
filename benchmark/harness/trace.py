"""A traced slice of chunks, read from ``torch.profiler``'s events.

``traced(run)`` profiles ``run()`` (which queues whole chunks) and the
synchronize that closes it, inside one ``bench.window`` range, and reads:

  - ``window_s``: the range's length;
  - ``busy_s``: the union of the device's activity intervals (kernels,
    copies, sets) within the range;
  - ``launches``: the host's CUDA API calls that put work on a stream
    (kernel and graph launches, asynchronous copies and sets);
  - ``device_s``: device seconds by kernel or activity name;
  - ``gaps``: the device's idle seconds within the range, by what the
    host was running when each gap began (the innermost operator on the
    launching thread, else ``python``).
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

# host-side CUDA API calls that put work on a stream (runtime and driver
# API names; the driver API's carry suffixes such as _v2 or _ptsz)
LAUNCH_PREFIXES = (
    "cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
    "cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemsetAsync",
    "cudaMemset2DAsync", "cuLaunchKernel", "cuLaunchCooperativeKernel",
    "cuGraphLaunch", "cuMemcpyAsync", "cuMemcpyHtoDAsync",
    "cuMemcpyDtoHAsync", "cuMemcpyDtoDAsync", "cuMemsetD8Async",
    "cuMemsetD16Async", "cuMemsetD32Async")
WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    device_events: int
    device_s: dict
    gaps: dict
    wall_s: float  # host clock around the traced slice


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES)


def read(events) -> Trace:
    """A ``Trace`` from kineto events (``prof.profiler.kineto_results
    .events()``). Ranges (``record_function``, the optimizer's step) are
    annotations, not device work, on either timeline."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == WINDOW
           and e.device_type() != cuda]
    # ranges opened on the host (this window, the optimizer's step) have
    # twins on the device's timeline
    ranges = {e.name() for e in events
              if e.device_type() != cuda and e.is_user_annotation()}
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    thread = win[0].start_thread_id()
    dev, ops, launches = [], [], 0
    device_s: dict[str, float] = {}
    for e in events:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if e.is_user_annotation() or name in ranges:
            continue
        if e.device_type() == cuda:
            if s + d <= w0 or s >= w1:
                continue
            dev.append((max(s, w0), min(s + d, w1)))
            device_s[name] = device_s.get(name, 0.0) + d * 1e-9
        elif w0 <= s <= w1:
            if _is_launch(name):
                launches += 1
            elif not name.startswith("cu") and e.start_thread_id() == thread:
                ops.append((s, s + d, name))
    busy = _merge(dev)
    busy_ns = sum(e - s for s, e in busy)
    ops.sort()
    starts = [o[0] for o in ops]
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        label = "python"
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - 256, -1), -1):
            if ops[j][1] >= g0:
                label = ops[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                 launches=launches, device_events=len(dev),
                 device_s=device_s, gaps=gaps, wall_s=0.0)


def traced(run, device) -> Trace:
    """Profile ``run()`` and the closing synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    tr = read(prof.profiler.kineto_results.events())
    tr.wall_s = wall
    return tr


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
