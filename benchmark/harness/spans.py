"""The program's own spans, read in the run's process after its traced
slice (``d4pg_tpu_torch/io/profiling.spans``).

Only the profiler turns the program's spans on, so the table holds the
traced slice's spans and nothing of set-up, the checked steps or the
window. ``summary()`` is ``None`` where there is nothing to read: a
program without spans, a slice whose steps ran in other processes (the
ranks of a mesh cell), or one that recorded no ``learner.step``.
"""

from __future__ import annotations


def summary() -> dict | None:
    try:
        from d4pg_tpu_torch.io import profiling
    except ImportError:
        return None
    table = getattr(profiling, "spans", None)
    if table is None:
        return None
    s = table.summary()
    return s if s.get("steps") else None


def device_ms_per_step(names: tuple[str, ...]) -> float | None:
    """The event-pair milliseconds of the spans ``names`` per grad step:
    the time the device spent between each span's two events, idle
    included where the host lagged behind it. ``None`` unless every name
    took events."""
    s = summary()
    if s is None:
        return None
    ms = [s["spans"].get(n, {}).get("device_ms") for n in names]
    if any(m is None for m in ms):
        return None
    return sum(ms) / s["steps"]
