"""Top-frame crash containment for long-lived thread roles.

Counterpart of ``d4pg_tpu/obs/containment.py``. The top frame of each
long-lived thread (the replay service's ingest worker and commit loop,
the background evaluator) wraps its body in a broad handler that calls
:func:`contained_crash`: the thread dies, but the death is counted (the
``threads.contained_crashes`` registry counter) and flight-recorded (a
``thread_crash_contained`` event with the role and the exception), so a
dead plane shows in the next metrics snapshot instead of as a stall.
"""

from __future__ import annotations

from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.registry import REGISTRY


def contained_crash(role: str, exc: BaseException) -> None:
    """Count and flight-record a thread-top-frame crash for ``role``."""
    REGISTRY.counter("threads.contained_crashes").inc()
    record_event("thread_crash_contained", role=role,
                 error=f"{type(exc).__name__}: {exc}")
