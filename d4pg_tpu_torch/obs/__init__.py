"""Observability plane: the unified metrics registry, the flight
recorder, thread-crash containment, wire-to-grad trace spans and the
random-draw ledger.

Counterpart of ``d4pg_tpu/obs``. Five stdlib-only modules (nothing here
imports torch or numpy, so the locking and transport layers can import
them first):

- ``obs.registry``: one process-wide registry of named counters, gauges
  and histograms plus snapshot providers (callables that produce a
  consistent dict under their own locks);
- ``obs.flight``: a bounded ring of recent structured events, dumped as a
  JSON postmortem;
- ``obs.containment``: the one-call breadcrumb every long-lived thread's
  top frame leaves when it dies (a counter and a flight event);
- ``obs.trace``: sampled per-frame trace spans from an actor's send to the
  grad step that consumes the rows;
- ``obs.draw_ledger``: per-stream random-draw counts behind a counting
  Generator proxy, with a canonical digest.

Lock discipline: every lock here is a plain ``threading.Lock`` named
``_mu``, outside the tiered hierarchy and terminal: no path holding one
acquires another lock, so the plane can be called from under any tiered
lock.
"""

from d4pg_tpu_torch.obs import containment, draw_ledger, flight, registry, trace
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.draw_ledger import LEDGER, DrawLedger
from d4pg_tpu_torch.obs.flight import FlightRecorder, record_event
from d4pg_tpu_torch.obs.registry import (
    REGISTRY,
    MetricsRegistry,
    percentile_summary,
)
from d4pg_tpu_torch.obs.trace import DEFAULT_SAMPLE, TraceRecorder

__all__ = [
    "containment", "draw_ledger", "flight", "registry", "trace",
    "FlightRecorder", "record_event", "contained_crash",
    "REGISTRY", "MetricsRegistry", "percentile_summary",
    "DEFAULT_SAMPLE", "TraceRecorder",
    "LEDGER", "DrawLedger",
]
