"""Wire-to-grad trace spans: where does a frame's time go?

Counterpart of ``d4pg_tpu/obs/trace.py``. A sender samples frames at
``trace_sample`` and stamps each sampled frame with a trace id and a
birth time; the receiver records a span timestamp at each stage the
frame passes:

    send -> admission -> decode -> stage -> merge -> commit -> grad
                 |          |                 |
                 +-- shed --+------ shed -----+   (terminal: counted)

``grad`` is the first learner consumption after commit: the learner
marks it right after each chunk it queues (``FusedLoop.run``,
``ChunkPipeline.run``). Queue time is the host-side proxy for "a grad
step consumed these rows": the card runs asynchronously and observing
the kernels would cost a synchronization.

Only frames that carry a trace id open a trace. In-process adds carry
none, so until the wire codec is ported (ROADMAP Queue 1 item 12) an
enabled recorder opens no trace, ``mark_grad`` stamps nothing, and the
driver's ``wire_to_grad_p95_ms`` stays absent, as in the reference's
in-process run.

Clock: ``time.monotonic()`` throughout. Cost: a span is one terminal
lock round trip and one dict store. The recorder is disabled by default;
``enable()`` is the only switch.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque

from d4pg_tpu_torch.obs.registry import percentile_summary

# the default sampling rate of the --trace_sample knobs
DEFAULT_SAMPLE = 0.02

# pipeline stages in order; ``shed`` is the failure terminal; ``deal`` is
# the sample-on-ingest plane's post-commit stage
STAGES = ("send", "admission", "decode", "stage", "merge", "commit", "deal",
          "grad")
TERMINALS = ("commit", "grad", "shed")

# the stage pairs the latency block reports (label, from, to)
_PAIRS = (
    ("wire_to_admission", "send", "admission"),
    ("admission_to_decode", "admission", "decode"),
    ("decode_to_stage", "decode", "stage"),
    ("stage_to_merge", "stage", "merge"),
    ("merge_to_commit", "merge", "commit"),
    ("commit_to_deal", "commit", "deal"),
    ("deal_to_grad", "deal", "grad"),
    ("commit_to_grad", "commit", "grad"),
    ("wire_to_commit", "send", "commit"),
    ("wire_to_grad", "send", "grad"),
)

_tid_counter = itertools.count(1)  # next() is atomic under the GIL


def new_trace_id(salt: int = 0) -> int:
    """Process-unique u64 trace id; ``salt`` (an actor index, say)
    separates the ids of sender processes that share a receiver."""
    return ((salt & 0xFFFF) << 48) | (next(_tid_counter) & 0xFFFFFFFFFFFF)


class TraceRecorder:
    """Receiver-side span table, keyed by trace id.

    Bounded: at most ``max_traces`` live records; past the bound new
    traces are dropped and counted (``overflow``). All mutation under one
    terminal lock (``_mu``)."""

    def __init__(self, max_traces: int = 8192):
        self._mu = threading.Lock()
        self.max_traces = int(max_traces)
        self._spans: OrderedDict[int, dict] = OrderedDict()
        self._await_grad: deque = deque()
        self.enabled = False
        self.sample_rate = 0.0
        self.overflow = 0

    def enable(self, sample_rate: float = DEFAULT_SAMPLE) -> None:
        with self._mu:
            self.enabled = True
            self.sample_rate = float(sample_rate)

    def disable(self) -> None:
        with self._mu:
            self.enabled = False

    def reset(self) -> None:
        with self._mu:
            self._spans.clear()
            self._await_grad.clear()
            self.overflow = 0

    def begin(self, tid: int, birth_ts: float) -> None:
        """Open a trace at admission with the sender's birth stamp."""
        if not self.enabled:
            return
        with self._mu:
            if tid in self._spans:
                return
            if len(self._spans) >= self.max_traces:
                # evict the oldest completed record; if none, drop the new
                # trace (live records must keep accumulating spans)
                evicted = False
                for old_tid, spans in self._spans.items():
                    if any(t in spans for t in TERMINALS):
                        del self._spans[old_tid]
                        evicted = True
                        break
                if not evicted:
                    self.overflow += 1
                    return
            self._spans[tid] = {"send": float(birth_ts)}

    def record_span(self, tid: int, stage: str, ts: float | None = None
                    ) -> None:
        if not self.enabled:
            return
        t = time.monotonic() if ts is None else ts
        with self._mu:
            spans = self._spans.get(tid)
            if spans is not None and stage not in spans:
                spans[stage] = t

    def terminal_shed(self, tid: int) -> None:
        """Terminal span for a frame that left the pipeline early; opens
        the record if admission never stamped it."""
        if not self.enabled:
            return
        t = time.monotonic()
        with self._mu:
            spans = self._spans.get(tid)
            if spans is None:
                if len(self._spans) >= self.max_traces:
                    self.overflow += 1
                    return
                spans = self._spans[tid] = {}
            spans.setdefault("shed", t)

    def mark_committed(self, tids) -> None:
        """Commit spans for a merged group, queued for the next
        grad-consumption mark."""
        if not self.enabled:
            return
        t = time.monotonic()
        with self._mu:
            for tid in tids:
                spans = self._spans.get(tid)
                if spans is not None and "commit" not in spans:
                    spans["commit"] = t
                    self._await_grad.append(tid)

    def mark_grad(self, ts: float | None = None) -> int:
        """Stamp every commit-pending trace with the grad-consumption
        time; returns how many. Called by the learner right after each
        chunk it queues. Near-free when nothing is pending (one unlocked
        emptiness probe, a benign race under the GIL)."""
        if not self._await_grad:
            return 0
        t = time.monotonic() if ts is None else ts
        n = 0
        with self._mu:
            while self._await_grad:
                tid = self._await_grad.popleft()
                spans = self._spans.get(tid)
                if spans is not None and "grad" not in spans:
                    spans["grad"] = t
                    n += 1
        return n

    def span_table(self) -> dict[int, dict]:
        with self._mu:
            return {tid: dict(spans) for tid, spans in self._spans.items()}

    def orphans(self) -> list[int]:
        """Admitted traces with no terminal span (each one a leak in the
        pipeline's accounting)."""
        with self._mu:
            return [tid for tid, spans in self._spans.items()
                    if "admission" in spans
                    and not any(t in spans for t in TERMINALS)]

    def latency_block(self) -> dict:
        """Per-stage latency percentiles (ms), end-to-end wire-to-commit
        and wire-to-grad, the sample rate and the trace accounting
        (completed / shed / orphaned / overflow)."""
        table = self.span_table()
        stages: dict[str, list[float]] = {label: [] for label, _, _ in _PAIRS}
        completed = shed = 0
        for spans in table.values():
            if "shed" in spans:
                shed += 1
            elif "commit" in spans:
                completed += 1
            for label, a, b in _PAIRS:
                # a grad that predates a later re-deal of the same slot is
                # a mispaired span, not a negative latency
                if a in spans and b in spans and spans[b] >= spans[a]:
                    stages[label].append(1e3 * (spans[b] - spans[a]))
        with self._mu:
            rate, overflow = self.sample_rate, self.overflow
        return {
            "unit": "ms",
            "sample_rate": rate,
            "stages": {label: percentile_summary(vals)
                       for label, vals in stages.items()},
            "wire_to_grad": percentile_summary(stages["wire_to_grad"]),
            "n_traces": len(table),
            "completed": completed,
            "shed": shed,
            "orphans": len(self.orphans()),
            "overflow": overflow,
        }


# THE process-wide recorder (one receiver per process)
RECORDER = TraceRecorder()
