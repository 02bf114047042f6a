"""Unified metrics registry: one process-wide home for named counters,
gauges, histograms and consistent-snapshot providers.

Counterpart of ``d4pg_tpu/obs/registry.py``. Consistency contract:
every counter is read under the lock that writes it.

- *Direct metrics* (``Counter``/``Gauge``/``Histogram``) each own one
  plain lock (``_mu``); ``inc``/``set``/``observe`` and the export-time
  read both take it, so a metric's value is never torn.
- *Snapshot providers*: a component whose counters live under its own
  locks registers a callable that produces its consistent snapshot;
  ``export()`` calls it with no registry lock held, so the provider takes
  exactly the locks it always takes (``ReplayService.ingest_stats`` is
  the ``ingest`` provider).

Providers are held by weak reference (``WeakMethod`` for bound methods):
a dead provider drops out of ``export()`` instead of leaking its owner.

Lock discipline (see ``obs/__init__``): ``_mu`` locks are terminal, no
path holding one acquires any other lock, so ``export()`` copies the
provider list under ``_mu`` and calls the providers after releasing it.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque


class Counter:
    """Monotonic named counter. ``inc`` is one lock round trip, cheap
    enough per frame or per block; row paths ``inc(n)`` once per block."""

    __slots__ = ("name", "_mu", "_v")

    def __init__(self, name: str):
        self.name = name
        self._mu = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self._v += n

    @property
    def value(self) -> int:
        with self._mu:
            return self._v

    def reset(self) -> None:
        with self._mu:
            self._v = 0


class Gauge:
    """Last-write-wins named value."""

    __slots__ = ("name", "_mu", "_v")

    def __init__(self, name: str):
        self.name = name
        self._mu = threading.Lock()
        self._v: float | None = None

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)

    @property
    def value(self) -> float | None:
        with self._mu:
            return self._v

    def reset(self) -> None:
        with self._mu:
            self._v = None


class Histogram:
    """Bounded-reservoir histogram: the newest ``maxlen`` observations
    plus lifetime count and sum; p50/p95/p99 over the reservoir at
    snapshot time (so memory stays flat and the percentiles describe the
    recent window)."""

    __slots__ = ("name", "_mu", "_window", "_count", "_sum")

    def __init__(self, name: str, maxlen: int = 4096):
        self.name = name
        self._mu = threading.Lock()
        self._window: deque = deque(maxlen=maxlen)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._mu:
            self._window.append(float(v))
            self._count += 1
            self._sum += float(v)

    def reset(self) -> None:
        with self._mu:
            self._window.clear()
            self._count = 0
            self._sum = 0.0

    def snapshot_dict(self) -> dict:
        with self._mu:
            window = list(self._window)
            count, total = self._count, self._sum
        return percentile_summary(window, count=count, total=total)


def percentile_summary(values: list[float], count: int | None = None,
                       total: float | None = None) -> dict:
    """p50/p95/p99/mean/n over ``values`` (stdlib only: the obs plane
    imports neither numpy nor torch)."""
    n = len(values)
    if n == 0:
        return {"p50": None, "p95": None, "p99": None, "mean": None,
                "n": 0, "count": count or 0}
    ordered = sorted(values)

    def pct(q: float) -> float:
        # linear interpolation on the sorted reservoir (np.percentile's
        # default convention)
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(n - 1, lo + 1)
        frac = pos - lo
        return round(ordered[lo] * (1 - frac) + ordered[hi] * frac, 6)

    mean = (total / count) if (total is not None and count) \
        else sum(values) / n
    return {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99),
            "mean": round(mean, 6), "n": n,
            "count": count if count is not None else n}


class MetricsRegistry:
    """The process-wide metric namespace. ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent by name);
    ``register_provider`` attaches a consistent-snapshot callable."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        # name -> weak callable (WeakMethod for bound methods)
        self._providers: dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        with self._mu:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._mu:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, maxlen: int = 4096) -> Histogram:
        with self._mu:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, maxlen)
            return h

    def register_provider(self, name: str, fn) -> None:
        """Attach a consistent-snapshot callable under ``name``
        (re-registering replaces: last wins). Bound methods are held
        weakly."""
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        with self._mu:
            self._providers[name] = ref

    def unregister_provider(self, name: str, fn=None) -> None:
        """Drop the provider slot. With ``fn`` given, only when the slot
        still points at ``fn``: a closing component must not evict a newer
        one that took over its name."""
        with self._mu:
            if fn is not None:
                ref = self._providers.get(name)
                if ref is None:
                    return
                cur = ref()
                if cur is not None and cur != fn:
                    return
            self._providers.pop(name, None)

    def export(self) -> dict:
        """One snapshot of everything: each direct metric read under its
        own lock, each provider run under its owner's locks (with no
        registry lock held)."""
        with self._mu:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
            providers = list(self._providers.items())
        out: dict = {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges
                       if g.value is not None},
            "histograms": {h.name: h.snapshot_dict() for h in histograms},
        }
        dead = []
        for name, ref in providers:
            fn = ref()
            if fn is None:
                dead.append(name)
                continue
            try:
                out[name] = fn()
            except Exception as e:  # a crashed provider must not kill export
                out[name] = {"provider_error": f"{type(e).__name__}: {e}"}
        if dead:
            with self._mu:
                for name in dead:
                    # only drop if nobody re-registered the slot meanwhile
                    if self._providers.get(name) is not None \
                            and self._providers[name]() is None:
                        self._providers.pop(name, None)
        return out

    def reset_metrics(self) -> None:
        """Zero every direct metric (providers are their owners'
        business)."""
        with self._mu:
            metrics = (list(self._counters.values())
                       + list(self._gauges.values())
                       + list(self._histograms.values()))
        for m in metrics:
            m.reset()


# THE process-wide registry; tests that need isolation build their own
REGISTRY = MetricsRegistry()
