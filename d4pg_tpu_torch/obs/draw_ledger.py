"""DrawLedger: per-stream random-draw counts and their digest.

Counterpart of ``d4pg_tpu/obs/draw_ledger.py``. It wraps component
Generators in a counting proxy (or takes explicit ``count()`` calls),
adds up draw calls per named stream, and exports a canonical sha256
digest over the sorted ``stream=count`` table. Two runs that claim equal
seeded load must give the same digest for their ``schedule.*`` streams
(drawn up front while building seeded schedules, so comparable across
runs); every other stream is paced by the run and only counted.

Counting unit: one draw-method call, not array elements. Stdlib only
(the proxy duck-types the Generator), and the one lock is a terminal
``_mu``, so ``count()`` is safe under any tiered lock.
"""

from __future__ import annotations

import hashlib
import threading

SCHEDULE_PREFIX = "schedule."

# the Generator draw surface the proxy counts (the modern Generator plus
# the legacy RandomState spellings); every other attribute passes through
_DRAW_METHODS = frozenset({
    "beta", "binomial", "bytes", "chisquare", "choice", "dirichlet",
    "exponential", "gamma", "geometric", "gumbel", "hypergeometric",
    "integers", "laplace", "logistic", "lognormal", "logseries",
    "multinomial", "multivariate_normal", "negative_binomial",
    "noncentral_chisquare", "normal", "pareto", "permutation",
    "permuted", "poisson", "power", "random", "rayleigh", "shuffle",
    "standard_cauchy", "standard_exponential", "standard_gamma",
    "standard_normal", "standard_t", "triangular", "uniform",
    "vonmises", "wald", "weibull", "zipf",
    "rand", "randn", "randint", "random_sample",
})


class _CountedStream:
    """Proxy over a Generator: draw methods count one call into the
    ledger, then delegate. Bound methods are not cached, so the ledger's
    armed state is read on every call."""

    __slots__ = ("_ledger", "_stream", "_rng")

    def __init__(self, ledger: "DrawLedger", stream: str, rng) -> None:
        self._ledger = ledger
        self._stream = stream
        self._rng = rng

    def __getattr__(self, name: str):
        attr = getattr(self._rng, name)
        if name in _DRAW_METHODS and callable(attr):
            ledger, stream = self._ledger, self._stream

            def counted(*args, **kwargs):
                ledger.count(stream)
                return attr(*args, **kwargs)
            return counted
        return attr


class DrawLedger:
    """Per-stream draw-call counts and their canonical digest. Instances
    start armed; the process-wide ``LEDGER`` starts disarmed, so wrapped
    streams cost one attribute lookup and a bool check per draw until a
    harness arms it."""

    def __init__(self, armed: bool = True) -> None:
        self._mu = threading.Lock()  # terminal: guards _counts only
        self._armed = bool(armed)
        self._counts: dict[str, int] = {}

    def arm(self) -> None:
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    def reset(self, armed: bool | None = None) -> None:
        with self._mu:
            self._counts.clear()
        if armed is not None:
            self._armed = bool(armed)

    def count(self, stream: str, n: int = 1) -> None:
        """Record ``n`` draw calls against ``stream``; a no-op (no lock)
        unless armed."""
        if not self._armed:
            return
        with self._mu:
            self._counts[stream] = self._counts.get(stream, 0) + int(n)

    def wrap(self, stream: str, rng):
        """Wrap a Generator so its draw calls count against ``stream``."""
        return _CountedStream(self, stream, rng)

    def counts(self) -> dict[str, int]:
        with self._mu:
            return dict(self._counts)

    def digest(self, prefix: str = "") -> str:
        """sha256 over the sorted ``stream=count`` lines of the streams
        whose names start with ``prefix``: equal histories hash equal
        whatever their arrival order."""
        snap = self.counts()
        h = hashlib.sha256()
        for name in sorted(snap):
            if name.startswith(prefix):
                h.update(f"{name}={snap[name]}\n".encode("ascii"))
        return h.hexdigest()

    def export(self) -> dict:
        """Per-stream counts, the all-streams digest and the
        schedule-namespace digest."""
        snap = self.counts()
        return {
            "streams": dict(sorted(snap.items())),
            "total_draws": sum(snap.values()),
            "digest": self.digest(),
            "schedule_digest": self.digest(SCHEDULE_PREFIX),
        }


# the process-wide ledger (disarmed until a harness arms it)
LEDGER = DrawLedger(armed=False)
