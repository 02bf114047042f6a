"""Tiered locks: one declared lock hierarchy, checked at run time.

Counterpart of ``d4pg_tpu/core/locking.py``. ``HIERARCHY`` maps tier
names to integer tiers, outermost first; the rule is monotone tier
descent per thread: a thread may only acquire a lock whose tier is
strictly below every tier it already holds. Sequential acquisition is
always legal; equal-tier nesting is a violation.

Production mode (the default) delegates straight to ``threading`` with no
bookkeeping. ``enable_debug`` arms the sentinels: every acquisition
checks descent and counts contention per lock (acquisitions, contended
acquisitions, wait time, the longest hold, ``Condition.wait`` calls),
aggregated by tier in ``lock_stats``. ``raise_on_violation=False`` is
record mode: a violation is counted and kept (``violation_count``,
``hierarchy_violations``) instead of raised. The fleet harness and every
drill of ``fleet/`` run in record mode and report the count, since a
raise inside a worker thread would read as a deadlock. Either way a
violation is recorded on the flight recorder (``obs.flight``, a
``lock_violation`` event). The ``locks`` registry provider exports the
counters and the tally.
"""

from __future__ import annotations

import contextlib
import threading
import time

from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.registry import REGISTRY as _obs_registry

# Outermost (largest tier) first; the tiers keep the reference's values.
HIERARCHY: dict[str, int] = {
    # The elastic control plane: the autoscaler's targets, tick and
    # counters, above every data-plane tier. Its loop holds no lock across
    # sense, decide or actuate (each setter takes its owner's locks at top
    # level); the tier only makes an accidental hold legal descent.
    "elastic": 60,  # Autoscaler._elastic_cond (targets, tick, counters)
    "service": 50,  # ReplayService._lock (heartbeats, pending, env_steps)
    "buffer": 40,   # ReplayService._buffer_lock (all replay-state access)
    # Multi-learner plane (replica -> aggregator -> store): a replica may
    # hold its control lock while submitting (replica -> agg descends),
    # and the aggregator publishes into the WeightStore under its own
    # condition (agg -> wstore). A replica never holds its lock across a
    # replay sample: buffer sits above replica.
    "replica": 36,  # LearnerReplica._replica_lock (epoch, counters)
    "agg": 34,      # Aggregator._agg_cond (merge state, sync barrier)
    "commit": 30,   # ReplayService._commit_cond (ordered-merge state)
    # Weight-distribution plane (learner -> actors; disjoint from the
    # ingest tiers above, so its band sits between commit and the leaf
    # tiers): a relay's swap state may publish into its local store
    # (wrelay -> wstore), and a server's frame cache refreshes from the
    # store under the cache lock (wserve -> wstore) — both descend.
    "wrelay": 28,   # WeightRelay._relay_lock (generation swap + counters)
    "wserve": 26,   # WeightServer._frame_lock (version window + frame memo)
    # Serving plane: the inference server's pending queue and adopted
    # params; its refresher reads the store outside it
    "pserve": 25,   # PolicyInferenceServer._pserve_cond (pending + params)
    "wstore": 24,   # WeightStore._store_lock (published params + version)
    "shard": 20,    # _IngestShard.cond (admission deque + counters)
    # Sample-on-ingest plane: the dealer's trees, write-back queues and
    # counters. The commit thread reaches it holding the buffer lock
    # (buffer -> sampler); replicas enqueue write-backs under it alone;
    # dealt blocks enter the rings after it is released.
    "sampler": 15,  # SampleDealer._sampler_lock (slice trees + queues)
    "ring": 10,     # MultiRingStaging._ring_locks[i] (staging ring slices)
}


_MAX_VIOLATION_RECORDS = 64


class LockHierarchyError(RuntimeError):
    """A thread acquired a tiered lock out of declared order."""


class _TLS(threading.local):
    def __init__(self):
        self.held: list[tuple[int, str]] = []


_tls = _TLS()

_debug = False
_raise_on_violation = True
_registry_lock = threading.Lock()
_instances: list["TieredLock | TieredCondition"] = []
_violations: list[str] = []
_violation_count = 0


def enable_debug(raise_on_violation: bool = True) -> None:
    """Turn on descent assertions + contention counting. ``raise_on_
    violation=False`` records violations instead of raising — the fleet
    harness runs in record mode (a raise inside a worker thread would
    kill the ingest plane mid-measurement and read as a deadlock) and
    asserts the count is zero afterwards."""
    global _debug, _raise_on_violation
    _raise_on_violation = raise_on_violation
    _debug = True


def disable_debug() -> None:
    global _debug
    _debug = False


def debug_enabled() -> bool:
    return _debug


def reset_stats() -> None:
    global _violations, _violation_count
    with _registry_lock:
        _violations = []
        _violation_count = 0
        for inst in _instances:
            inst._reset_stats()


def hierarchy_violations() -> list[str]:
    with _registry_lock:
        return list(_violations)


def violation_count() -> int:
    with _registry_lock:
        return _violation_count


def lock_stats() -> dict[str, dict]:
    """Contention counters aggregated by tier name (all shard conditions
    fold into one ``shard`` row, etc.). ``wait_ns`` is time spent
    blocked on contended acquisitions; ``cond_waits`` counts
    ``Condition.wait`` calls (intentional waiting, kept separate from
    contention)."""
    agg: dict[str, dict] = {}
    with _registry_lock:
        instances = list(_instances)
    for inst in instances:
        row = agg.setdefault(inst.tier_name, {
            "tier": inst.tier, "acquisitions": 0, "contended": 0,
            "wait_ns": 0, "max_hold_ns": 0, "cond_waits": 0,
        })
        row["acquisitions"] += inst._acquisitions
        row["contended"] += inst._contended
        row["wait_ns"] += inst._wait_ns
        row["max_hold_ns"] = max(row["max_hold_ns"], inst._max_hold_ns)
        row["cond_waits"] += getattr(inst, "_cond_waits", 0)
    return agg


def held_tiers() -> list[tuple[int, str]]:
    """The current thread's held (tier, name) stack — for tests."""
    return list(_tls.held)


@contextlib.contextmanager
def record_mode():
    """Arm the sentinels in record mode for the body, then put back the
    mode that was set before it. The drills of ``fleet/`` run under it
    and report ``violation_count()`` less its value at their start."""
    global _debug, _raise_on_violation
    before = (_debug, _raise_on_violation)
    enable_debug(raise_on_violation=False)
    try:
        yield
    finally:
        _debug, _raise_on_violation = before


def _record_violation(msg: str) -> None:
    global _violation_count
    with _registry_lock:
        _violation_count += 1
        if len(_violations) < _MAX_VIOLATION_RECORDS:
            _violations.append(msg)
    # Flight-recorder event (obs/flight), recorded OUTSIDE the registry
    # lock: a hierarchy violation is exactly the event whose surrounding
    # context the postmortem ring exists to preserve — the fleet harness
    # dumps the ring whenever this count is nonzero at run end.
    record_event("lock_violation", msg=msg)
    if _raise_on_violation:
        raise LockHierarchyError(msg)


class _TieredBase:
    """Shared bookkeeping: descent check + contention counters. The
    counters are only mutated by the acquiring/holding thread (pre-hold
    wait folds in right after the acquire lands), so they need no extra
    synchronization; cross-instance aggregation happens at snapshot
    time in ``lock_stats``."""

    def __init__(self, tier_name: str, tier: int | None = None):
        if tier is None:
            if tier_name not in HIERARCHY:
                raise ValueError(
                    f"unknown lock tier {tier_name!r}; declare it in "
                    f"core.locking.HIERARCHY or pass tier= explicitly")
            tier = HIERARCHY[tier_name]
        self.tier_name = tier_name
        self.tier = int(tier)
        self._reset_stats()
        with _registry_lock:
            _instances.append(self)

    def _reset_stats(self) -> None:
        self._acquisitions = 0
        self._contended = 0
        self._wait_ns = 0
        self._max_hold_ns = 0
        self._held_since = 0

    def _check_and_push(self) -> None:
        held = _tls.held
        if held:
            floor = min(t for t, _ in held)
            if self.tier >= floor:
                chain = " -> ".join(n for _, n in held)
                _record_violation(
                    f"hierarchy violation: acquiring '{self.tier_name}' "
                    f"(tier {self.tier}) while holding [{chain}] (floor "
                    f"tier {floor}); declared order is monotone descent "
                    f"({', '.join(f'{k}={v}' for k, v in HIERARCHY.items())})")
        held.append((self.tier, self.tier_name))

    def _pop(self) -> bool:
        # Unconditional on release (debug on or off): a debug-mode flip
        # between a thread's acquire and its release must never strand a
        # phantom entry on the thread-local stack (daemon service threads
        # outlive the harness bracket that armed the sentinels).
        held = _tls.held
        for i in range(len(held) - 1, -1, -1):
            if held[i] == (self.tier, self.tier_name):
                del held[i]
                return True
        return False

    def _on_acquired(self, waited_ns: int, contended: bool) -> None:
        self._acquisitions += 1
        if contended:
            self._contended += 1
            self._wait_ns += waited_ns
        self._held_since = time.perf_counter_ns()

    def _on_release(self) -> None:
        if self._held_since:
            hold = time.perf_counter_ns() - self._held_since
            if hold > self._max_hold_ns:
                self._max_hold_ns = hold
            self._held_since = 0


class TieredLock(_TieredBase):
    """``threading.Lock`` carrying a tier from the declared hierarchy."""

    def __init__(self, tier_name: str, tier: int | None = None):
        super().__init__(tier_name, tier)
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _debug:
            return self._inner.acquire(blocking, timeout)
        self._check_and_push()
        t0 = time.perf_counter_ns()
        got = self._inner.acquire(False)
        contended = not got
        if not got and blocking:
            got = self._inner.acquire(True, timeout)
        if got:
            self._on_acquired(time.perf_counter_ns() - t0, contended)
        else:
            self._pop()
        return got

    def release(self) -> None:
        if _debug:
            self._on_release()
        self._pop()
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TieredLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TieredCondition(_TieredBase):
    """``threading.Condition`` carrying a tier. ``wait`` releases the
    underlying lock, so the held-stack entry and the hold-time segment
    are closed across the wait and reopened on wake (the re-acquisition
    after a wake is not re-checked: descent was asserted when the
    condition was first entered, and the thread's other held locks
    cannot have changed while it was blocked in ``wait``)."""

    def __init__(self, tier_name: str, tier: int | None = None):
        super().__init__(tier_name, tier)
        self._inner = threading.Condition()
        self._cond_waits = 0

    def _reset_stats(self) -> None:
        super()._reset_stats()
        self._cond_waits = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _debug:
            return self._inner.acquire(blocking, timeout)
        self._check_and_push()
        t0 = time.perf_counter_ns()
        got = self._inner.acquire(False)
        contended = not got
        if not got and blocking:
            got = self._inner.acquire(True, timeout)
        if got:
            self._on_acquired(time.perf_counter_ns() - t0, contended)
        else:
            self._pop()
        return got

    def release(self) -> None:
        if _debug:
            self._on_release()
        self._pop()
        self._inner.release()

    def __enter__(self) -> "TieredCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: float | None = None) -> bool:
        if _debug:
            self._cond_waits += 1
            self._on_release()
        popped = self._pop()
        try:
            return self._inner.wait(timeout)
        finally:
            if popped:  # re-open exactly the entry the wait released
                _tls.held.append((self.tier, self.tier_name))
            if _debug:
                self._held_since = time.perf_counter_ns()

    def wait_for(self, predicate, timeout: float | None = None):
        # mirror threading.Condition.wait_for in terms of our wait()
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def _locks_snapshot() -> dict:
    """The unified-registry view of the lock plane: per-tier contention
    counters + the hierarchy-violation tally. Same consistency contract
    as the bespoke accessors it wraps (counters are owner-thread-mutated
    and aggregated at snapshot time; see ``lock_stats``)."""
    return {
        "debug": _debug,
        "hierarchy_violations": violation_count(),
        "per_lock": lock_stats(),
    }


# module-level function: strong registration is fine (the lock plane
# lives for the process, like the registry itself)
_obs_registry.register_provider("locks", _locks_snapshot)
