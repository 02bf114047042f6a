"""Tiered locks: one declared lock hierarchy, checked at run time.

Counterpart of ``d4pg_tpu/core/locking.py`` (``HIERARCHY``,
``TieredLock``, ``TieredCondition``). ``HIERARCHY`` maps tier names to
integer tiers, outermost first; the rule is monotone tier descent per
thread: a thread may only acquire a lock whose tier is strictly below
every tier it already holds. Every acquisition checks descent (a
thread-local list, cheap next to the lock itself) and raises
``LockHierarchyError`` on an inversion.

Each violation is also recorded on the flight recorder
(``obs.flight``, a ``lock_violation`` event) and counted
(``violation_count``, the learner chaos drill's lock oracle) before it
raises.

Only the tiers of the ported components are declared. Left out: the
reference's debug switch and contention counters (``enable_debug``,
``lock_stats``) and the ``locks`` registry provider built on them, which
its fleet harness reads (ROADMAP Queue 1 item 17c).
"""

from __future__ import annotations

import threading
import time

from d4pg_tpu_torch.obs.flight import record_event

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


class LockHierarchyError(RuntimeError):
    """A thread acquired a tiered lock out of declared order."""


class _TLS(threading.local):
    def __init__(self):
        self.held: list[tuple[int, str]] = []


_tls = _TLS()
_violations_lock = threading.Lock()  # outside the hierarchy: a leaf
_violations = 0


def violation_count() -> int:
    """Hierarchy violations raised in this process so far."""
    with _violations_lock:
        return _violations


def _count_violation() -> None:
    global _violations
    with _violations_lock:
        _violations += 1


class _Tiered:
    """A ``threading`` lock or condition carrying a tier: the descent
    check before each acquisition, the thread's held stack after it."""

    def __init__(self, tier_name: str, inner):
        if tier_name not in HIERARCHY:
            raise ValueError(f"unknown lock tier {tier_name!r}; declare it "
                             f"in core.locking.HIERARCHY")
        self.tier_name = tier_name
        self.tier = HIERARCHY[tier_name]
        self._inner = inner

    def _check_and_push(self) -> None:
        held = _tls.held
        if held and self.tier >= min(t for t, _ in held):
            chain = " -> ".join(n for _, n in held)
            msg = (f"hierarchy violation: acquiring '{self.tier_name}' "
                   f"(tier {self.tier}) while holding [{chain}]; declared "
                   f"order is monotone descent "
                   f"({', '.join(f'{k}={v}' for k, v in HIERARCHY.items())})")
            _count_violation()
            record_event("lock_violation", msg=msg)
            raise LockHierarchyError(msg)
        held.append((self.tier, self.tier_name))

    def _pop(self) -> bool:
        held = _tls.held
        for i in range(len(held) - 1, -1, -1):
            if held[i] == (self.tier, self.tier_name):
                del held[i]
                return True
        return False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_and_push()
        got = self._inner.acquire(blocking, timeout)
        if not got:
            self._pop()
        return got

    def release(self) -> None:
        self._pop()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TieredLock(_Tiered):
    """``threading.Lock`` carrying a tier from the declared hierarchy."""

    def __init__(self, tier_name: str):
        super().__init__(tier_name, threading.Lock())

    def locked(self) -> bool:
        return self._inner.locked()


class TieredCondition(_Tiered):
    """``threading.Condition`` carrying a tier. ``wait`` releases the
    underlying lock, so the held-stack entry is closed across the wait and
    reopened on wake (not re-checked: descent was asserted when the
    condition was entered, and the thread's other held locks cannot have
    changed while it was blocked)."""

    def __init__(self, tier_name: str):
        super().__init__(tier_name, threading.Condition())

    def wait(self, timeout: float | None = None) -> bool:
        popped = self._pop()
        try:
            return self._inner.wait(timeout)
        finally:
            if popped:
                _tls.held.append((self.tier, self.tier_name))

    def wait_for(self, predicate, timeout: float | None = None):
        # threading.Condition.wait_for in terms of this wait()
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
