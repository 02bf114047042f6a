"""Tiered locks: one declared lock hierarchy, checked at run time.

Counterpart of ``d4pg_tpu/core/locking.py`` (``HIERARCHY``,
``TieredLock``, ``TieredCondition``). ``HIERARCHY`` maps tier names to
integer tiers, outermost first; the rule is monotone tier descent per
thread: a thread may only acquire a lock whose tier is strictly below
every tier it already holds. Every acquisition checks descent (a
thread-local list, cheap next to the lock itself) and raises
``LockHierarchyError`` on an inversion.

Each violation is also recorded on the flight recorder
(``obs.flight``, a ``lock_violation`` event) before it raises.

Only the tiers of the ported components are declared. Left out: the
reference's debug switch and contention counters (``enable_debug``,
``lock_stats``) and the ``locks`` registry provider built on them, which
its fleet harness reads (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import threading
import time

from d4pg_tpu_torch.obs.flight import record_event

# Outermost (largest tier) first; the tiers keep the reference's values.
HIERARCHY: dict[str, int] = {
    "service": 50,  # ReplayService._lock (heartbeats, pending, env_steps)
    "buffer": 40,   # ReplayService._buffer_lock (all replay-state access)
    "commit": 30,   # ReplayService._commit_cond (ordered-merge state)
    "wserve": 26,   # WeightServer._frame_lock (frame memo; fills read wstore)
    "wstore": 24,   # WeightStore._store_lock (published params + version)
    "shard": 20,    # _IngestShard.cond (admission deque + counters)
}


class LockHierarchyError(RuntimeError):
    """A thread acquired a tiered lock out of declared order."""


class _TLS(threading.local):
    def __init__(self):
        self.held: list[tuple[int, str]] = []


_tls = _TLS()


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
