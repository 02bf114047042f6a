"""Update aggregator: N learner replicas, ONE versioned weight stream.

Counterpart of ``d4pg_tpu/learner/aggregator.py::Aggregator``. Each
``LearnerReplica`` computes updates against a basis version it pulled
from here and stamps it on its submission; the aggregator merges the
submission into the one authoritative parameter tree and publishes every
merge through the ``WeightStore``, so actors and the weight plane see one
monotone (generation, version) stream.

The tree is ``learner/replica.params_of``'s: a dict of the four network
fields, each a dict of parameter name -> CPU tensor. Merges run on the
host in numpy, as the reference's do, and the results go back into CPU
tensors for the store.

- ``async``: a submission against basis ``b`` arriving at version ``v``
  has lag ``v - b`` and is applied as ``params + w * (submitted -
  params)`` per leaf in its dtype (``w`` float32), ``w = max(1 / (1 +
  lag), 1 / clip)``; how often the floor engages is the clip rate. At lag
  0 the submission IS the next aggregate (adopted whole, no arithmetic),
  which keeps one replica bitwise equal to the plain loop.
- ``sync``: an N-way averaging barrier: the submissions of every live
  replica are averaged in float64 and cast back (a sole contributor is
  adopted exactly), published once, and every waiter is released. A
  replica fenced mid-round leaves the barrier, so a kill never wedges the
  survivors.

Fencing: each registration opens a new epoch; ``fence_replica`` retires
the live one, so a submission stamped with a dead epoch (or another
generation than the store's) is counted and discarded. Versions come
from ``WeightStore.publish`` and the ledger checks they never rewind.

Locking: all of it under one ``agg``-tier condition (34, above the
store's ``wstore`` 24: publishing under it descends). The aggregator
registers the registry's ``learner`` provider.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from d4pg_tpu_torch.core.locking import TieredCondition
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.registry import REGISTRY, percentile_summary

MODES = ("async", "sync")


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: tree_map(fn, *[t[key] for t in trees]) for key in first}
    return fn(*trees)


def _blend(cur: torch.Tensor, new: torch.Tensor, w: float) -> torch.Tensor:
    """One leaf of the stale-update correction, in the leaf's dtype."""
    c = cur.numpy()
    out = c + np.asarray(w, dtype=np.float32) * (new.numpy() - c)
    return torch.from_numpy(out.astype(c.dtype, copy=False))


def _mean(*leaves: torch.Tensor) -> torch.Tensor:
    """The sync barrier's average: summed in float64, cast back."""
    arrs = [x.numpy() for x in leaves]
    out = np.sum(np.stack(arrs, 0), axis=0, dtype=np.float64) / len(arrs)
    return torch.from_numpy(out.astype(arrs[0].dtype))


def _new_stats() -> dict:
    return {"submits": 0, "fenced": 0, "lag": None, "weight": None,
            "last_version": 0}


class Aggregator:
    """Merges per-replica updates into one versioned ``WeightStore``.

    ``extract`` maps the merged tree to what the store publishes (the
    driver passes ``lambda t: t["actor_params"]``: actors pull acting
    params only); ``norm_stats`` is the normalizer snapshot hook the
    publish carries."""

    def __init__(
        self,
        store,
        *,
        mode: str = "async",
        clip: float = 8.0,
        extract: Optional[Callable[[Any], Any]] = None,
        norm_stats: Optional[Callable[[], tuple | None]] = None,
        sync_timeout: float = 30.0,
    ):
        if mode not in MODES:
            raise ValueError(f"unknown aggregation mode {mode!r}")
        if clip < 1.0:
            raise ValueError(
                f"clip={clip} would weight stale updates ABOVE fresh ones; "
                "the bound is a floor 1/clip <= 1, so clip >= 1")
        self._store = store
        self.mode = mode
        self.clip = float(clip)
        self._extract = extract
        self._norm_stats = norm_stats
        self._sync_timeout = float(sync_timeout)
        self._agg_cond = TieredCondition("agg")
        # -- merge state (all under _agg_cond) ------------------------------
        self._params: Any = None
        self._version = int(getattr(store, "version", 0))
        self._step = 0
        self._epochs: dict[int, int] = {}  # live epoch per replica
        self._next_epoch: dict[int, int] = {}  # monotone per replica id
        self._per_replica: dict[int, dict] = {}
        self._lags: deque = deque(maxlen=4096)
        self._applied = 0
        self._fenced = 0
        self._clipped = 0
        self._ledger: list[tuple[int, int]] = []  # published (gen, version)
        # -- sync barrier ----------------------------------------------------
        self._round: dict[int, tuple] = {}  # id -> (params, lag, step)
        self._round_seq = 0
        self._sync_results: dict[int, dict] = {}
        REGISTRY.register_provider("learner", self._snapshot)

    # -- replica lifecycle ---------------------------------------------------
    def register(self, replica_id: int, params: Any = None,
                 step: int = 0) -> int:
        """Admit (or re-admit) a replica; returns its live epoch. The first
        registration may seed the aggregate with the replica's initial
        params (basis version 0)."""
        with self._agg_cond:
            epoch = self._next_epoch.get(replica_id, 0) + 1
            self._next_epoch[replica_id] = epoch
            self._epochs[replica_id] = epoch
            stats = self._per_replica.setdefault(replica_id, _new_stats())
            stats["epoch"] = epoch
            if params is not None and self._params is None:
                self._params = params
                self._step = int(step)
            self._maybe_complete_round_locked()
            self._agg_cond.notify_all()
            return epoch

    def fence_replica(self, replica_id: int) -> None:
        """Retire the replica's epoch (its in-flight submission bounces on
        arrival) and drop it from a pending sync round."""
        with self._agg_cond:
            self._epochs.pop(replica_id, None)
            self._round.pop(replica_id, None)
            record_event("replica_fenced", replica=replica_id)
            self._maybe_complete_round_locked()
            self._agg_cond.notify_all()

    def live_epoch(self, replica_id: int) -> Optional[int]:
        """The replica's live epoch, or None once fenced."""
        with self._agg_cond:
            return self._epochs.get(replica_id)

    # -- basis pulls ---------------------------------------------------------
    def current(self) -> tuple[int, Any]:
        """(version, merged params); params None before any seed."""
        with self._agg_cond:
            return self._version, self._params

    def basis(self, replica_id: int) -> tuple[int, Any]:
        """``(version, params)`` for the replica's next round; params are
        None when nothing newer than its own last applied submission
        exists (a replica never re-adopts its own round trip)."""
        with self._agg_cond:
            stats = self._per_replica.get(replica_id)
            last = stats["last_version"] if stats else 0
            if self._params is None or self._version <= last:
                return self._version, None
            return self._version, self._params

    # -- submission ----------------------------------------------------------
    def submit(self, replica_id: int, epoch: int, params: Any,
               basis_version: int, step: int = 0,
               generation: int | None = None) -> dict:
        """Merge one update computed against ``basis_version``. Returns
        ``{"status": "applied"|"fenced"|"barrier_timeout", "version",
        "lag", "weight", "clipped"}``; sync mode blocks until its round
        completes or times out."""
        with self._agg_cond:
            stats = self._per_replica.setdefault(replica_id, _new_stats())
            live = self._epochs.get(replica_id)
            if live != epoch or (generation is not None and
                                 generation != self._store.generation):
                self._fenced += 1
                stats["fenced"] += 1
                record_event("update_fenced", replica=replica_id,
                             epoch=epoch, live_epoch=live)
                return {"status": "fenced", "version": self._version,
                        "lag": None, "weight": 0.0, "clipped": False}
            lag = self._version - int(basis_version)
            if lag < 0:
                # a basis from the future: a protocol breach
                self._fenced += 1
                stats["fenced"] += 1
                return {"status": "fenced", "version": self._version,
                        "lag": lag, "weight": 0.0, "clipped": False}
            if self.mode == "sync":
                return self._submit_sync_locked(
                    replica_id, params, lag, step, stats)
            raw_w = 1.0 / (1.0 + lag)
            w = max(raw_w, 1.0 / self.clip)
            clipped = raw_w < w
            if clipped:
                self._clipped += 1
            if lag == 0 or self._params is None:
                self._params = params  # exact: no arithmetic at lag 0
            else:
                self._params = tree_map(lambda c, n: _blend(c, n, w),
                                        self._params, params)
            self._step = int(step)
            version = self._publish_locked()
            self._applied += 1
            self._lags.append(float(lag))
            stats["submits"] += 1
            stats["lag"] = lag
            stats["weight"] = round(w, 6)
            stats["last_version"] = version
            return {"status": "applied", "version": version, "lag": lag,
                    "weight": w, "clipped": clipped}

    def _submit_sync_locked(self, replica_id: int, params: Any, lag: int,
                            step: int, stats: dict) -> dict:
        self._round[replica_id] = (params, lag, int(step))
        seq = self._round_seq
        self._maybe_complete_round_locked()
        done = self._agg_cond.wait_for(
            lambda: self._round_seq != seq
            or self._epochs.get(replica_id) is None,
            timeout=self._sync_timeout)
        if self._epochs.get(replica_id) is None:
            self._fenced += 1
            stats["fenced"] += 1
            return {"status": "fenced", "version": self._version,
                    "lag": lag, "weight": 0.0, "clipped": False}
        if not done:
            # the contribution stays staged; a late round may complete it
            return {"status": "barrier_timeout", "version": self._version,
                    "lag": lag, "weight": 0.0, "clipped": False}
        return self._sync_results.pop(replica_id)

    def _maybe_complete_round_locked(self) -> None:
        if (self.mode != "sync" or not self._epochs or not self._round
                or set(self._round) < set(self._epochs)):
            return
        contributions = [self._round[rid] for rid in sorted(self._round)]
        n = len(contributions)
        if n == 1:
            merged = contributions[0][0]  # a sole contributor: exact
        else:
            merged = tree_map(_mean, *[c[0] for c in contributions])
        self._params = merged
        self._step = max(c[2] for c in contributions)
        version = self._publish_locked()
        self._applied += n
        w = 1.0 / n
        for rid in list(self._round):
            _params, lag, _step = self._round.pop(rid)
            st = self._per_replica[rid]
            st["submits"] += 1
            st["lag"] = lag
            st["weight"] = round(w, 6)
            st["last_version"] = version
            self._lags.append(float(lag))
            self._sync_results[rid] = {
                "status": "applied", "version": version, "lag": lag,
                "weight": w, "clipped": False}
        self._round_seq += 1
        self._agg_cond.notify_all()

    def _publish_locked(self) -> int:
        pub = self._extract(self._params) if self._extract else self._params
        norm = self._norm_stats() if self._norm_stats else None
        # holding agg (34) while the store takes wstore (24): descends
        version = self._store.publish(pub, step=self._step, to_host=False,
                                      norm_stats=norm)
        self._version = version
        self._ledger.append((self._store.generation, version))
        return version

    # -- oracles and obs -----------------------------------------------------
    @property
    def generation(self) -> int:
        """The store's generation: a submission stamped with another is
        fenced."""
        return self._store.generation

    @property
    def version(self) -> int:
        with self._agg_cond:
            return self._version

    def ledger(self) -> list[tuple[int, int]]:
        with self._agg_cond:
            return list(self._ledger)

    def ledger_monotone(self) -> bool:
        """Generation never decreases, and within a generation the
        version strictly increases, across every publish."""
        prev = (-1, -1)
        for gen, version in self.ledger():
            if gen < prev[0] or (gen == prev[0] and version <= prev[1]):
                return False
            prev = (gen, version)
        return True

    def counters(self) -> dict:
        with self._agg_cond:
            return {"applied": self._applied, "fenced": self._fenced,
                    "clipped": self._clipped,
                    "published": len(self._ledger)}

    def _snapshot(self) -> dict:
        """The ``learner`` provider: per-replica lag and fence tallies,
        the clip rate, staleness percentiles, under the one condition."""
        with self._agg_cond:
            applied = self._applied
            return {
                "mode": self.mode,
                "clip": self.clip,
                "version": self._version,
                "replicas": {
                    str(rid): dict(stats)
                    for rid, stats in self._per_replica.items()},
                "live_replicas": len(self._epochs),
                "applied": applied,
                "fenced": self._fenced,
                "clip_rate": (round(self._clipped / applied, 4)
                              if applied else 0.0),
                "staleness": percentile_summary(list(self._lags)),
            }

    def close(self) -> None:
        REGISTRY.unregister_provider("learner", self._snapshot)
