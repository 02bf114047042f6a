"""Replay service: the learner-side ingest point for actor transitions.

Counterpart of ``d4pg_tpu/distributed/replay_service.py`` on its
in-process path at one ingest shard. Actors ``add`` transition batches;
each admitted batch takes an admission ticket and waits in a bounded
deque (backpressure: ``add`` blocks up to its timeout, then returns
False). An ingest worker pops groups of batches and hands them to the
commit thread, which inserts them into the buffer in ticket order, one
buffer-lock acquisition per group, and settles the env-step and pending
counts. ``flush`` waits until every accepted batch has been
committed. Heartbeats (every ``add`` is one) give ``dead_actors``.

The buffer is a ``FusedDeviceReplay`` (the fused path) or a host-sampled
``ReplayBuffer`` / ``PrioritizedReplayBuffer`` (``--fused_replay off``),
whose ring is host RAM or a device ring. The learner samples the latter
through ``sample`` / ``sample_chunk`` (with the slots' write generations,
so ``update_priorities`` drops a write-back to a slot the commit thread
overwrote since) and ``weight_base``.

Ownership, as in the reference: for the fused buffer the ingest threads
only stage host rows (``FusedDeviceReplay.add``), and every device
operation (``drain_device``, ``ingest_commit``, ``ingest_stage``) runs on
the learner thread, the single owner of the ring and the trees. A
non-fused device ring is written by the commit thread and gathered by
the learner; both run on the card's default stream under the buffer
lock, so the card runs them in lock order. Every buffer access holds the
buffer lock. Locks are
``core.locking`` tiered objects of the one declared hierarchy (service >
buffer > commit > shard): the shard condition is a leaf, and the commit
thread takes the buffer lock and the service lock one after the other,
never nested. The unified registry (``obs.registry``) holds the
``ingest`` provider (``ingest_stats``) and the ``ingest.rows_committed``
counter; a crash of either ingest thread is counted
(``obs.containment.contained_crash``), after which ``flush`` times out.

Observation normalization (``obs_norm``, an ``envs/normalizer.
RunningMeanStd``): the commit thread is the single writer of the
statistics. Batch by batch, in admission-ticket order, it folds the
batch's ``obs`` into them and then normalizes the batch's ``obs`` and
``next_obs`` with them (``next_obs`` never folds), as the reference's
``_insert_group`` does; every buffer therefore receives standardized
float32 rows, and the statistics do not depend on how the batches were
grouped. The remote planes add through ``add`` from the transport's
receiver callback (one heartbeat per frame), wait on ``wait_until``
(the spawned actors' warm-up), and greet senders with ``generation``,
which stays 0 here: snapshot and restore, which advance it, wait for
ROADMAP Queue 1 item 17.

Not ported yet (each raises when asked for): more than one ingest shard
and shedding at a watermark (ROADMAP Queue 1 item 12, with the undecoded
``add_payload``); eviction and ``kill`` wait for items 12 and 17.
"""

from __future__ import annotations

import itertools
import threading
import time
import traceback
from collections import deque

import numpy as np

from d4pg_tpu_torch.core.locking import TieredCondition, TieredLock
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.uniform import TransitionBatch


class _IngestShard:
    """The admission deque and its counters, all under ``cond``."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.cond = TieredCondition("shard")
        # items: (seq, batch, actor_id, rows, count_env_steps)
        self.q: deque = deque()
        self.admit_fails = 0  # rejected admissions (full past timeout)


class ReplayService:
    _COALESCE = 64

    def __init__(
        self,
        buffer,
        ingest_capacity: int = 256,
        heartbeat_timeout: float = 30.0,
        obs_norm=None,
        shed_watermark: float | None = None,
        num_ingest_shards: int = 1,
    ):
        if int(num_ingest_shards) != 1 or shed_watermark is not None:
            raise NotImplementedError(
                "sharded ingest (num_ingest_shards > 1) and watermark "
                "shedding are not ported yet (ROADMAP Queue 1 item 12)")
        self.buffer = buffer
        self.obs_norm = obs_norm
        self._generation = 0
        self._env_steps = 0
        self._rows_committed = 0
        self._lock = TieredLock("service")
        # guards all buffer access: the commit thread's add races the
        # learner thread's device calls otherwise
        self._buffer_lock = TieredLock("buffer")
        # batches accepted but not yet committed, counted on the producer
        # side so flush() cannot slip between the worker's pop and the
        # commit's insert
        self._pending = 0
        self._heartbeats: dict[str, float] = {}
        self._actor_rows: dict[str, int] = {}  # rows committed per actor
        self._heartbeat_timeout = heartbeat_timeout
        self._shard = _IngestShard(int(ingest_capacity))
        # the commit's inbox, under _commit_cond: the worker's groups, in
        # admission-ticket order
        self._commit_cond = TieredCondition("commit")
        self._out: deque = deque()
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._worker_thread = threading.Thread(
            target=self._worker, daemon=True, name="ingest-shard-0")
        self._commit_thread = threading.Thread(
            target=self._commit_loop, daemon=True, name="ingest-commit")
        self._worker_thread.start()
        self._commit_thread.start()
        REGISTRY.register_provider("ingest", self.ingest_stats)

    # -- actor-facing ------------------------------------------------------
    def add(self, batch: TransitionBatch, actor_id: str = "local",
            timeout: float | None = 5.0,
            count_env_steps: bool = True) -> bool:
        """Enqueue transitions (host arrays). Returns False if the deque
        stayed full past ``timeout``. ``count_env_steps=False`` for rows
        that are not fresh environment interaction."""
        n = int(batch.obs.shape[0])
        self.heartbeat(actor_id)
        if n == 0:
            return True
        return self._admit(batch, actor_id, n, count_env_steps, timeout)

    def _admit(self, batch, actor_id: str, rows: int, count: bool,
               timeout: float | None) -> bool:
        s = self._shard
        with self._lock:
            self._pending += 1
        with s.cond:
            if len(s.q) >= s.capacity:
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while len(s.q) >= s.capacity and not self._stop.is_set():
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        break
                    s.cond.wait(0.1 if remaining is None
                                else min(remaining, 0.1))
            admitted = len(s.q) < s.capacity
            if admitted:
                s.q.append((next(self._seq), batch, actor_id, rows, count))
                s.cond.notify_all()
            else:
                s.admit_fails += 1
        if not admitted:
            with self._lock:
                self._pending -= 1
        return admitted

    def heartbeat(self, actor_id: str) -> None:
        now = time.monotonic()
        with self._lock:
            self._heartbeats[actor_id] = now

    # -- learner-facing ----------------------------------------------------
    def sample(self, batch_size: int, beta: float = 0.4,
               weight_base: float | None = None):
        """PER: ``(batch, weights, idx, generation)``; uniform: the batch.
        The generation snapshot guards the priority write-back."""
        with self._buffer_lock:
            if isinstance(self.buffer, PrioritizedReplayBuffer):
                batch, w, idx = self.buffer.sample(
                    batch_size, beta=beta, weight_base=weight_base)
                return batch, w, idx, self.buffer.generation[idx].copy()
            return self.buffer.sample(batch_size)

    def sample_chunk(self, k: int, batch_size: int, beta: float = 0.4,
                     weight_base: float | None = None):
        """K stacked batches in one storage gather: ``(batches [K, B, ...],
        weights or None, idx [K, B], generation or None [K, B])``, the
        sample of ``learner/pipeline.ChunkPipeline``."""
        with self._buffer_lock:
            if isinstance(self.buffer, PrioritizedReplayBuffer):
                batches, w, idx = self.buffer.sample_chunk(
                    k, batch_size, beta=beta, weight_base=weight_base)
                return batches, w, idx, self.buffer.generation[idx].copy()
            batches, _, idx = self.buffer.sample_chunk(k, batch_size)
            return batches, None, idx, None

    def weight_base(self) -> float | None:
        """The buffer's IS-weight base ``z``; None for uniform replay."""
        with self._buffer_lock:
            if isinstance(self.buffer, PrioritizedReplayBuffer):
                return self.buffer.weight_base()
            return None

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray,
                          generation: np.ndarray | None = None) -> None:
        if isinstance(self.buffer, PrioritizedReplayBuffer):
            with self._buffer_lock:
                self.buffer.update_priorities(idx, priorities,
                                              generation=generation)

    def drain_device(self) -> int:
        """Flush every staged row of a fused buffer onto the device (cycle
        boundaries); 0 for a buffer without staging."""
        drain = getattr(self.buffer, "drain", None)
        if drain is None:
            return 0
        with self._buffer_lock:
            return drain()

    def ingest_commit(self) -> int:
        """Land the in-flight staged block (ring write + tree insert);
        called right before a fused chunk so it samples the newest rows.
        0 for a buffer without the block API."""
        commit = getattr(self.buffer, "commit_staged", None)
        if commit is None:
            return 0
        with self._buffer_lock:
            return commit()

    def ingest_stage(self) -> int:
        """Start the host-to-device copy of the next staged block; called
        right after a fused chunk is queued so the copy overlaps it. A
        buffer without the block API drains instead."""
        stage = getattr(self.buffer, "stage_block", None)
        if stage is None:
            return self.drain_device()
        with self._buffer_lock:
            return stage()

    @property
    def generation(self) -> int:
        """The service generation the transition receiver greets senders
        with (0: no restore has advanced it)."""
        with self._lock:
            return self._generation

    @property
    def env_steps(self) -> int:
        with self._lock:
            return self._env_steps

    def set_env_steps(self, n: int) -> None:
        """Seed the env-step counter (checkpoint resume)."""
        with self._lock:
            self._env_steps = int(n)

    def __len__(self) -> int:
        with self._buffer_lock:
            return len(self.buffer)

    def wait_until(self, min_size: int, timeout: float = 300.0) -> bool:
        """Block until the buffer holds ``min_size`` rows (staged rows of a
        fused buffer count); False past ``timeout``."""
        deadline = time.monotonic() + timeout
        while len(self) < min_size:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def rows_by_actor(self) -> dict[str, int]:
        """Rows committed per actor id (relabels included): which actors,
        local or remote, the replay rows came from."""
        with self._lock:
            return dict(self._actor_rows)

    def dead_actors(self) -> list[str]:
        """Actors whose last heartbeat is older than the timeout."""
        now = time.monotonic()
        with self._lock:
            return [a for a, t in self._heartbeats.items()
                    if now - t > self._heartbeat_timeout]

    def ingest_stats(self) -> dict:
        """The ``ingest`` registry provider. Every counter is read under
        the lock that writes it: the shard's with its deque, the commit
        inbox under the commit condition, the rest under the service
        lock."""
        s = self._shard
        with s.cond:
            queue_depth, admit_fails = len(s.q), s.admit_fails
        with self._commit_cond:
            commit_backlog = len(self._out)
        with self._lock:
            stats = {
                "env_steps": self._env_steps,
                "rows_committed": self._rows_committed,
                "pending": self._pending,
                "live_actors": len(self._heartbeats),
            }
        stats.update(queue_depth=queue_depth, admit_fails=admit_fails,
                     commit_backlog=commit_backlog, num_ingest_shards=1)
        return stats

    # -- ingest threads -----------------------------------------------------
    def _worker(self) -> None:
        """Pop coalesced groups from the deque and hand them to the
        ordered merge; at most one group waits in the merge's inbox, so a
        slow commit backs pressure up into the deque."""
        try:
            self._worker_loop()
        except Exception as e:  # noqa: BLE001 — counted; flush() then times out
            print(f"ingest.shard_worker crashed:\n{traceback.format_exc()}",
                  flush=True)
            contained_crash("ingest.shard_worker", e)

    def _worker_loop(self) -> None:
        s = self._shard
        while not self._stop.is_set():
            with self._commit_cond:
                while self._out and not self._stop.is_set():
                    self._commit_cond.wait(timeout=0.1)
            with s.cond:
                if not s.q:
                    s.cond.wait(timeout=0.1)
                items = []
                while s.q and len(items) < self._COALESCE:
                    items.append(s.q.popleft())
                if items:
                    s.cond.notify_all()  # space freed: wake blocked adds
            if not items:
                continue
            with self._commit_cond:
                self._out.extend(items)
                self._commit_cond.notify_all()

    def _commit_loop(self) -> None:
        try:
            self._commit_run()
        except Exception as e:  # noqa: BLE001 — counted; flush() then times out
            print(f"ingest.commit crashed:\n{traceback.format_exc()}",
                  flush=True)
            contained_crash("ingest.commit", e)

    def _commit_run(self) -> None:
        """Insert the worker's groups in ticket order. With one shard the
        worker hands them over in admission order, so the reference's
        reordering merge (and its order-break valve) has nothing to do."""
        while True:
            with self._commit_cond:
                if not self._out:
                    if self._stop.is_set():
                        return
                    self._commit_cond.wait(timeout=0.1)
                group = [self._out.popleft() for _ in
                         range(min(len(self._out), self._COALESCE))]
                if group:
                    self._commit_cond.notify_all()  # the inbox is free
            if group:
                self._insert_group(group)

    def _insert_group(self, group: list) -> None:
        try:
            if self.obs_norm is not None:
                # fold, then normalize, batch by batch in ticket order:
                # only obs feeds the estimator, next_obs is normalized
                # but never folded
                norm = self.obs_norm
                for j, (seq, batch, aid, rows, count) in enumerate(group):
                    norm.update(batch.obs)
                    group[j] = (seq, batch._replace(
                        obs=norm.normalize(batch.obs),
                        next_obs=norm.normalize(batch.next_obs)),
                        aid, rows, count)
            with self._buffer_lock:
                for _seq, batch, _aid, _rows, _count in group:
                    self.buffer.add(batch)
        finally:
            committed = 0
            with self._lock:
                for _seq, _batch, aid, rows, count in group:
                    if count:
                        self._env_steps += rows
                    committed += rows
                    self._actor_rows[aid] = self._actor_rows.get(aid, 0) + rows
                self._rows_committed += committed
                self._pending -= len(group)
            REGISTRY.counter("ingest.rows_committed").inc(committed)

    def flush(self, timeout: float = 5.0) -> None:
        """Block until every accepted batch has been committed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return
            time.sleep(0.005)

    def close(self) -> None:
        """Flush, then stop the ingest threads."""
        self.flush()
        REGISTRY.unregister_provider("ingest", self.ingest_stats)
        self._stop.set()
        with self._shard.cond:
            self._shard.cond.notify_all()
        with self._commit_cond:
            self._commit_cond.notify_all()
        self._worker_thread.join(timeout=2.0)
        self._commit_thread.join(timeout=2.0)
