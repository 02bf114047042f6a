"""Replay service: the learner-side ingest point for actor transitions.

Counterpart of ``d4pg_tpu/distributed/replay_service.py``. Actors
``add`` transition batches (remote frames arrive through the transport's
receiver); each admitted batch takes a global admission ticket and waits
in a bounded per-shard deque. The service runs ``num_ingest_shards=K``
ingest shards, each owning its deque, its counters and one worker thread,
all under the shard's one condition (a leaf lock): a worker pops groups
of batches, decodes wire payloads and hands the group to the commit
thread, which merges the K shards' outputs back in ticket order and
inserts them into the buffer, one buffer-lock acquisition per group, and
settles the env-step and pending counts. ``flush`` waits until every
accepted batch has been committed. At K = 1 this is one deque drained in
arrival order.

Admission (``_admit``): without a ``shed_watermark`` a full shard blocks
the caller up to its timeout (5 s for ``add_payload``), then counts the
refusal in ``admit_fails``. With one (a fraction of ``ingest_capacity``,
per shard) admission never blocks: a shard at the watermark drops its
oldest queued batch, counts it in ``sheds``/``shed_rows`` and tombstones
its ticket so the merge never waits for it. ``add_payload`` takes an
undecoded frame from the sharded receiver: a raw (v2) frame is admitted
on its header alone (``transport.raw_frame_meta_ex``: actor, rows, trace
and generation) and decoded on the owning shard's worker; an npz frame is
decoded at admission. A frame stamped with a generation older than the
service's is fenced (counted, never admitted); one that does not decode
is counted in ``decode_errors`` and tombstoned. A ticket that the merge's
order-break valve passed (no progress for ``_ORDER_GRACE_S`` seconds
while output waits) is dropped when it turns up and counted in
``order_breaks``.

The direct stage: with K > 1, no normalizer and a buffer with
``add_sharded`` (a ``FusedDeviceReplay(ingest_shards=K)``), each worker
copies its rows straight into its shard's staging ring under that ring's
leaf lock, without the buffer lock, and the commit thread only settles
the ordered accounting. With a normalizer the commit thread folds and
inserts batch by batch in ticket order, so the statistics are those of
one shard.

The buffer is a ``FusedDeviceReplay`` (the fused path) or a host-sampled
``ReplayBuffer`` / ``PrioritizedReplayBuffer`` (``--fused_replay off``),
whose ring is host RAM or a device ring. The learner samples the latter
through ``sample`` / ``sample_chunk`` (with the slots' write generations,
so ``update_priorities`` drops a write-back to a slot the commit thread
overwrote since) and ``weight_base``.

Ownership, as in the reference: for the fused buffer the ingest threads
only stage host rows, and every device operation (``drain_device``,
``ingest_commit``, ``ingest_stage``) runs on the learner thread, the
single owner of the ring and the trees. A non-fused device ring is
written by the commit thread and gathered by the learner; both run on the
card's default stream under the buffer lock, so the card runs them in
lock order. Locks are ``core.locking`` tiered objects of the one declared
hierarchy (service > buffer > commit > shard > ring): a shard condition
is a leaf, and the commit thread takes the buffer lock and the service
lock one after the other, never nested.

Observation normalization (``obs_norm``, an ``envs/normalizer.
RunningMeanStd``): the commit thread is the single writer of the
statistics. Batch by batch, in admission-ticket order, it folds the
batch's ``obs`` into them and then normalizes the batch's ``obs`` and
``next_obs`` with them (``next_obs`` never folds), as the reference's
``_insert_group`` does.

Observability: the registry holds the ``ingest`` provider
(``ingest_stats``, with ``per_shard`` rows) and the
``ingest.rows_admitted`` and ``ingest.rows_committed`` counters; a
traced frame records ``admission`` (with its birth as ``send``),
``decode``, ``stage`` and ``merge`` spans and ``mark_committed``, and a
shed, fenced or refused one ends with ``terminal_shed``; the flight
recorder gets ``admit``, ``admit_fail``, ``shed``, ``decode_error``,
``generation_fenced``, ``order_break``, ``eviction`` and ``readmission``
events. Heartbeats (every ``add``) give ``dead_actors``; ``evict_dead``
moves stale actors to an evicted set that a heartbeat or a streamed
batch re-admits. A crash of an ingest thread is counted
(``obs.containment.contained_crash``), after which ``flush`` times out.

Sample-on-ingest (``attach_dealer``): with a ``replay/sampler.
SampleDealer`` (or the device dealer of ``replay/device_sampler.py``)
attached, every ordered commit hands its inserts to the dealer inside
its buffer-lock window (``ingest_and_deal``: mirror, settle write-backs,
draw), and the dealt blocks enter the per-replica rings after every
service lock is released; with no group to commit, the commit loop runs
an idle deal tick (settle and top up) about every 0.1 s, or at once when
a replica's pop frees ring room (``_kick_commit``). Replicas write
priorities back through ``queue_writeback`` (the ``sampler`` tier only,
never the buffer lock); each shard's worker drains the queues of its own
slices. Shed, tombstoned and stale tickets are reported to the dealer
for its audit.

Crash recovery: ``snapshot`` takes a quiesced cut (``flush``, then the
buffer's rows and PER state under the buffer lock, the ticket floor under
the commit condition and the row ledger under the service lock: three
locks one after another, never nested) as a dict of numpy arrays and
Python scalars; ``restore`` lands one in a fresh service (rows and trees,
ticket floor, ledger) and moves the service ``generation`` past the
snapshot's, so a raw frame a sender encoded against the dead service is
fenced at admission; with a dealer attached it drops the blocks dealt
before the restore (``clear_rings``) and then re-derives the dealer's
state from the restored buffer (``resync``). ``kill`` stops the ingest
threads without a flush, as a crash would. ``io/checkpoint``'s sidecars
carry the snapshot to disk.

The elastic plane (``elastic/``): with an ``admission=`` policy
(``elastic.AdmissionPolicy``) a shard at its watermark sheds the oldest
batch of the worst class queued, and an incoming batch that ranks below
everything queued is itself rejected (an ``admission_reject`` event);
every shed and reject is attributed to its class in the shard's
``sheds_by_class``, summed over the shards in ``ingest_stats``. Without a
policy shedding is flat, oldest first. ``set_ingest_depth`` (the
autoscaler's ``ingest_capacity`` actuator) resizes every shard's deque
under its own condition, one shard after another, recomputes the
watermark at the fraction the service keeps, and wakes producers blocked
on a full deque.
"""

from __future__ import annotations

import itertools
import threading
import time
import traceback
from collections import deque

import numpy as np

from d4pg_tpu_torch.core.locking import TieredCondition, TieredLock
from d4pg_tpu_torch.distributed.transport import decode_frame, raw_frame_meta_ex
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import EVENT_ADMISSION_REJECT, record_event
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.obs.trace import RECORDER as _tracer
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.uniform import TransitionBatch

# Seconds the ordered merge may make no progress while shard output waits
# before it skips ahead to the smallest ready ticket (counted in
# ``order_breaks``): a lost ticket is a bug, but the plane degrades and
# counts rather than wedging.
_ORDER_GRACE_S = 5.0


class _IngestShard:
    """One ingest shard: its admission deque and counters, all under
    ``cond``, so ``snapshot`` is consistent by construction."""

    def __init__(self, idx: int, capacity: int, shed_at: int | None):
        self.idx = idx
        self.capacity = capacity
        self.shed_at = shed_at
        self.cond = TieredCondition("shard")
        # rows shed or rejected per admission class (class name -> rows),
        # written under ``cond`` with the deque it describes
        self.sheds_by_class: dict[str, int] = {}
        # items: (seq, data, codec, actor_id, rows, count, trace). codec
        # None: ``data`` is a decoded TransitionBatch; else the undecoded
        # payload for ``decode_frame(data, codec)``. ``trace`` is the
        # frame's (trace id, birth) or None.
        self.q: deque = deque()
        self.sheds = 0
        self.shed_rows = 0
        self.decode_errors = 0
        self.rows_in = 0
        self.staged_rows = 0
        self.admit_fails = 0  # refused admissions (full past the timeout)

    def snapshot(self) -> dict:
        with self.cond:
            return {
                "shard": self.idx,
                "queue_depth": len(self.q),
                "sheds": self.sheds,
                "shed_rows": self.shed_rows,
                "decode_errors": self.decode_errors,
                "rows_in": self.rows_in,
                "staged_rows": self.staged_rows,
                "admit_fails": self.admit_fails,
                "capacity": self.capacity,
                "shed_at": self.shed_at,
                "sheds_by_class": dict(self.sheds_by_class),
            }


def _merge_class_counts(dicts) -> dict:
    """Sum the shards' ``sheds_by_class`` into one fleet view."""
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


class ReplayService:
    # max batches folded into one merged commit: bounds the buffer-lock
    # hold (the learner waits on the same lock) while amortizing it
    _COALESCE = 64

    def __init__(
        self,
        buffer,
        ingest_capacity: int = 256,
        heartbeat_timeout: float = 30.0,
        obs_norm=None,
        shed_watermark: float | None = None,
        num_ingest_shards: int = 1,
        generation: int = 0,
        admission=None,
    ):
        self.buffer = buffer
        self.obs_norm = obs_norm
        self.num_ingest_shards = max(1, int(num_ingest_shards))
        buf_shards = getattr(buffer, "ingest_shards", 1)
        if buf_shards not in (1, self.num_ingest_shards):
            # two workers pushing one staging ring would interleave their
            # tickets and break the merge's per-ring ascending order
            raise ValueError(
                f"buffer.ingest_shards={buf_shards} must be 1 or match "
                f"num_ingest_shards={self.num_ingest_shards}")
        # a raw frame stamped with an older generation is fenced at
        # admission; restore() moves it past the snapshot's, and a
        # supervisor restarting without a snapshot passes it explicitly
        self._generation = int(generation)
        self._fenced_frames = 0
        self._fenced_rows = 0
        self._env_steps = 0
        # rows landed in replay state, counted once at commit for both the
        # insert and the direct-stage paths
        self._rows_committed = 0
        self._lock = TieredLock("service")
        # guards all buffer access: the commit thread's add races the
        # learner thread's device calls otherwise
        self._buffer_lock = TieredLock("buffer")
        # batches accepted but not yet committed, counted on the producer
        # side so flush() cannot slip between a worker's pop and the
        # commit's insert
        self._pending = 0
        self._heartbeats: dict[str, float] = {}
        self._owner: dict[str, int] = {}  # actor -> its last ingest shard
        self._actor_rows: dict[str, int] = {}  # rows committed per actor
        self._heartbeat_timeout = heartbeat_timeout
        self._shed_at = (
            None if shed_watermark is None
            else max(1, min(ingest_capacity,
                            int(shed_watermark * ingest_capacity))))
        # the watermark as a fraction: set_ingest_depth recomputes shed_at
        # from it when it resizes the deques
        self._shed_watermark = shed_watermark
        # the elastic admission policy (frozen, stateless: shared by every
        # shard condition without a lock edge); None sheds flat
        self._admission = admission
        self.evictions = 0
        self.readmissions = 0
        self._evicted: dict[str, float] = {}
        self._recovery_s: list[float] = []
        self._shards = [_IngestShard(i, int(ingest_capacity), self._shed_at)
                        for i in range(self.num_ingest_shards)]
        self._direct_stage = (
            self.num_ingest_shards > 1 and obs_norm is None
            and buf_shards > 1 and hasattr(buffer, "add_sharded"))
        # the ordered merge, under _commit_cond: per-shard outputs (ticket
        # ascending), tombstoned tickets, the next ticket to commit
        self._commit_cond = TieredCondition("commit")
        # the sample-on-ingest dealer (attach_dealer): written under the
        # buffer lock, read without a lock (set once)
        self._dealer = None
        self._out: list[deque] = [deque() for _ in self._shards]
        self._skip: set[int] = set()
        self._next_seq = 0
        self._seq = itertools.count()
        self.order_breaks = 0
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker, args=(s,), daemon=True,
                             name=f"ingest-shard-{s.idx}")
            for s in self._shards]
        self._commit_thread = threading.Thread(
            target=self._commit_loop, daemon=True, name="ingest-commit")
        for t in self._workers:
            t.start()
        self._commit_thread.start()
        REGISTRY.register_provider("ingest", self.ingest_stats)

    # -- actor-facing ------------------------------------------------------
    def add(self, batch: TransitionBatch, actor_id: str = "local",
            block: bool = True, timeout: float | None = 5.0,
            count_env_steps: bool = True, shard: int | None = None) -> bool:
        """Enqueue transitions (host arrays). Returns False if the shard's
        deque stayed full past ``timeout`` (or at once with
        ``block=False``). With a shed watermark it never blocks and
        returns True: the shard sheds its oldest batch instead.
        ``count_env_steps=False`` for rows that are not fresh environment
        interaction. ``shard`` pins the ingest shard; by default an actor
        hashes onto one."""
        n = int(batch.obs.shape[0])
        s = self._route(actor_id, shard)
        self.heartbeat(actor_id, shard=s.idx)
        if n == 0:
            return True
        return self._admit(s, batch, None, actor_id, n, count_env_steps,
                           block, timeout)

    def add_payload(self, payload: bytes, shard: int = 0,
                    codec: str = "npz") -> bool:
        """Admit one undecoded wire frame from the sharded receiver (see
        the module docstring). Without a watermark a full shard blocks
        the connection thread up to 5 s, as the unsharded receiver's
        ``add`` does, and a frame refused past that counts in
        ``admit_fails``."""
        trace = None
        gen = None
        s = self._shards[shard % self.num_ingest_shards]
        try:
            if codec == "raw":
                # header only: the trace id and birth ride the header, so
                # a sampled frame is accountable before a column is read
                actor_id, n, count, trace, gen = raw_frame_meta_ex(payload)
                data: object = payload
            else:
                actor_id, batch, count = decode_frame(payload, codec)
                n, codec, data = int(batch.obs.shape[0]), None, batch
        except Exception:  # noqa: BLE001 — counted: a hostile frame
            with s.cond:
                s.decode_errors += 1
            record_event("decode_error", shard=s.idx, where="admission")
            return False
        self.heartbeat(actor_id, shard=s.idx)
        if gen is not None:
            # a frame stamped with a pre-restart generation may duplicate
            # rows a restored snapshot holds: fenced, a declared loss
            with self._lock:
                fenced = gen < self._generation
                if fenced:
                    self._fenced_frames += 1
                    self._fenced_rows += n
            if fenced:
                REGISTRY.counter("ingest.rows_fenced").inc(n)
                record_event("generation_fenced", shard=s.idx, actor=actor_id,
                             rows=n, frame_gen=gen)
                if trace is not None:
                    _tracer.begin(trace[0], trace[1])
                    _tracer.terminal_shed(trace[0])
                return True
        if n == 0:
            return True
        return self._admit(s, data, codec, actor_id, n, count,
                           block=s.shed_at is None, timeout=5.0, trace=trace)

    def _route(self, actor_id: str, shard: int | None) -> _IngestShard:
        if shard is not None:
            return self._shards[shard % self.num_ingest_shards]
        if self.num_ingest_shards == 1:
            return self._shards[0]
        return self._shards[hash(actor_id) % self.num_ingest_shards]

    def _admit(self, s: _IngestShard, data, codec, actor_id: str, rows: int,
               count: bool, block: bool, timeout: float | None,
               trace: tuple[int, float] | None = None) -> bool:
        with self._lock:
            self._pending += 1
        shed_seqs: list[int] = []
        shed_tids: list[int] = []
        rejected_cls: str | None = None
        pol = self._admission
        with s.cond:
            if s.shed_at is not None:
                # shed admission: bounded work, never blocks; the counters
                # and the deque change under the one lock. With a policy
                # the victim is the oldest batch of the worst class queued,
                # and an incoming batch below everything queued is itself
                # rejected (attributed to its class)
                inc_cls = (None if pol is None
                           else pol.classify_actor(actor_id))
                admitted = True
                while len(s.q) >= s.shed_at:
                    if pol is None:
                        victim = 0
                    else:
                        classes = [pol.classify_actor(it[3]) for it in s.q]
                        victim = pol.shed_victim(classes, inc_cls)
                        if victim is None:
                            admitted = False
                            rejected_cls = pol.class_name(inc_cls)
                            s.sheds_by_class[rejected_cls] = (
                                s.sheds_by_class.get(rejected_cls, 0) + rows)
                            break
                    old = s.q[victim]
                    del s.q[victim]
                    s.sheds += 1
                    s.shed_rows += old[4]
                    if pol is not None:
                        name = pol.class_name(classes[victim])
                        s.sheds_by_class[name] = (
                            s.sheds_by_class.get(name, 0) + old[4])
                    shed_seqs.append(old[0])
                    if old[6] is not None:
                        shed_tids.append(old[6][0])
            elif len(s.q) >= s.capacity:
                if block:
                    deadline = (None if timeout is None
                                else time.monotonic() + timeout)
                    while (len(s.q) >= s.capacity
                           and not self._stop.is_set()):
                        remaining = (None if deadline is None
                                     else deadline - time.monotonic())
                        if remaining is not None and remaining <= 0:
                            break
                        s.cond.wait(0.1 if remaining is None
                                    else min(remaining, 0.1))
                admitted = len(s.q) < s.capacity
            else:
                admitted = True
            if admitted:
                seq = next(self._seq)
                s.q.append((seq, data, codec, actor_id, rows, count, trace))
                s.rows_in += rows
                s.cond.notify_all()
            else:
                s.admit_fails += 1
        # observability outside the shard condition
        if admitted:
            if trace is not None:
                _tracer.begin(trace[0], trace[1])
                _tracer.record_span(trace[0], "admission")
            record_event("admit", shard=s.idx, actor=actor_id, rows=rows)
            REGISTRY.counter("ingest.rows_admitted").inc(rows)
        else:
            if rejected_cls is not None:
                # a class-policy rejection, apart from the timeout path's
                # admit_fail
                record_event(EVENT_ADMISSION_REJECT, plane="ingest",
                             shard=s.idx, actor=actor_id, cls=rejected_cls,
                             rows=rows)
            record_event("admit_fail", shard=s.idx, actor=actor_id,
                         rows=rows)
            if trace is not None:
                _tracer.begin(trace[0], trace[1])
                _tracer.terminal_shed(trace[0])
        if shed_seqs:
            self._tombstone(shed_seqs)
            if self._dealer is not None:
                self._dealer.mark_dead_seqs(shed_seqs)
            record_event("shed", shard=s.idx, batches=len(shed_seqs),
                         seqs=shed_seqs[:8])
            for tid in shed_tids:
                _tracer.terminal_shed(tid)
        dropped = len(shed_seqs) + (0 if admitted else 1)
        if dropped:
            with self._lock:
                self._pending -= dropped  # sheds never reach the commit
        return admitted

    def _tombstone(self, seqs: list[int]) -> None:
        with self._commit_cond:
            self._skip.update(seqs)
            self._commit_cond.notify_all()

    def heartbeat(self, actor_id: str, shard: int | None = None) -> None:
        now = time.monotonic()
        with self._lock:
            evicted_at = self._evicted.pop(actor_id, None)
            if evicted_at is not None:
                # the actor came back: re-admit it and record the outage
                self.readmissions += 1
                if len(self._recovery_s) < 10_000:
                    self._recovery_s.append(now - evicted_at)
            self._heartbeats[actor_id] = now
            if shard is not None:
                self._owner[actor_id] = shard
        if evicted_at is not None:
            record_event("readmission", actor=actor_id,
                         outage_s=round(now - evicted_at, 3))

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

    def attach_dealer(self, dealer) -> None:
        """Wire a sample-on-ingest dealer into the commit path (see the
        module docstring). A replica's pop that frees ring room wakes the
        commit loop for a top-up deal; the kick runs on the replica's
        thread with no lock held."""
        with self._buffer_lock:
            dealer.resync(self.buffer)
            self._dealer = dealer
        for ring in dealer.rings:
            ring.on_room = self._kick_commit

    def _kick_commit(self) -> None:
        with self._commit_cond:
            self._commit_cond.notify_all()

    def queue_writeback(self, idx: np.ndarray, priorities: np.ndarray,
                        generation: np.ndarray) -> None:
        """A replica's priority write-back on the dealt path: queued under
        the ``sampler`` tier, applied by the owning shard's worker or the
        commit thread's settle, fenced by the generations as
        ``update_priorities`` is."""
        dealer = self._dealer
        if dealer is None:
            raise RuntimeError("queue_writeback requires an attached "
                               "dealer (attach_dealer)")
        dealer.queue_writeback(idx, priorities, generation)

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

    def replay_state(self) -> dict:
        """The buffer's rows and PER state as host numpy (its
        ``state_dict``)."""
        with self._buffer_lock:
            return self.buffer.state_dict()

    def load_replay_state(self, d: dict) -> None:
        with self._buffer_lock:
            self.buffer.load_state_dict(d)

    def snapshot(self, quiesce_timeout: float = 10.0) -> dict:
        """The serving state at a quiesced cut (see the module docstring):
        ``buffer`` (a fused buffer's ``snapshot``, its staging drained
        into the cut; else ``state_dict``), ``next_seq``, ``env_steps``,
        ``rows_committed`` and ``generation``."""
        self.flush(timeout=quiesce_timeout)
        cut = getattr(self.buffer, "snapshot", self.buffer.state_dict)
        with self._buffer_lock:
            buf = cut()
        with self._commit_cond:
            next_seq = self._next_seq
        with self._lock:
            return {
                "schema": 1,
                "buffer": buf,
                "next_seq": next_seq,
                "env_steps": self._env_steps,
                "rows_committed": self._rows_committed,
                "generation": self._generation,
            }

    def restore(self, snap: dict) -> None:
        """Load a ``snapshot`` into this fresh (or quiesced) service: the
        buffer, the ticket floor (admission resumes above every committed
        ticket), the row ledger, and a generation past the snapshot's
        that never goes below this service's own."""
        if not isinstance(snap, dict) or "buffer" not in snap:
            raise ValueError("not a replay service snapshot (no buffer cut)")
        load = getattr(self.buffer, "restore", self.buffer.load_state_dict)
        with self._buffer_lock:
            load(snap["buffer"])
        floor = int(snap.get("next_seq", 0))
        with self._commit_cond:
            self._next_seq = floor
            self._seq = itertools.count(floor)
            self._skip.clear()
            for dq in self._out:
                dq.clear()
            self._commit_cond.notify_all()
        with self._lock:
            self._env_steps = int(snap.get("env_steps", 0))
            self._rows_committed = int(snap.get("rows_committed", 0))
            self._generation = max(self._generation,
                                   int(snap.get("generation", 0)) + 1)
        dealer = self._dealer
        if dealer is not None:
            # blocks dealt against the old state must not train; queued
            # write-backs die with the resync (the generation bump fences
            # them anyway)
            dealer.clear_rings()
            with self._buffer_lock:
                dealer.resync(self.buffer)

    def set_ingest_depth(self, capacity: int) -> None:
        """Resize every shard's admission deque live (the autoscaler's
        ``ingest_capacity`` actuator; at least 1). The shed watermark, when
        there is one, moves to the same fraction of the new capacity, so a
        deeper shard absorbs a crowd instead of shedding at the old bound.
        Each shard's condition is taken at top level in turn (nothing else
        held), and its blocked producers are woken: a deque that grew
        admits them. A snapshot taken mid-resize reports the smallest
        capacity (``ingest_stats``)."""
        cap = max(1, int(capacity))
        for s in self._shards:
            with s.cond:
                s.capacity = cap
                if s.shed_at is not None and self._shed_watermark is not None:
                    s.shed_at = max(
                        1, min(cap, int(self._shed_watermark * cap)))
                s.cond.notify_all()

    @property
    def dealer(self):
        """The attached sample-on-ingest dealer, or None."""
        return self._dealer

    @property
    def generation(self) -> int:
        """The service generation the transition receiver greets senders
        with (a restore moves it past the snapshot's)."""
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
        """Actors considered dead: heartbeat-stale ones and the evicted
        ones that have not come back (a heartbeat, or a streamed batch,
        re-admits an evicted actor)."""
        now = time.monotonic()
        with self._lock:
            stale = [a for a, t in self._heartbeats.items()
                     if now - t > self._heartbeat_timeout]
            return stale + [a for a in self._evicted if a not in stale]

    def evict_dead(self) -> list[str]:
        """Move heartbeat-stale actors into the evicted set (their next
        heartbeat re-admits them and records the outage). Returns the
        newly evicted ids; idempotent between actor state changes."""
        now = time.monotonic()
        with self._lock:
            stale = [a for a, t in self._heartbeats.items()
                     if now - t > self._heartbeat_timeout]
            for a in stale:
                del self._heartbeats[a]
                self._evicted[a] = now
                self.evictions += 1
        for a in stale:
            record_event("eviction", actor=a)
        return stale

    def evicted_actors(self) -> list[str]:
        with self._lock:
            return list(self._evicted)

    def ingest_stats(self) -> dict:
        """The ``ingest`` registry provider. Every counter is read under
        the lock that writes it: each shard's with its deque, the merge's
        under the commit condition, the rest under the service lock;
        totals are sums of per-shard-consistent snapshots."""
        per_shard = [s.snapshot() for s in self._shards]
        with self._commit_cond:
            commit_backlog = sum(len(dq) for dq in self._out)
            order_breaks = self.order_breaks
        with self._lock:
            merged = {
                "env_steps": self._env_steps,
                "rows_committed": self._rows_committed,
                "pending": self._pending,
                "evictions": self.evictions,
                "readmissions": self.readmissions,
                "recovery_s": list(self._recovery_s),
                "live_actors": len(self._heartbeats),
                "evicted": len(self._evicted),
                "generation": self._generation,
                "fenced_frames": self._fenced_frames,
                "fenced_rows": self._fenced_rows,
            }
        merged.update({
            "queue_depth": sum(p["queue_depth"] for p in per_shard),
            "sheds": sum(p["sheds"] for p in per_shard),
            "shed_rows": sum(p["shed_rows"] for p in per_shard),
            "decode_errors": sum(p["decode_errors"] for p in per_shard),
            "admit_fails": sum(p["admit_fails"] for p in per_shard),
            # rows shed or rejected per admission class; counts incoming
            # batches a policy rejected, so it can exceed shed_rows
            "sheds_by_class": _merge_class_counts(
                p["sheds_by_class"] for p in per_shard),
            # the live deque bound (the ingest_capacity actuator's target;
            # the smallest over the shards while a resize is under way)
            "ingest_capacity": min(p["capacity"] for p in per_shard),
            "num_ingest_shards": self.num_ingest_shards,
            "commit_backlog": commit_backlog,
            "order_breaks": order_breaks,
            "per_shard": per_shard,
        })
        return merged

    # -- ingest threads -----------------------------------------------------
    def _worker(self, s: _IngestShard) -> None:
        """Shard worker: pop a group, decode its wire payloads, direct-
        stage its rows when that path is on, and hand the group to the
        ordered merge. At most one group per shard waits in the merge's
        inbox, so decoding group t + 1 overlaps inserting group t while a
        slow commit still backs pressure up into the shard's deque."""
        try:
            self._worker_loop(s)
        except Exception as e:  # noqa: BLE001 — counted; flush() then times out
            print(f"ingest.shard_worker crashed:\n{traceback.format_exc()}",
                  flush=True)
            contained_crash("ingest.shard_worker", e)

    def _worker_loop(self, s: _IngestShard) -> None:
        while not self._stop.is_set():
            dealer = self._dealer
            if dealer is not None:
                # this shard's slices' write-back queues, at top level
                dealer.drain_writebacks_for_shard(s.idx)
            with self._commit_cond:
                while self._out[s.idx] and not self._stop.is_set():
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
            out, dead, dead_tids, staged = [], [], [], 0
            for seq, data, codec, actor_id, rows, count, trace in items:
                tid = trace[0] if trace is not None else None
                if codec is not None:
                    try:
                        actor_id, batch, count = decode_frame(data, codec)
                    except Exception:  # noqa: BLE001 — counted, tombstoned
                        dead.append(seq)
                        if tid is not None:
                            dead_tids.append(tid)
                        continue
                    rows = int(batch.obs.shape[0])
                    if tid is not None:
                        _tracer.record_span(tid, "decode")
                else:
                    batch = data
                if self._direct_stage:
                    # the rows land in this shard's staging ring here, on
                    # the worker; the commit only settles the accounting
                    self.buffer.add_sharded(batch, s.idx, ticket=seq)
                    staged += rows
                    batch = None
                if tid is not None:
                    _tracer.record_span(tid, "stage")
                out.append((seq, actor_id, batch, rows, count, tid))
            if dead or staged:
                with s.cond:
                    s.decode_errors += len(dead)
                    s.staged_rows += staged
            with self._commit_cond:
                self._out[s.idx].extend(out)
                if dead:
                    self._skip.update(dead)
                self._commit_cond.notify_all()
            if dead:
                if self._dealer is not None:
                    self._dealer.mark_dead_seqs(dead)
                record_event("decode_error", shard=s.idx, tickets=dead[:8],
                             n=len(dead))
                for tid in dead_tids:
                    _tracer.terminal_shed(tid)
                with self._lock:
                    self._pending -= len(dead)

    def _pop_ready(self, group: list, shed_tids: list) -> int:
        """Pop the next run of in-ticket-order items (the caller holds
        ``_commit_cond``), consuming tombstones. Returns the number of
        stale tickets dropped: one the order-break valve advanced past
        turns up later below the floor and would otherwise gate its
        shard's worker forever; the caller settles its accounting and
        sheds the traces collected into ``shed_tids``."""
        stale = 0
        stale_seqs: list[int] = []
        while len(group) < self._COALESCE:
            while self._next_seq in self._skip:
                self._skip.discard(self._next_seq)
                self._next_seq += 1
            found = None
            for dq in self._out:
                while dq and dq[0][0] < self._next_seq:
                    item = dq.popleft()
                    self.order_breaks += 1
                    stale += 1
                    stale_seqs.append(item[0])
                    if item[5] is not None:
                        shed_tids.append(item[5])
                if dq and dq[0][0] == self._next_seq:
                    found = dq.popleft()
                    break
            if found is None:
                break
            group.append(found)
            self._next_seq += 1
        if stale_seqs and self._dealer is not None:
            self._dealer.mark_dead_seqs(stale_seqs)
        return stale

    def _commit_loop(self) -> None:
        try:
            self._commit_run()
        except Exception as e:  # noqa: BLE001 — counted; flush() then times out
            print(f"ingest.commit crashed:\n{traceback.format_exc()}",
                  flush=True)
            contained_crash("ingest.commit", e)

    def _commit_run(self) -> None:
        """The single writer of replay state: the ordered K-way merge of
        the shard outputs, one buffer-lock acquisition per group."""
        last_progress = time.monotonic()
        while True:
            group: list = []
            shed_tids: list = []
            with self._commit_cond:
                stale = self._pop_ready(group, shed_tids)
                if not group:
                    if self._stop.is_set():
                        return
                    self._commit_cond.wait(timeout=0.1)
                    stale += self._pop_ready(group, shed_tids)
                if group or stale:
                    self._commit_cond.notify_all()  # wake gated workers
                backlog = any(self._out)
            for item in group:
                if item[5] is not None:
                    _tracer.record_span(item[5], "merge")
            if stale:
                record_event("order_break", kind_detail="stale_discard",
                             n=stale)
                for tid in shed_tids:
                    _tracer.terminal_shed(tid)
                with self._lock:
                    self._pending -= stale
            if group:
                last_progress = time.monotonic()
                self._insert_group(group)
            elif (backlog and time.monotonic() - last_progress
                    > _ORDER_GRACE_S):
                # the valve: a ticket vanished without a tombstone; skip
                # to the smallest ready one (counted) instead of wedging
                advanced = False
                with self._commit_cond:
                    heads = [dq[0][0] for dq in self._out if dq]
                    if heads and min(heads) > self._next_seq:
                        self.order_breaks += 1
                        advanced = True
                        self._next_seq = min(heads)
                        # tombstones below the new floor can never be
                        # consumed: prune them
                        self._skip = {t for t in self._skip
                                      if t >= self._next_seq}
                if advanced:
                    record_event("order_break", kind_detail="floor_advance")
                last_progress = time.monotonic()
            dealer = self._dealer
            if not group and dealer is not None:
                # the idle deal tick: settle write-backs and top the rings
                # up while ingest is quiet, in one buffer-lock window
                with self._buffer_lock:
                    dealt = dealer.ingest_and_deal((), self.buffer)
                if dealt:
                    dealer.publish(dealt)

    def _insert_group(self, group: list) -> None:
        dealer = self._dealer
        dealt: list = []
        try:
            if self.obs_norm is not None:
                # fold, then normalize, batch by batch in ticket order:
                # only obs feeds the estimator, next_obs is normalized
                # but never folded
                norm = self.obs_norm
                for j, (seq, aid, batch, rows, cnt, tid) in enumerate(group):
                    if batch is None:
                        continue
                    norm.update(batch.obs)
                    group[j] = (seq, aid, batch._replace(
                        obs=norm.normalize(batch.obs),
                        next_obs=norm.normalize(batch.next_obs)),
                        rows, cnt, tid)
            with self._buffer_lock:
                if dealer is None:
                    for _seq, _aid, batch, _rows, _cnt, _tid in group:
                        if batch is not None:  # None: direct-staged already
                            self.buffer.add(batch)
                else:
                    # insert, mirror, settle and draw in the one window
                    inserts = [(self.buffer.add(batch), seq, tid)
                               for seq, _aid, batch, _rows, _cnt, tid in group
                               if batch is not None]
                    dealt = dealer.ingest_and_deal(inserts, self.buffer)
        finally:
            committed = 0
            with self._lock:
                for _seq, aid, _batch, rows, count, _tid in group:
                    if count:
                        self._env_steps += rows
                    committed += rows
                    self._actor_rows[aid] = self._actor_rows.get(aid, 0) + rows
                self._rows_committed += committed
                self._pending -= len(group)
            # each row counts once, here, never at direct-stage time
            REGISTRY.counter("ingest.rows_committed").inc(committed)
            _tracer.mark_committed(
                [tid for *_rest, tid in group if tid is not None])
        if dealt:
            # ring pushes and deal spans after every service lock
            dealer.publish(dealt)

    def flush(self, timeout: float = 5.0) -> None:
        """Block until every accepted batch has been committed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return
            time.sleep(0.005)

    def close(self) -> None:
        """Flush, then stop the ingest threads (``kill``)."""
        self.flush()
        self.kill()

    def kill(self) -> None:
        """Stop the ingest threads without a flush, as a crash would:
        accepted batches not yet committed are lost, and the dealer is
        closed, whose closed rings wake any replica waiting on a pop.
        Safe to call twice."""
        REGISTRY.unregister_provider("ingest", self.ingest_stats)
        if self._dealer is not None:
            self._dealer.close()
        self._stop.set()
        for s in self._shards:
            with s.cond:
                s.cond.notify_all()
        with self._commit_cond:
            self._commit_cond.notify_all()
        for t in self._workers:
            t.join(timeout=2.0)
        self._commit_thread.join(timeout=2.0)
