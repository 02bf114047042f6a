"""Sample-on-ingest: PER sampling dealt by the replay service's commit
thread.

Counterpart of ``d4pg_tpu/replay/sampler.py``. The host-sampled learner
takes the buffer lock to walk the sum tree, gather rows and compute IS
weights, and under N replicas those walks contend. Here the commit
thread, which already holds the buffer lock for every insert, also draws:

  - :class:`ShardSlicePerTrees` keeps the PER sum and min trees as S
    contiguous per-shard slices plus a small top tree over the slice
    roots. Its nodes are those of one flat tree over the capacity (same
    operands, same pairwise bracketing), so totals, minima and the
    inverse-CDF descent are bitwise those of ``segment_tree.SumTree``;
    ``backend='auto'`` backs the whole structure with one flat
    ``native.NativePerTrees`` when the C++ library builds (bitwise the
    numpy trees), because the draw runs inside the commit's lock window.
  - :class:`SampleDealer`, inside that window, mirrors each insert into
    its trees, settles the queued priority write-backs, and deals
    ready-to-train blocks (rows, IS weights, slots, sample-time
    generations) from its own seeded stream into bounded per-replica
    rings (``staging.DealtBlockRing``), pushed after every lock is
    released.
  - Replicas write priorities back through a generation-fenced queue
    under the ``sampler`` tier alone: the replica's sample path takes no
    buffer lock. Each ingest shard's worker drains the queues of its own
    slices, so every tree write keeps one writer.

Determinism (the bitwise oracle of the tests): with the same seed, the
same inserts and the same write-backs, the dealer's blocks (slots,
weights, dtypes) equal the host path's ``buffer.add`` +
``update_priorities`` + ``sample_chunk``. A draw that cannot be dealt
(ring full, paused, warm-up) is skipped before it touches the generator,
so backpressure never shifts the stream.

``scheme='device'`` is the float32 host twin of
``replay/device_sampler.DeviceSampleDealer``: float32 trees, the device's
stratification from unit uniforms, and the one weight function both call
(``device_per.block_weights``, run on ``weights_device``, the CPU by
default). With the same seed its blocks are the device dealer's, bit for
bit, weights included when both run the weights on one device.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from d4pg_tpu_torch.core.locking import TieredLock
from d4pg_tpu_torch.obs import trace as obs_trace
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
from d4pg_tpu_torch.replay.segment_tree import next_pow2

# dead (shed, tombstoned, fenced) ticket seqs remembered for the audit
# cross-check; past the bound the oldest are forgotten
_DEAD_SEQ_BOUND = 4096


class ShardSlicePerTrees:
    """PER sum and min trees partitioned into per-shard slices of the slot
    space, merged by a top tree over the slice roots.

    Slots ``[0, capacity)`` (capacity rounded up to a power of two) split
    into ``n_slices`` (rounded likewise, at most the capacity) contiguous
    slices of ``slice_cap`` leaves; slice ``j`` covers slots ``[j *
    slice_cap, (j + 1) * slice_cap)``. ``dtype`` float64 (the host
    dealer) or float32 (the device twin: numpy's float32 add, subtract and
    compare round as the device trees' do; the native backing is float64
    only and is bypassed)."""

    def __init__(self, capacity: int, n_slices: int,
                 backend: str = "auto", dtype=np.float64):
        self.capacity = next_pow2(int(capacity))
        self.n_slices = min(next_pow2(max(1, int(n_slices))), self.capacity)
        self.slice_cap = self.capacity // self.n_slices
        self._top_levels = int(np.log2(self.n_slices))
        self._slice_levels = int(np.log2(self.slice_cap))
        self._stride = 2 * self.slice_cap
        if backend not in ("auto", "numpy"):
            raise ValueError(f"unknown ShardSlicePerTrees backend "
                             f"{backend!r} (want 'auto' or 'numpy')")
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float64), np.dtype(np.float32)):
            raise ValueError("ShardSlicePerTrees dtype must be float64 "
                             f"or float32, got {self.dtype}")
        self._native_cls = None
        if backend == "auto" and self.dtype == np.float64:
            from d4pg_tpu_torch.replay.native import NativePerTrees, library

            try:
                library()
                self._native_cls = NativePerTrees
            except (RuntimeError, OSError):
                self._native_cls = None  # numpy slices: the same bits
        self._native = None
        self.backend = "native" if self._native_cls else "numpy"
        self.reset()

    def reset(self) -> None:
        if self._native_cls is not None:
            # a fresh native tree is the empty state
            self._native = self._native_cls(self.capacity)
            return
        s = self.n_slices
        self._sum = np.zeros((s, self._stride), self.dtype)
        self._min = np.full((s, self._stride), np.inf, self.dtype)
        self._top = np.zeros(2 * s, self.dtype)
        self._top_min = np.full(2 * s, np.inf, self.dtype)

    def set(self, idx: np.ndarray, values: np.ndarray) -> None:
        """Batched leaf assignment (last wins on duplicates) and repair of
        the ancestors in each touched slice, then of the top tree."""
        if self._native is not None:
            self._native.set(idx, values)
            return
        idx = np.asarray(idx, np.int64).ravel()
        values = np.asarray(values, self.dtype).ravel()
        sl = idx // self.slice_cap
        node = (idx % self.slice_cap) + self.slice_cap
        self._sum[sl, node] = values
        self._min[sl, node] = values
        # unique (slice, parent) keys: leaves share one depth, so one
        # halving per pass repairs one level in every slice
        comb = np.unique(sl * self._stride + (node >> 1))
        while True:
            sp, p = comb // self._stride, comb % self._stride
            if p[0] < 1:
                break
            left = p << 1
            self._sum[sp, p] = np.add(self._sum[sp, left],
                                      self._sum[sp, left | 1])
            self._min[sp, p] = np.minimum(self._min[sp, left],
                                          self._min[sp, left | 1])
            if p[0] == 1:
                break
            comb = np.unique(sp * self._stride + (p >> 1))
        touched = np.unique(sl)
        self._top[self.n_slices + touched] = self._sum[touched, 1]
        self._top_min[self.n_slices + touched] = self._min[touched, 1]
        parent = np.unique((self.n_slices + touched) >> 1)
        while parent[0] >= 1:
            left = parent << 1
            self._top[parent] = np.add(self._top[left], self._top[left | 1])
            self._top_min[parent] = np.minimum(self._top_min[left],
                                               self._top_min[left | 1])
            parent = np.unique(parent >> 1)
            if parent[0] == 0:
                break

    def get(self, idx: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native.get(np.asarray(idx, np.int64))
        idx = np.asarray(idx, np.int64)
        return self._sum[idx // self.slice_cap,
                         (idx % self.slice_cap) + self.slice_cap]

    def total(self) -> float:
        if self._native is not None:
            return self._native.sum()
        return float(self._top[1])

    def min(self) -> float:
        if self._native is not None:
            return self._native.min()
        return float(self._top_min[1])

    def find_prefixsum(self, prefix: np.ndarray) -> np.ndarray:
        """Batched inverse CDF in two lock-step phases: log2(S) levels of
        the top tree pick the slice, log2(slice_cap) levels of the slice
        trees pick the leaf; each level is ``SumTree.find_prefixsum``'s
        compare and subtract over the same node values, in the trees'
        dtype."""
        if self._native is not None:
            return self._native.find_prefixsum(prefix)
        p = np.asarray(prefix, self.dtype).copy()
        node = np.ones_like(p, dtype=np.int64)
        for _ in range(self._top_levels):
            left = node << 1
            left_sum = self._top[left]
            go_right = p >= left_sum
            p = np.where(go_right, p - left_sum, p)
            node = np.where(go_right, left | 1, left)
        sl = node - self.n_slices
        node = np.ones_like(p, dtype=np.int64)
        for _ in range(self._slice_levels):
            left = node << 1
            left_sum = self._sum[sl, left]
            go_right = p >= left_sum
            p = np.where(go_right, p - left_sum, p)
            node = np.where(go_right, left | 1, left)
        return sl * self.slice_cap + (node - self.slice_cap)


class DealtBlock(NamedTuple):
    """One ready-to-train unit: K stacked proportional samples with their
    IS weights, slots and sample-time generations (the write-back fence),
    the anneal step and beta they were weighted at, and the trace id of
    the newest constituent frame (the ``deal`` span's parent). Host
    dealers deal numpy arrays; the device dealer deals tensors on its
    card."""

    batches: object  # TransitionBatch, [K, B, ...]
    weights: object  # [K, B] float32
    idx: object  # [K, B] int64 (host) or int32 (device)
    gen: object  # [K, B] int64 (host) or int32 (device)
    beta: float
    step: int
    tid: int  # 0 when no constituent frame was traced
    deal_seq: int


class SampleDealer:
    """The commit thread's block dealer.

    One writer: the trees, the generation mirror, ``max_priority``, the
    generator and the write-back queues all live under one
    ``sampler``-tier lock. The commit thread takes it while holding the
    buffer lock (``ingest_and_deal``; buffer -> sampler descends), shard
    workers at top level (``drain_writebacks_for_shard``); replicas only
    enqueue write-backs under it.

    ``ingest_and_deal`` is called with the buffer lock held (it reads
    ``buffer.size`` and gathers rows); ``publish`` after every lock is
    released (it takes ring locks and stamps the ``deal`` span)."""

    def __init__(self, capacity: int, rings, *, n_shards: int, k: int,
                 batch_size: int, alpha: float = 0.6,
                 beta_schedule: SharedBetaSchedule | None = None,
                 min_size: int = 1, seed: int = 0, ring_capacity: int = 4,
                 max_deals_per_tick: int = 1, audit: bool = False,
                 scheme: str = "legacy",
                 weights_device: str | torch.device = "cpu"):
        if scheme not in ("legacy", "device"):
            raise ValueError(f"unknown SampleDealer scheme {scheme!r} "
                             "(want 'legacy' or 'device')")
        self.scheme = scheme
        self.weights_device = torch.device(weights_device)
        self._sampler_lock = TieredLock("sampler")
        self._trees = ShardSlicePerTrees(
            capacity, n_shards,
            dtype=np.float32 if scheme == "device" else np.float64)
        self._n_shards = max(1, int(n_shards))
        self._rings = list(rings)
        self.k = int(k)
        self.batch_size = int(batch_size)
        self.alpha = float(alpha)
        self.min_size = max(1, int(min_size))
        self.ring_capacity = int(ring_capacity)
        # deals per tick and ring: the dealer runs inside the commit's
        # buffer-lock window, so one block per tick bounds how far a deal
        # stretches a commit; the ring's depth absorbs the cadences
        self.max_deals_per_tick = max(1, int(max_deals_per_tick))
        self._beta = beta_schedule or SharedBetaSchedule()
        # the buffer's generator construction: with the buffer's seed the
        # dealer draws the stream a host sample_chunk loop would, so the
        # stream's identity is owned by the buffer, not the dealer
        self._rng = np.random.default_rng(seed)  # jaxlint: stream-owner=ReplayBuffer._rng
        cap = self._trees.capacity
        self.max_priority = 1.0
        self._size = 0
        # slot generations: every access after construction holds the
        # sampler lock (ingest, deal, settle, resync)
        self._gen = np.zeros(cap, np.int64)  # jaxlint: guarded-by=_sampler_lock
        self._src_seq = np.full(cap, -1, np.int64)
        self._tid_of = np.zeros(cap, np.uint64)  # u64 trace ids
        self._ins_seq = np.zeros(cap, np.int64)
        self._ins_counter = 0
        self._last_tid = 0  # the newest insert's trace id
        self._wb = [deque() for _ in range(self._trees.n_slices)]
        self._wb_depth = 0
        self._wb_lag = REGISTRY.histogram("sampler.writeback_lag_ms")
        self._paused = False
        self._audit = bool(audit)
        self._dead: set = set()
        self._dead_fifo: deque = deque()
        self._deal_seq = 0
        self.dealt_blocks = 0
        self.dealt_rows = 0
        self.deals_skipped_full = 0
        self.deals_dropped = 0
        self.writeback_dropped_stale = 0
        self.dealt_dead_tickets = 0
        self.deal_busy_s = 0.0
        REGISTRY.register_provider("sampler", self.sampler_stats)

    @property
    def rings(self):
        """The per-replica rings, replica-indexed."""
        return tuple(self._rings)

    def set_pacing(self, max_deals_per_tick: int) -> None:
        """Adjust the per-tick deal budget live."""
        with self._sampler_lock:
            self.max_deals_per_tick = max(1, int(max_deals_per_tick))

    # -- commit-thread side (buffer lock held) ------------------------------
    def ingest_and_deal(self, inserts, buffer) -> list:
        """Mirror a commit's inserts ``[(slots, seq, tid)]``, settle the
        queued write-backs, then deal up to ``max_deals_per_tick`` blocks
        into every ring with room. The caller holds the buffer lock.
        Returns ``[(ring index, DealtBlock)]`` for :meth:`publish`. An
        empty ``inserts`` is the idle top-up tick."""
        t0 = time.monotonic()
        dealt: list = []
        with self._sampler_lock:
            for idx, seq, tid in inserts:
                idx = np.asarray(idx, np.int64)
                self._gen[idx] += 1
                self._src_seq[idx] = -1 if seq is None else int(seq)
                self._tid_of[idx] = 0 if tid is None else int(tid)
                self._ins_counter += 1
                self._ins_seq[idx] = self._ins_counter
                if tid:
                    self._last_tid = int(tid)
                self._apply_insert_locked(idx)
            self._post_ingest_locked(buffer)
            self._size = int(buffer.size)
            # settle, then draw, in one critical section: every draw sees
            # the write-backs queued before this tick (the host path's
            # update_priorities -> sample_chunk order)
            self._settle_locked()
            if not self._paused and self._size >= self.min_size:
                for ri, ring in enumerate(self._rings):
                    room = ring.room()
                    if room == 0:
                        # skipped before any draw: backpressure must not
                        # shift the stream (an idle tick skips silently)
                        if inserts:
                            self.deals_skipped_full += 1
                        continue
                    for _ in range(min(room, self.max_deals_per_tick)):
                        blk = self._draw_block_locked(buffer)
                        if blk is None:
                            break
                        dealt.append((ri, blk))
            self.deal_busy_s += time.monotonic() - t0
        return dealt

    def _apply_insert_locked(self, idx: np.ndarray) -> None:
        """Land one insert's entry priorities in the trees this dealer
        reads: the host dealer mirrors them into its slice trees."""
        p = self.max_priority ** self.alpha
        self._trees.set(idx, np.full(len(idx), p))

    def _post_ingest_locked(self, buffer) -> None:
        """Hook between the insert mirror and the settle (the device
        dealer lands the staged rows on the device here)."""

    def publish(self, dealt) -> None:
        """Push dealt blocks into their rings and stamp each block's
        ``deal`` span. Called with no lock held; a push can only fail for
        a ring closed meanwhile (room was reserved under the sampler lock
        and only this thread pushes)."""
        for ri, blk in dealt:
            if blk.tid:
                obs_trace.RECORDER.record_span(blk.tid, "deal")
            if not self._rings[ri].offer(blk):
                with self._sampler_lock:
                    self.deals_dropped += 1

    def _draw_block_locked(self, buffer):
        """One K-chunk draw, bitwise the host path's ``weight_base`` +
        ``sample_chunk`` over the merged trees."""
        total = self._trees.total()
        if total <= 0.0:
            return None
        size = self._size
        t = self._beta.current_step()
        beta = self._beta.beta_at(t)
        idx = np.stack([self._sample_idx_locked(size) for _ in range(self.k)])
        if self.scheme == "device":
            dev = self.weights_device
            w = block_weights_on(
                dev, np.float32(total), np.float32(self._trees.min()),
                self._trees.get(idx).astype(np.float32), beta, size)
        else:
            # PrioritizedReplayBuffer.weight_base and is_weights
            z = self._trees.min() / total * size
            max_weight = z ** (-beta)
            w = np.stack([((self._trees.get(idx[i]) / total * size)
                           ** (-beta) / max_weight).astype(np.float32)
                          for i in range(self.k)])
        gen = self._gen[idx].copy()
        if self._audit and self._dead:
            hits = {int(s) for s in self._src_seq[idx.ravel()]} & self._dead
            self.dealt_dead_tickets += len(hits)
        flat = idx.ravel()
        tid = int(self._tid_of[flat[int(np.argmax(self._ins_seq[flat]))]])
        self._beta.advance(self.k)
        self._deal_seq += 1
        self.dealt_blocks += 1
        self.dealt_rows += self.k * self.batch_size
        return DealtBlock(buffer.gather(idx), w, idx, gen,
                          beta, t, tid, self._deal_seq)

    def _sample_idx_locked(self, size: int) -> np.ndarray:
        if self.scheme == "device":
            # the device stratification from unit uniforms, float32 end to
            # end (device_per.strata_mass); B doubles of the stream, as
            # the legacy draw
            b = self.batch_size
            u = self._rng.uniform(0.0, 1.0, b).astype(np.float32)
            total = np.float32(self._trees.total())
            mass = (np.arange(b, dtype=np.float32) + u) * (
                total / np.float32(b))
            idx = self._trees.find_prefixsum(mass)
            return np.minimum(idx, max(size - 1, 0))
        # PrioritizedReplayBuffer.sample_idx, stratified
        total = self._trees.total()
        bounds = np.linspace(0.0, total, self.batch_size + 1)
        mass = self._rng.uniform(bounds[:-1], bounds[1:])
        idx = self._trees.find_prefixsum(mass)
        return np.minimum(idx, max(size - 1, 0))

    # -- replica side (sampler tier only, never the buffer lock) -------------
    def queue_writeback(self, idx, priorities, generation) -> None:
        """Queue a grad step's TD priorities for the owning shards: raw
        priorities travel, ``** alpha`` happens at the one writer, and the
        generations fence them at settle time."""
        idx = np.asarray(idx, np.int64).ravel()
        pri = np.asarray(priorities, np.float64).ravel()
        if not (pri > 0).all():
            raise ValueError("priorities must be positive")
        gen = np.asarray(generation, np.int64).ravel()
        now = time.monotonic()
        sl = idx // self._trees.slice_cap
        with self._sampler_lock:
            for j in np.unique(sl):
                m = sl == j
                self._wb[j].append((idx[m], pri[m], gen[m], now))
                self._wb_depth += 1

    # -- shard-worker side --------------------------------------------------
    def drain_writebacks_for_shard(self, shard_idx: int) -> None:
        """Settle the queues of the slices shard ``shard_idx`` owns (slice
        j belongs to shard j mod n_shards), at top level on that shard's
        worker. Near free when idle (an unlocked depth probe)."""
        if self._wb_depth == 0:
            return
        with self._sampler_lock:
            self._settle_locked(owner=int(shard_idx) % self._n_shards)

    def _settle_locked(self, owner: int | None = None) -> None:
        for j, q in enumerate(self._wb):
            if owner is not None and j % self._n_shards != owner:
                continue
            while q:
                idx, pri, gen, t_enq = q.popleft()
                self._wb_depth -= 1
                self._wb_lag.observe(1e3 * (time.monotonic() - t_enq))
                live = self._gen[idx] == gen
                if not live.all():
                    self.writeback_dropped_stale += int((~live).sum())
                    idx, pri = idx[live], pri[live]
                if len(idx) == 0:
                    continue
                # PrioritizedReplayBuffer.update_priorities
                self._trees.set(idx, pri ** self.alpha)
                self.max_priority = max(self.max_priority, float(pri.max()))

    # -- lifecycle ----------------------------------------------------------
    def mark_dead_seqs(self, seqs) -> None:
        """Record shed, tombstoned or fenced ticket seqs for the audit
        cross-check (``dealt_dead_tickets`` must stay 0)."""
        if not self._audit:
            return
        with self._sampler_lock:
            for s in seqs:
                s = int(s)
                if s in self._dead:
                    continue
                self._dead.add(s)
                self._dead_fifo.append(s)
                while len(self._dead_fifo) > _DEAD_SEQ_BOUND:
                    self._dead.discard(self._dead_fifo.popleft())

    def clear_rings(self) -> int:
        """Drop every queued block (a restore: blocks dealt against the
        state before it must not train); returns how many. Ring locks
        only, never under the sampler tier."""
        return sum(r.clear() for r in self._rings)

    def pause_dealing(self) -> None:
        """Stop drawing (inserts and settles go on). No draw, no use of
        the generator: the oracles run a dealer in lockstep this way."""
        with self._sampler_lock:
            self._paused = True

    def resume_dealing(self) -> None:
        with self._sampler_lock:
            self._paused = False

    def resync(self, buffer) -> None:
        """Re-derive the PER state from ``buffer`` (attach). The caller
        holds the buffer lock; queued write-backs are dropped."""
        with self._sampler_lock:
            self._trees.reset()
            self._size = int(buffer.size)
            self.max_priority = float(buffer.max_priority)
            self._gen = np.asarray(buffer.generation).copy()
            self._src_seq.fill(-1)
            self._tid_of.fill(0)
            self._ins_seq.fill(0)
            self._last_tid = 0
            if self._size:
                live = np.arange(self._size)
                # the leaves hold priority ** alpha already
                self._trees.set(live, np.asarray(buffer._trees.get(live)))
            for q in self._wb:
                q.clear()
            self._wb_depth = 0

    def sampler_stats(self) -> dict:
        """The ``sampler`` registry provider."""
        with self._sampler_lock:
            d = {
                "dealt_blocks": self.dealt_blocks,
                "dealt_rows": self.dealt_rows,
                "dealer_queue_depth": self._wb_depth,
                "deals_skipped_full": self.deals_skipped_full,
                "deals_dropped": self.deals_dropped,
                "writeback_dropped_stale": self.writeback_dropped_stale,
                "dealt_dead_tickets": self.dealt_dead_tickets,
                "deal_busy_s": self.deal_busy_s,
                "paused": self._paused,
                "size": self._size,
                "max_priority": self.max_priority,
                "n_slices": self._trees.n_slices,
            }
        d["writeback_lag_ms"] = self._wb_lag.snapshot_dict()
        d["ring_depths"] = [r.depth() for r in self._rings]
        d["ring_capacity"] = self.ring_capacity
        return d

    def close(self) -> None:
        REGISTRY.unregister_provider("sampler", self.sampler_stats)
        for r in self._rings:
            r.close()


def block_weights_on(device, total, min_root, leaf_p, beta: float,
                     size: int) -> np.ndarray:
    """``device_per.block_weights`` of host scalars and leaf priorities,
    run on ``device``; the float32 weights come back as numpy."""
    from d4pg_tpu_torch.replay import device_per as dper

    dev = torch.device(device)
    w = dper.block_weights(
        torch.full((), float(total), dtype=torch.float32, device=dev),
        torch.full((), float(min_root), dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(leaf_p, np.float32), device=dev),
        beta, size)
    return w.cpu().numpy()
