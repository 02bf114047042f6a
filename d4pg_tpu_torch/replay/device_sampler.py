"""Device-resident PER sampling: the stratified descent run by the commit
thread on the card, right after the commit.

Counterpart of ``d4pg_tpu/replay/device_sampler.py``. The host dealer
(``replay/sampler.SampleDealer``) walks host trees and ships the sampled
rows through host memory. Here the sum and min trees are the card's,
the ones ``replay/fused_buffer.FusedDeviceReplay(gen_tracked=True)``
maintains, and dealt blocks are gathers on the card: no host tree math
and no host-to-device copy of sampled rows. Per ``ingest_and_deal`` tick
the commit thread, inside the buffer-lock window it already holds:

  1. mirrors the tick's inserts into the host bookkeeping (generation
     fence, ticket seqs, trace ids);
  2. ``buffer.drain()``: the commit lands the staged rows with their
     entry priority and bumps the device generation array;
  3. settles queued write-backs: fenced against the host generation
     mirror, ``priority ** alpha`` on the host in float64 cast to
     float32 (the twin's rounding), one ``set_leaves`` scatter into the
     card's trees (it keeps the last of duplicate slots, as numpy's
     fancy assignment in the twin does);
  4. draws: K x B unit uniforms from the dealer's seeded host stream
     (the only host-to-device bytes of a deal, copied from pinned memory
     without a host sync), then on the
     card the strata masses, ONE descent over the [K * B] flat queries,
     the row, leaf-priority and generation gathers, and the weights
     (``device_per.block_weights``, the function the twin calls).

``arm='pallas'`` descends with the CUDA kernel (``ops/sampler_descent.
descend``: one launch per deal, counted in ``descend.launches``; its
plain version for a tree on the CPU); ``arm='scan'`` with the plain
torch descent (``descend_plain``) on every device. ``'host'`` is the
plain ``SampleDealer``, built by the caller.

Bitwise oracle: with the same seed, inserts and write-backs, blocks equal
``SampleDealer(scheme='device')``'s in ``(idx, weights, beta, rows,
gen)``, the weights when the twin runs ``block_weights`` on this
dealer's device.

Streams and threads: the commit thread owns every device handle (the
ring, the trees, ``gen``); its deal runs on the card's default stream,
and so do the replicas that consume the blocks, so the card orders the
deal's gathers before the grad step that reads them and the next
commit's tree writes after it, with no event and no ``record_stream``
(the caching allocator reuses a freed block's memory only after the
stream's queued work). The replica's one host sync is its write-back
(``learner/loop.DealtLoop``). The ``deal`` span is stamped on the newest
committed insert's trace id, since the sampled slots never visit the
host (``audit=True`` copies them down once per deal for the dead-ticket
check; a chaos knob, off on the shipped path).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from d4pg_tpu_torch.ops.sampler_descent import descend, descend_plain
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.sampler import DealtBlock, SampleDealer
from d4pg_tpu_torch.replay.uniform import TransitionBatch

ARMS = ("scan", "pallas")


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev`` without a host sync: a blocking copy from pageable
    memory synchronizes the stream, which would hold the commit thread
    (and the buffer lock) until the replicas' queued steps finish. The
    pinned block stays reserved by the caching host allocator until the
    copy is done."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


class DeviceSampleDealer(SampleDealer):
    """``SampleDealer`` with the sample path on the buffer's device; the
    buffer must be a ``FusedDeviceReplay(gen_tracked=True)``. Write-backs
    settle on the commit thread's ticks, which own the device trees, so
    :meth:`drain_writebacks_for_shard` does nothing. The inherited host
    trees stay empty: the authoritative trees are the buffer's."""

    # the attached service's commit thread drains the staged rows inside
    # every ingest's lock window: no learner-side ingest overlap applies
    owns_commit = True

    def __init__(self, capacity: int, rings, *, k: int, batch_size: int,
                 alpha: float = 0.6, beta_schedule=None, min_size: int = 1,
                 seed: int = 0, ring_capacity: int = 4,
                 max_deals_per_tick: int = 1, audit: bool = False,
                 arm: str = "scan"):
        if arm not in ARMS:
            raise ValueError(f"unknown device sampler arm {arm!r} (want "
                             "'scan' or 'pallas'; 'host' is the plain "
                             "SampleDealer, built by the caller)")
        super().__init__(capacity, rings, n_shards=1, k=k,
                         batch_size=batch_size, alpha=alpha,
                         beta_schedule=beta_schedule, min_size=min_size,
                         seed=seed, ring_capacity=ring_capacity,
                         max_deals_per_tick=max_deals_per_tick,
                         audit=audit, scheme="device")
        self.arm = arm
        self._buffer = None

    def _descend(self, sum_tree: torch.Tensor,
                 mass: torch.Tensor) -> torch.Tensor:
        if self.arm == "pallas":
            # the K x B strata as one flat launch of Q = K * B queries
            return descend(sum_tree, mass.reshape(-1)).reshape(mass.shape)
        return descend_plain(sum_tree, mass)

    def deal(self, buffer, u: np.ndarray, size: int, beta: float):
        """The device half of one draw from unit uniforms ``u`` ([K, B]
        float32): ``(rows, idx, weights, gen)``, all on the buffer's
        device (``idx`` and ``gen`` int32)."""
        dev = buffer.device
        trees = buffer.trees
        treecap = trees.capacity
        total = trees.sum_tree[1]
        mass = dper.strata_mass(_to_device(u, dev), total)
        idx = torch.clamp(self._descend(trees.sum_tree, mass),
                          max=max(int(size) - 1, 0))
        rows_idx = idx.long()
        rows = TransitionBatch(*[a[rows_idx] for a in buffer.storage])
        leaf_p = trees.sum_tree[treecap + rows_idx]
        weights = dper.block_weights(total, trees.min_tree[1], leaf_p, beta,
                                     size)
        return rows, idx, weights, buffer.gen[rows_idx]

    # -- commit-thread hooks (sampler lock held, buffer lock above it) ------
    def _apply_insert_locked(self, idx: np.ndarray) -> None:
        # entry priorities land in the device trees through the commit
        pass

    def _post_ingest_locked(self, buffer) -> None:
        self._buffer = buffer
        # land every staged row now, in the adds' lock window: slot
        # pre-assignment order is commit order
        buffer.drain()

    def _settle_locked(self, owner: int | None = None) -> None:
        buffer = self._buffer
        if buffer is None or self._wb_depth == 0:
            return
        idx_parts, pri_parts = [], []
        for q in self._wb:
            while q:
                idx, pri, gen, t_enq = q.popleft()
                self._wb_depth -= 1
                self._wb_lag.observe(1e3 * (time.monotonic() - t_enq))
                live = self._gen[idx] == gen
                if not live.all():
                    # _settle_locked runs under the sampler lock that
                    # SampleDealer.ingest_and_deal holds
                    self.writeback_dropped_stale += int((~live).sum())  # jaxlint: guarded-by=_sampler_lock
                    idx, pri = idx[live], pri[live]
                if len(idx):
                    idx_parts.append(idx)
                    pri_parts.append(pri)
        if not idx_parts:
            return
        idx = np.concatenate(idx_parts)
        pri = np.concatenate(pri_parts)
        # host float64 pow, float32 cast: the twin's trees.set rounding;
        # set_leaves keeps the last of duplicate slots (queue order)
        p_alpha = (pri ** self.alpha).astype(np.float32)
        dev = buffer.device
        buffer.apply_priorities(_to_device(idx, dev), _to_device(p_alpha, dev))
        self.max_priority = max(self.max_priority, float(pri.max()))
        # the buffer's host scalar feeds the next commit's entry priority
        buffer.max_priority = self.max_priority

    def _draw_block_locked(self, buffer):
        # priorities are positive on this plane (entry priorities, and
        # write-backs refuse others), so size > 0 means total > 0: the
        # host guard needs no device read
        size = self._size
        if size <= 0:
            return None
        t = self._beta.current_step()
        beta = self._beta.beta_at(t)
        # K * B doubles off the seeded stream, cast float32: the count and
        # values K twin strata draws consume
        u = self._rng.uniform(0.0, 1.0, (self.k, self.batch_size)).astype(
            np.float32)
        rows, idx, w, gen_blk = self.deal(buffer, u, size, beta)
        if self._audit and self._dead:
            flat = idx.cpu().numpy().ravel()
            hits = {int(s) for s in self._src_seq[flat]} & self._dead
            # _draw_block_locked runs under the sampler lock that
            # SampleDealer.ingest_and_deal holds
            self.dealt_dead_tickets += len(hits)  # jaxlint: guarded-by=_sampler_lock
        tid = self._last_tid  # the newest committed insert
        self._beta.advance(self.k)
        self._deal_seq += 1
        self.dealt_blocks += 1  # jaxlint: guarded-by=_sampler_lock
        self.dealt_rows += self.k * self.batch_size  # jaxlint: guarded-by=_sampler_lock
        return DealtBlock(rows, w, idx, gen_blk, beta, t, tid,
                          self._deal_seq)

    def drain_writebacks_for_shard(self, shard_idx: int) -> None:
        """Nothing: device tree writes belong to the commit thread, whose
        commit and idle ticks settle the queue."""

    def resync(self, buffer) -> None:
        """Adopt ``buffer``'s device PER state (attach): the trees stay in
        the buffer, only the host mirrors are re-derived."""
        if not getattr(buffer, "gen_tracked", False):
            raise ValueError(
                "DeviceSampleDealer needs a FusedDeviceReplay(gen_tracked="
                "True) buffer: the deal reads its device trees and "
                "generation array")
        with self._sampler_lock:
            self._buffer = buffer
            self._size = int(buffer.size)
            self.max_priority = float(buffer.max_priority)
            self._gen = np.asarray(buffer.generation).copy()
            self._src_seq.fill(-1)
            self._tid_of.fill(0)
            self._ins_seq.fill(0)
            self._last_tid = 0
            for q in self._wb:
                q.clear()
            self._wb_depth = 0
