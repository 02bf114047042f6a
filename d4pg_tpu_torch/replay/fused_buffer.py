"""Replay buffer for the fused device path: ring + PER trees on the card.

Counterpart of ``d4pg_tpu/replay/fused_buffer.py`` at one ingest shard,
without generation tracking. ``add`` (any thread, under the service's
buffer lock) only copies host rows into a preallocated column-major
staging ring; every device write happens on the learner thread, which
owns the ring and the trees. A block moves in two calls:

  - ``stage_block()`` copies the next pending frame (at most
    ``block_rows`` rows) out of the staging ring into a dedicated block
    (pinned host memory when the buffer is on the card) and starts ONE
    ``non_blocking`` host-to-device copy of it on a side stream, then
    records an event after it;
  - ``commit_staged()`` makes the learner's stream wait on that event,
    then writes the block into the ring (``device_ring.block_write``)
    and, with ``prioritized=True``, inserts it into the PER trees at
    ``max_priority ** alpha``.

The dedicated block is there because ``HostStagingRing.frame()`` returns
views into a ring that ``push`` overwrites once the rows are popped: an
asynchronous copy straight from those views could land rows a later push
has already written. The in-flight depth is one block, so one pinned
block serves; before refilling it, ``stage_block`` waits for the copy
that read it (long done by then), and the side stream waits for the
commit that last read the device block. ``drain`` is stage + commit per
block until the staging ring is empty (cycle boundaries); the learner's
per-chunk schedule (``learner/pipeline.IngestOverlap``) interleaves the
two calls with the chunks so the copy rides under a chunk's compute.
The ring and trees a sequence of adds leaves are bitwise those of the
synchronous drain, whatever ``add`` does while a block is in flight.
The unified registry counts ``fused.rows_staged``,
``fused.rows_committed`` and ``fused.blocks_committed``.
"""

from __future__ import annotations

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_ring import DeviceStore
from d4pg_tpu_torch.replay.uniform import TransitionBatch


class HostStagingRing:
    """Preallocated column-major host staging for fixed-size block frames.

    One buffer per transition field, ``n_blocks * block_rows`` rows; when
    producers outrun the drains by more than that, the oldest staged rows
    are dropped (they would be overwritten by the next drains anyway)."""

    def __init__(self, specs, block_rows: int, n_blocks: int):
        self.block_rows = int(block_rows)
        self.size = self.block_rows * max(2, int(n_blocks))
        self._arrays = [np.zeros((self.size, *shape), np.float32)
                        for shape in specs]
        self._r = 0  # absolute rows consumed
        self._w = 0  # absolute rows written

    def __len__(self) -> int:
        return self._w - self._r

    def push(self, batch: TransitionBatch) -> None:
        n = np.asarray(batch.obs).shape[0]
        if n > self.size:  # keep only the newest ring-full
            batch = TransitionBatch(*[np.asarray(v)[-self.size:]
                                      for v in batch])
            n = self.size
        off = self._w % self.size
        first = min(n, self.size - off)
        for dst, src in zip(self._arrays, batch):
            src = np.asarray(src, np.float32)
            dst[off:off + first] = src[:first]
            dst[:n - first] = src[first:]
        self._w += n
        self._r = max(self._r, self._w - self.size)  # drop oldest

    def frame(self) -> tuple[TransitionBatch, int]:
        """The next pending rows as contiguous views (at most one block,
        capped at the ring boundary) and their count (0 when empty)."""
        off = self._r % self.size
        n = min(len(self), self.block_rows, self.size - off)
        return TransitionBatch(*[a[off:off + n] for a in self._arrays]), n

    def pop(self, n: int) -> None:
        self._r += n

    def take(self, n: int) -> list[TransitionBatch]:
        """Pop the ``n`` oldest staged rows as one or two per-field view
        batches (two when the run wraps the ring boundary). Zero-copy: the
        views hold only until the writer laps the ring."""
        n = min(n, len(self))
        if n <= 0:
            return []
        off = self._r % self.size
        first = min(n, self.size - off)
        out = [TransitionBatch(*[a[off:off + first] for a in self._arrays])]
        if first < n:
            out.append(TransitionBatch(*[a[:n - first]
                                         for a in self._arrays]))
        self._r += n
        return out


class FusedDeviceReplay:
    """Fixed-capacity device ring + (``prioritized``) device PER trees;
    ``trees`` is ``None`` for uniform replay."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int,
                 alpha: float = 0.6, prioritized: bool = True,
                 device: str | torch.device | None = None,
                 block_rows: int | None = None, staging_blocks: int = 8,
                 ingest_shards: int = 1):
        if int(ingest_shards) != 1:
            raise NotImplementedError(
                f"ingest_shards={ingest_shards}: the sharded ingest plane "
                "(per-shard staging rings and their ordered merge) is not "
                "ported yet (ROADMAP Queue 1 item 12); use 1")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.block_rows = int(block_rows if block_rows is not None
                              else min(4096, self.capacity))
        self._store = DeviceStore(self.capacity, obs_dim, act_dim,
                                  self.device, self.block_rows)
        self.prioritized = bool(prioritized)
        self.trees = (dper.init(self.capacity, self.device)
                      if self.prioritized else None)
        self.size = 0
        self.head = 0
        n_blocks = min(int(staging_blocks),
                       -(-self.capacity // self.block_rows))
        specs = [(obs_dim,), (act_dim,), (), (obs_dim,), (), ()]
        self._staging = HostStagingRing(specs, self.block_rows, n_blocks)
        pin = self.device.type == "cuda"
        # the one in-flight block: host side (pinned on the card) and its
        # device twin, both allocated once
        self._host_block = TransitionBatch(*[
            torch.zeros((self.block_rows, *shape), dtype=torch.float32,
                        pin_memory=pin) for shape in specs])
        self._dev_block = (TransitionBatch(*[
            torch.zeros((self.block_rows, *shape), dtype=torch.float32,
                        device=self.device) for shape in specs])
            if pin else self._host_block)
        self._copy_stream = torch.cuda.Stream(self.device) if pin else None
        self._copied = None  # event: the H2D copy of the block is done
        self._consumed = None  # event: the last commit has read the block
        self._inflight = 0  # rows of the staged, uncommitted block

    def add(self, batch: TransitionBatch) -> None:
        """Stage host rows (numpy arrays); no device work."""
        if np.asarray(batch.obs).shape[0]:
            self._staging.push(batch)

    def __len__(self) -> int:
        # staged and in-flight rows count toward warm-up: they land before
        # the next chunk
        return min(self.size + len(self._staging) + self._inflight,
                   self.capacity)

    @property
    def storage(self) -> TransitionBatch:
        return self._store.arrays

    def stage_block(self) -> int:
        """Copy the next pending frame into the dedicated block and start
        its host-to-device copy (see the module docstring). No-op while a
        block is in flight (the depth is one). Returns rows staged."""
        if self._inflight:
            return 0
        frame, n = self._staging.frame()
        if n == 0:
            return 0
        if self._copied is not None:
            self._copied.synchronize()  # the pinned block is free again
        for dst, src in zip(self._host_block, frame):
            dst[:n].numpy()[...] = src
        self._staging.pop(n)
        if self._copy_stream is not None:
            if self._consumed is not None:
                self._copy_stream.wait_event(self._consumed)
            with torch.cuda.stream(self._copy_stream):
                for dst, src in zip(self._dev_block, self._host_block):
                    dst[:n].copy_(src[:n], non_blocking=True)
                self._copied = torch.cuda.Event()
                self._copied.record(self._copy_stream)
        self._inflight = n
        REGISTRY.counter("fused.rows_staged").inc(n)
        return n

    def commit_staged(self) -> int:
        """Land the staged block: ring write, then (PER) tree insert, on
        the learner's stream after the block's copy. Learner thread only.
        Returns rows committed."""
        n = self._inflight
        if not n:
            return 0
        if self._copied is not None:
            torch.cuda.current_stream(self.device).wait_event(self._copied)
        self._store.write_block(self.head, self._dev_block, n)
        if self.prioritized:
            idx = (self.head + torch.arange(n, device=self.device)
                   ) % self.capacity
            self.trees = dper.insert(self.trees, idx, self.alpha)
        if self._copy_stream is not None:
            self._consumed = torch.cuda.Event()
            self._consumed.record(torch.cuda.current_stream(self.device))
        self.head = (self.head + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        self._inflight = 0
        REGISTRY.counter("fused.rows_committed").inc(n)
        REGISTRY.counter("fused.blocks_committed").inc()
        return n

    def drain(self) -> int:
        """Move every staged row to the device, one block per stage and
        commit (the in-flight block first). Returns the rows committed."""
        total = self.commit_staged()
        while self.stage_block():
            total += self.commit_staged()
        return total
