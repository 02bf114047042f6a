"""Replay buffer for the fused device path: ring + PER trees on the card.

Counterpart of ``d4pg_tpu/replay/fused_buffer.py``, single-shard and
without generation tracking. ``add`` only copies host rows into a
preallocated column-major staging ring; ``drain`` moves them to the
device one fixed-size block at a time, each block being a ring write
(``device_ring.block_write``) plus, with ``prioritized=True``, a PER tree
insert at ``max_priority ** alpha``; a uniform buffer has no trees. The
learner calls ``drain`` between chunks, so the fused chunk never sees a
half-landed block.
"""

from __future__ import annotations

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
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


class FusedDeviceReplay:
    """Fixed-capacity device ring + (``prioritized``) device PER trees;
    ``trees`` is ``None`` for uniform replay."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int,
                 alpha: float = 0.6, prioritized: bool = True,
                 device: str | torch.device | None = None,
                 block_rows: int | None = None, staging_blocks: int = 8):
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
        self._staging = HostStagingRing(
            [(obs_dim,), (act_dim,), (), (obs_dim,), (), ()],
            self.block_rows, n_blocks)

    def add(self, batch: TransitionBatch) -> None:
        """Stage host rows (numpy arrays); no device work."""
        if np.asarray(batch.obs).shape[0]:
            self._staging.push(batch)

    def __len__(self) -> int:
        return min(self.size + len(self._staging), self.capacity)

    @property
    def storage(self) -> TransitionBatch:
        return self._store.arrays

    def _commit(self, frame: TransitionBatch, n: int) -> None:
        dev = TransitionBatch(*[torch.from_numpy(v).to(self.device)
                                for v in frame])
        self._store.write_block(self.head, dev, n)
        if self.prioritized:
            idx = (self.head + torch.arange(n, device=self.device)
                   ) % self.capacity
            self.trees = dper.insert(self.trees, idx, self.alpha)
        self.head = (self.head + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def drain(self) -> int:
        """Move every staged row to the device, one block per commit.
        Returns the rows committed."""
        total = 0
        while True:
            frame, n = self._staging.frame()
            if n == 0:
                return total
            self._commit(frame, n)
            self._staging.pop(n)
            total += n
