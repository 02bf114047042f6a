"""Device-resident transition ring.

Counterpart of ``d4pg_tpu/replay/device_ring.py``. ``DeviceStore`` keeps
the ring's six fields as tensors on one device, updated in place, with
two write paths and one read:

  - ``write(idx, batch)``: host rows land at explicit slots (the
    non-fused ring of ``ReplayBuffer(storage='device')``, and checkpoint
    restore);
  - ``write_block(start, frame, n)``: the fused ingest path. The ring
    then holds ``capacity + block_rows`` rows: a block landing at
    ``start`` is written contiguously, rows past the ring end spill into
    the ``block_rows`` shadow rows, and the spilled tail is mirrored into
    the ring head. ``start`` and ``n`` are host ints, so a block is two
    slice copies and no masks;
  - ``read(idx)``: the rows at host indices [B] or [K, B], gathered on
    the device; only the int64 indices cross.

Samplers index only ``[0, capacity)``. On the card the host rows and
indices go through two pinned blocks used in turns
(``staging.PinnedBlocks``), copied without blocking the host; writes and
reads run on the card's default stream, the current stream of every
thread that has not chosen another, so the commit thread's writes and
the learner's gathers run on the card in the order they took the
replay service's buffer lock.
"""

from __future__ import annotations

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.replay.staging import PinnedBlocks
from d4pg_tpu_torch.replay.uniform import TransitionBatch


@torch.no_grad()
def block_write(storage: TransitionBatch, frame: TransitionBatch, start: int,
                n: int, *, capacity: int, block_rows: int) -> None:
    """Land the first ``n`` rows of ``frame`` at ring position ``start``
    (``0 <= start < capacity``, ``n <= block_rows``), in place."""
    if not (0 <= start < capacity and 0 <= n <= block_rows):
        raise ValueError(f"block of {n} rows at {start} does not fit a "
                         f"{capacity}-row ring with {block_rows} shadow rows")
    wrapped = max(start + n - capacity, 0)
    for arr, val in zip(storage, frame):
        arr[start:start + n] = val[:n]
        if wrapped:
            arr[:wrapped] = arr[capacity:capacity + wrapped]


class DeviceStore:
    """Fixed-capacity transition storage on ``device`` (default ``cuda``)
    with ``block_rows`` shadow rows for the block writer (0: no block
    writer)."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int,
                 device: str | torch.device | None = None,
                 block_rows: int = 0):
        self.capacity = int(capacity)
        self.block_rows = int(block_rows)
        if not 0 <= self.block_rows <= self.capacity:
            raise ValueError(
                f"block_rows {block_rows} must be in [0, capacity {capacity}]")
        self.device = resolve_device(device)
        rows = self.capacity + self.block_rows

        def zeros(*shape):
            return torch.zeros((rows, *shape), dtype=torch.float32,
                               device=self.device)

        self._storage = TransitionBatch(
            obs=zeros(obs_dim), action=zeros(act_dim), reward=zeros(),
            next_obs=zeros(obs_dim), done=zeros(), discount=zeros())
        card = self.device.type == "cuda"
        self._stream = (torch.cuda.default_stream(self.device) if card
                        else None)
        self._write_blocks = PinnedBlocks() if card else None
        self._read_blocks = PinnedBlocks() if card else None
        self.index_bytes = 0  # host-to-device bytes of read() indices

    @property
    def arrays(self) -> TransitionBatch:
        """The raw [capacity + block_rows, ...] device tensors."""
        return self._storage

    @property
    def read_waits(self) -> int:
        """Reads that waited for their pinned index block's last copy."""
        return 0 if self._read_blocks is None else self._read_blocks.waits

    def _to_device(self, blocks: PinnedBlocks | None,
                   arrays: list[np.ndarray]) -> list[torch.Tensor]:
        if blocks is None:
            return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        stream = torch.cuda.current_stream(self.device)
        if stream != self._stream:
            raise RuntimeError(
                "the device ring runs on the card's default stream (its "
                "writes and reads are ordered by it); call it outside "
                "torch.cuda.stream(...)")
        slot, pinned = blocks.fill(arrays)
        out = [p.to(self.device, non_blocking=True) for p in pinned]
        blocks.release(slot, stream)
        return out

    @torch.no_grad()
    def write(self, idx: np.ndarray, batch: TransitionBatch) -> None:
        """Write host rows ``batch`` at the distinct slots ``idx``."""
        idx = np.asarray(idx, np.int64)
        fields = [np.asarray(v, np.float32) for v in batch]
        dev_idx, *values = self._to_device(self._write_blocks,
                                           [idx, *fields])
        for arr, val in zip(self._storage, values):
            arr.index_copy_(0, dev_idx, val)

    def write_block(self, start: int, frame: TransitionBatch, n: int) -> None:
        if not self.block_rows:
            raise RuntimeError("DeviceStore built without block_rows")
        block_write(self._storage, frame, start, n, capacity=self.capacity,
                    block_rows=self.block_rows)

    @torch.no_grad()
    def read(self, idx: np.ndarray) -> TransitionBatch:
        """Rows at host indices ``idx`` ([B] or [K, B]), gathered on the
        device."""
        idx = np.asarray(idx, np.int64)
        (dev_idx,) = self._to_device(self._read_blocks, [idx])
        if self._read_blocks is not None:
            self.index_bytes += idx.nbytes
        return TransitionBatch(*[arr[dev_idx] for arr in self._storage])
