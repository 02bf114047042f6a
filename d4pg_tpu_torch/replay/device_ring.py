"""Device-resident transition ring.

Counterpart of ``d4pg_tpu/replay/device_ring.py`` (``block_write`` and
``DeviceStore``'s block path). The ring holds ``capacity + block_rows``
rows: a block landing at ``start`` is written contiguously, rows past the
ring end spill into the ``block_rows`` shadow rows, and the spilled tail
is mirrored into the ring head. Samplers index only ``[0, capacity)``.
Unlike the JAX arrays the ring is updated in place; ``start`` and ``n``
are host ints, so a block is two slice copies and no masks.
"""

from __future__ import annotations

import torch

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
    """Fixed-capacity transition storage on ``device`` with ``block_rows``
    shadow rows for the block writer."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int,
                 device: torch.device, block_rows: int):
        self.capacity = int(capacity)
        self.block_rows = int(block_rows)
        if not 0 < self.block_rows <= self.capacity:
            raise ValueError(
                f"block_rows {block_rows} must be in [1, capacity {capacity}]")
        rows = self.capacity + self.block_rows

        def zeros(*shape):
            return torch.zeros((rows, *shape), dtype=torch.float32,
                               device=device)

        self._storage = TransitionBatch(
            obs=zeros(obs_dim), action=zeros(act_dim), reward=zeros(),
            next_obs=zeros(obs_dim), done=zeros(), discount=zeros())

    @property
    def arrays(self) -> TransitionBatch:
        """The raw [capacity + block_rows, ...] device tensors."""
        return self._storage

    def write_block(self, start: int, frame: TransitionBatch, n: int) -> None:
        block_write(self._storage, frame, start, n, capacity=self.capacity,
                    block_rows=self.block_rows)
