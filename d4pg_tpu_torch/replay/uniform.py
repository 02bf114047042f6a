"""Transition batches and the uniform replay ring.

Counterpart of ``d4pg_tpu/replay/uniform.py``: a fixed-capacity ring of
``(s, a, r, s', done, discount)`` rows over pluggable storage, sampled
uniformly with replacement from a host ``np.random.default_rng(seed)``
(so a seed picks the reference's slots, bit for bit).

  - ``storage='host'``: preallocated numpy arrays in host RAM
    (``HostStore``); ``gather`` returns numpy rows, which the learner
    copies to the card (``replay/staging.DeviceStager``);
  - ``storage='device'``: the ring lives on ``device``
    (``replay/device_ring.DeviceStore``); the host picks indices and the
    device gathers the rows, so a chunk moves only its indices.

``TransitionBatch`` holds numpy arrays on the host and tensors on a
device; its fields are the same either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TransitionBatch(NamedTuple):
    """A batch of (possibly n-step-folded) transitions."""

    obs: torch.Tensor  # [B, obs_dim] float32
    action: torch.Tensor  # [B, act_dim] float32
    reward: torch.Tensor  # [B] float32 (n-step folded return)
    next_obs: torch.Tensor  # [B, obs_dim] float32 (s_{t+n})
    done: torch.Tensor  # [B] float32
    discount: torch.Tensor  # [B] float32 = gamma^m * (1 - done)


def pack_rows(rows: TransitionBatch, head: int, size: int,
              capacity: int) -> dict:
    """Checkpoint payload of ring contents (host numpy)."""
    return {
        "rows": {f: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v))
                 for f, v in zip(TransitionBatch._fields, rows)},
        "head": head,
        "size": size,
        "capacity": capacity,
    }


def unpack_rows(d: dict, capacity: int):
    """Validate and unpack a :func:`pack_rows` payload; returns
    ``(batch_or_None, head, size)``. The capacity must match exactly: a
    wrapped ring laid into another capacity would point head and size at
    the wrong slots."""
    ckpt_cap = int(d.get("capacity", -1))
    if ckpt_cap != capacity:
        raise ValueError(
            f"replay checkpoint capacity {ckpt_cap} != buffer capacity "
            f"{capacity}; resume with the same --rmsize")
    size = int(d["size"])
    batch = (TransitionBatch(*[d["rows"][f] for f in TransitionBatch._fields])
             if size else None)
    return batch, int(d["head"]) % capacity, size


class HostStore:
    """Preallocated contiguous numpy storage."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int):
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.action = np.zeros((capacity, act_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.discount = np.zeros((capacity,), np.float32)

    def write(self, idx: np.ndarray, batch: TransitionBatch) -> None:
        self.obs[idx] = batch.obs
        self.action[idx] = batch.action
        self.reward[idx] = batch.reward
        self.next_obs[idx] = batch.next_obs
        self.done[idx] = batch.done
        self.discount[idx] = batch.discount

    def read(self, idx: np.ndarray) -> TransitionBatch:
        return TransitionBatch(
            obs=self.obs[idx],
            action=self.action[idx],
            reward=self.reward[idx],
            next_obs=self.next_obs[idx],
            done=self.done[idx],
            discount=self.discount[idx],
        )


class ReplayBuffer:
    """Fixed-capacity ring over ``storage='host'`` or ``'device'`` (see
    the module docstring); ``device`` is where a ``'device'`` ring lives
    (default ``cuda``). Vector observations, float32."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int,
                 seed: int = 0, storage: str = "host",
                 device: str | torch.device | None = None):
        self.capacity = int(capacity)
        if storage == "device":
            from d4pg_tpu_torch.replay.device_ring import DeviceStore

            self._store = DeviceStore(self.capacity, obs_dim, act_dim,
                                      device=device)
        elif storage == "host":
            self._store = HostStore(self.capacity, obs_dim, act_dim)
        else:
            raise ValueError(f"unknown storage {storage!r}")
        self.storage = storage
        self.size = 0
        self.head = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.size

    def add(self, batch: TransitionBatch) -> np.ndarray:
        """Insert a batch of host rows; returns the slot indices written."""
        n = np.asarray(batch.obs).shape[0]
        if n > self.capacity:
            raise ValueError(f"batch of {n} exceeds capacity {self.capacity}")
        idx = (self.head + np.arange(n)) % self.capacity
        self._store.write(idx, batch)
        self.head = int((self.head + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))
        return idx

    def gather(self, idx: np.ndarray) -> TransitionBatch:
        """Rows at ``idx`` ([B] or stacked [K, B]): numpy for host
        storage, device tensors for device storage."""
        return self._store.read(idx)

    def sample(self, batch_size: int) -> TransitionBatch:
        """``batch_size`` rows drawn uniformly with replacement."""
        if self.size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = self._rng.choice(self.size, size=batch_size, replace=True)
        return self.gather(idx)

    def sample_chunk(self, k: int, batch_size: int):
        """K stacked batches in one storage gather: ``(batches [K, B, ...],
        None, idx [K, B])``."""
        if self.size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = self._rng.choice(self.size, size=(k, batch_size), replace=True)
        return self.gather(idx), None, idx

    def state_dict(self) -> dict:
        """The live rows as host numpy, with head and size."""
        return pack_rows(self.gather(np.arange(self.size)), self.head,
                         self.size, self.capacity)

    def load_state_dict(self, d: dict) -> None:
        """Restore contents saved by :meth:`state_dict` (same capacity)."""
        batch, head, size = unpack_rows(d, self.capacity)
        if batch is not None:
            self._store.write(np.arange(size), batch)
        self.size = size
        self.head = head
