"""Transition batches and the uniform replay ring.

Counterpart of ``d4pg_tpu/replay/uniform.py``: a fixed-capacity ring of
``(s, a, r, s', done, discount)`` rows over pluggable storage, sampled
uniformly with replacement from a host ``np.random.default_rng(seed)``
(so a seed picks the reference's slots, bit for bit).

Observations are vectors (``obs_dim`` an int, float32) or frames
(``obs_dim`` an [H, W, C] tuple, uint8 by default: a 1,000,000-frame
ring of 84x84x9 rows is 127 GB in float32 and 32 GB in uint8), with the
reference's ``obs_dtype`` rule (``obs_layout``).

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

    obs: torch.Tensor  # [B, obs_dim] float32, or [B, H, W, C] uint8
    action: torch.Tensor  # [B, act_dim] float32
    reward: torch.Tensor  # [B] float32 (n-step folded return)
    next_obs: torch.Tensor  # as obs (s_{t+n})
    done: torch.Tensor  # [B] float32
    discount: torch.Tensor  # [B] float32 = gamma^m * (1 - done)


def obs_layout(obs_dim, obs_dtype=None) -> tuple[tuple, np.dtype]:
    """``(obs_shape, obs_dtype)`` of an obs spec: an int is a vector
    (float32 by default), a tuple a frame shape (uint8 by default)."""
    shape = (int(obs_dim),) if np.isscalar(obs_dim) else tuple(obs_dim)
    if obs_dtype is None:
        obs_dtype = np.float32 if len(shape) == 1 else np.uint8
    return shape, np.dtype(obs_dtype)


def field_layouts(obs_dim, act_dim: int, obs_dtype=None) -> list:
    """``(shape, dtype)`` of each ``TransitionBatch`` field's row."""
    obs_shape, obs_dtype = obs_layout(obs_dim, obs_dtype)
    f32 = np.dtype(np.float32)
    return [(obs_shape, obs_dtype), ((int(act_dim),), f32), ((), f32),
            (obs_shape, obs_dtype), ((), f32), ((), f32)]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, dtype)).dtype


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


def validate_rows(d: dict, capacity: int) -> None:
    """Refuse a :func:`pack_rows` payload that cannot restore into a
    ``capacity``-sized ring: one a sharded (data-parallel) buffer saved,
    or one of another capacity (a wrapped ring laid into another capacity
    would point head and size at the wrong slots)."""
    if "sharded" in d:
        raise ValueError(
            "replay checkpoint was saved by a sharded (data_parallel) "
            "buffer; resume with the same --data_parallel degree")
    ckpt_cap = int(d.get("capacity", -1))
    if ckpt_cap != capacity:
        raise ValueError(
            f"replay checkpoint capacity {ckpt_cap} != buffer capacity "
            f"{capacity}; resume with the same --rmsize")


def unpack_rows(d: dict, capacity: int):
    """Validate (:func:`validate_rows`) and unpack a :func:`pack_rows`
    payload; returns ``(batch_or_None, head, size)``."""
    validate_rows(d, capacity)
    size = int(d["size"])
    batch = (TransitionBatch(*[d["rows"][f] for f in TransitionBatch._fields])
             if size else None)
    return batch, int(d["head"]) % capacity, size


class HostStore:
    """Preallocated contiguous numpy storage."""

    def __init__(self, capacity: int, obs_dim, act_dim: int,
                 obs_dtype=None):
        for name, (shape, dtype) in zip(
                TransitionBatch._fields,
                field_layouts(obs_dim, act_dim, obs_dtype)):
            setattr(self, name, np.zeros((capacity, *shape), dtype))

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
    (default ``cuda``). ``obs_dim`` is an int or an [H, W, C] tuple,
    stored as ``obs_dtype`` (``obs_layout``)."""

    def __init__(self, capacity: int, obs_dim, act_dim: int,
                 seed: int = 0, storage: str = "host",
                 device: str | torch.device | None = None, obs_dtype=None):
        self.capacity = int(capacity)
        if storage == "device":
            from d4pg_tpu_torch.replay.device_ring import DeviceStore

            self._store = DeviceStore(self.capacity, obs_dim, act_dim,
                                      device=device, obs_dtype=obs_dtype)
        elif storage == "host":
            self._store = HostStore(self.capacity, obs_dim, act_dim,
                                    obs_dtype)
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
