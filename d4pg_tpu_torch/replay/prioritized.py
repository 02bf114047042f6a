"""Prioritized replay sampled on the host.

Counterpart of ``d4pg_tpu/replay/prioritized.py``:

  - new rows enter at ``max_priority ** alpha``;
  - proportional sampling by inverse CDF over the sum tree, stratified
    (one uniform draw in each of B equal slices of the total mass, the
    reference's default) from the buffer's ``np.random.default_rng(seed)``,
    so a seed picks the reference's slots bit for bit;
  - IS weights ``(p_i * N) ** -beta`` normalized by the largest weight,
    which comes from the min tree (``weight_base``);
  - ``update_priorities`` writes ``priority ** alpha`` into both trees and
    tracks the running max; with the per-slot ``generation`` captured at
    sample time, writes to slots overwritten since are dropped.

The trees are the C++ pair (``replay/native.py``) or the numpy pair
(``replay/segment_tree.py``), which compute the same bits:
``backend='native'`` raises when the library cannot be built,
``'numpy'`` never builds it, and ``'auto'`` (the default) takes the
native pair when it builds and numpy otherwise; ``tree_backend`` says
which one was loaded. The ring is host RAM or a device ring
(``storage``, see ``replay/uniform.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from d4pg_tpu_torch.replay.segment_tree import MinTree, SumTree
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch


class NumpyPerTrees:
    """Sum and min trees in numpy, behind the interface of
    ``native.NativePerTrees``."""

    backend = "numpy"

    def __init__(self, capacity: int):
        self._sum_tree = SumTree(capacity)
        self._min_tree = MinTree(capacity)
        self.capacity = self._sum_tree.capacity

    def set(self, idx: np.ndarray, values: np.ndarray) -> None:
        self._sum_tree.set(idx, values)
        self._min_tree.set(idx, values)

    def sum(self) -> float:
        return self._sum_tree.sum()

    def min(self) -> float:
        return self._min_tree.min()

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self._sum_tree.get(idx)

    def find_prefixsum(self, prefix: np.ndarray) -> np.ndarray:
        return self._sum_tree.find_prefixsum(prefix)


def make_trees(capacity: int, backend: str = "auto"):
    if backend not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown PER backend {backend!r}")
    if backend in ("auto", "native"):
        from d4pg_tpu_torch.replay.native import NativePerTrees

        try:
            return NativePerTrees(capacity)
        except (RuntimeError, OSError):
            if backend == "native":
                raise
    return NumpyPerTrees(capacity)


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(self, capacity: int, obs_dim: int, act_dim: int,
                 alpha: float = 0.6, seed: int = 0,
                 backend: str = "auto", storage: str = "host",
                 device: str | torch.device | None = None):
        super().__init__(capacity, obs_dim, act_dim, seed=seed,
                         storage=storage, device=device)
        if alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        self.alpha = float(alpha)
        self._trees = make_trees(self.capacity, backend)
        self.tree_backend = self._trees.backend
        self.max_priority = 1.0
        # per-slot write generation: a slot the commit thread overwrites
        # between a sample and its priority write-back keeps the new row's
        # priority
        self.generation = np.zeros(self.capacity, np.int64)

    def add(self, batch: TransitionBatch) -> np.ndarray:
        idx = super().add(batch)
        self.generation[idx] += 1
        p = self.max_priority**self.alpha
        self._trees.set(idx, np.full(len(idx), p))
        return idx

    def sample_idx(self, batch_size: int) -> np.ndarray:
        if self.size == 0:
            raise ValueError("cannot sample from an empty buffer")
        total = self._trees.sum()
        bounds = np.linspace(0.0, total, batch_size + 1)
        mass = self._rng.uniform(bounds[:-1], bounds[1:])
        idx = self._trees.find_prefixsum(mass)
        # a mass at or over the total can land on an unwritten leaf
        return np.minimum(idx, max(self.size - 1, 0))

    def weight_base(self) -> float:
        """``z = (p_min / total) * N``: ``z ** -beta`` is the largest IS
        weight."""
        total = self._trees.sum()
        return float(self._trees.min() / total * self.size)

    def is_weights(self, idx: np.ndarray, beta: float,
                   weight_base: float | None = None) -> np.ndarray:
        """``(p_i * N) ** -beta / max_weight``, float32; ``weight_base``
        overrides the local ``z``."""
        if beta <= 0:
            raise ValueError(f"beta must be > 0, got {beta}")
        total = self._trees.sum()
        z = self.weight_base() if weight_base is None else weight_base
        max_weight = z ** (-beta)
        p = self._trees.get(idx) / total
        return ((p * self.size) ** (-beta) / max_weight).astype(np.float32)

    def sample(self, batch_size: int, beta: float = 0.4,
               weight_base: float | None = None):
        """``(batch, is_weights, idx)``; ``idx`` feeds
        ``update_priorities``."""
        idx = self.sample_idx(batch_size)
        return self.gather(idx), self.is_weights(idx, beta, weight_base), idx

    def sample_chunk(self, k: int, batch_size: int, beta: float = 0.4,
                     weight_base: float | None = None):
        """K stacked proportional samples in one storage gather:
        ``(batches [K, B, ...], weights [K, B], idx [K, B])``. The tree
        walks and IS weights stay on the host; with device storage only
        the indices cross."""
        idx = np.stack([self.sample_idx(batch_size) for _ in range(k)])
        w = np.stack([self.is_weights(idx[i], beta, weight_base)
                      for i in range(k)])
        return self.gather(idx), w.astype(np.float32), idx

    def state_dict(self) -> dict:
        d = super().state_dict()
        # the leaves hold priority ** alpha already; only live slots (an
        # unwritten min-tree leaf must stay at +inf)
        d["leaf_priorities"] = np.asarray(
            self._trees.get(np.arange(self.size)))
        d["max_priority"] = self.max_priority
        d["generation"] = self.generation.copy()
        return d

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        if self.size:
            self._trees.set(np.arange(self.size), d["leaf_priorities"])
        self.max_priority = float(d["max_priority"])
        self.generation = np.asarray(d["generation"]).copy()

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray,
                          generation: np.ndarray | None = None) -> None:
        """Write ``priority ** alpha`` into the trees; with
        ``generation`` (captured at sample time), entries whose slot has
        been overwritten since are dropped."""
        priorities = np.asarray(priorities, np.float64)
        if not (priorities > 0).all():
            raise ValueError("priorities must be positive")
        if generation is not None:
            live = self.generation[idx] == generation
            if not live.all():
                idx, priorities = idx[live], priorities[live]
            if len(idx) == 0:
                return
        self._trees.set(idx, priorities**self.alpha)
        self.max_priority = max(self.max_priority, float(priorities.max()))
