"""Host segment trees with batched operations, in numpy.

Counterpart of ``d4pg_tpu/replay/segment_tree.py``: the PER sum and min
trees of the host-sampled replay path (``replay/prioritized.py``) and the
oracle of the device trees (``replay/device_per.py``).

  - the tree is one flat float64 array of ``2 * capacity`` nodes (node 1
    is the root, leaf i lives at ``capacity + i``);
  - ``set`` writes B leaves at once, then repairs the ancestors level by
    level on the unique touched parents (numpy's fancy assignment keeps
    the last of duplicate indices);
  - ``find_prefixsum`` descends all B queries in lock step, log2(N)
    vector steps (``mass >= left sum`` goes right).

``replay/native.py`` implements the same operations in C++.
"""

from __future__ import annotations

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= n: the capacity rounding of the host and
    device trees."""
    p = 1
    while p < n:
        p <<= 1
    return p


class _Tree:
    """Shared machinery; subclasses define the reduction."""

    _neutral: float
    _op = None  # np ufunc

    def __init__(self, capacity: int):
        self.capacity = next_pow2(int(capacity))
        self._levels = int(np.log2(self.capacity))
        self.tree = np.full(2 * self.capacity, self._neutral, np.float64)

    def set(self, idx: np.ndarray, values: np.ndarray) -> None:
        """Batched leaf assignment and ancestor repair."""
        idx = np.asarray(idx, np.int64)
        node = idx + self.capacity
        self.tree[node] = values
        parent = np.unique(node >> 1)
        while parent[0] >= 1:
            left = parent << 1
            self.tree[parent] = self._op(self.tree[left], self.tree[left | 1])
            parent = np.unique(parent >> 1)
            if parent[0] == 0:
                break

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self.tree[np.asarray(idx, np.int64) + self.capacity]

    @property
    def root(self) -> float:
        return float(self.tree[1])


class SumTree(_Tree):
    _neutral = 0.0
    _op = staticmethod(np.add)

    def sum(self) -> float:
        return self.root

    def find_prefixsum(self, prefix: np.ndarray) -> np.ndarray:
        """Batched inverse CDF: for each mass p, the smallest leaf i with
        ``sum(leaves[:i + 1]) > p``."""
        p = np.asarray(prefix, np.float64).copy()
        node = np.ones_like(p, dtype=np.int64)  # root
        for _ in range(self._levels):
            left = node << 1
            left_sum = self.tree[left]
            go_right = p >= left_sum
            p = np.where(go_right, p - left_sum, p)
            node = np.where(go_right, left | 1, left)
        return node - self.capacity


class MinTree(_Tree):
    _neutral = np.inf
    _op = staticmethod(np.minimum)

    def min(self) -> float:
        return self.root
