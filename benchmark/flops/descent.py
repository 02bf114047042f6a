"""Bytes the PER descent kernel must move for one set of queries.

Each query reads, on its way from the root to its leaf, the left child
of every node it passes (4 B each, float32), so the least a descent of
``Q`` queries over ``cap`` leaves must read is every distinct such node
once; it also reads each query's mass (4 B) and writes its slot (4 B).
The distinct nodes follow from the slots drawn: the node at depth d on
the way to leaf i is ``(cap + i) >> (log2(cap) - d)``.
"""

from __future__ import annotations

import torch


def bytes_per_query_set(slots: torch.Tensor, cap: int) -> int:
    levels = int(cap).bit_length() - 1
    leaf = slots.reshape(-1).to(torch.int64) + cap
    left = torch.cat([(leaf >> (levels - d)) << 1 for d in range(levels)])
    return 4 * int(torch.unique(left).numel()) + 8 * int(leaf.numel())
