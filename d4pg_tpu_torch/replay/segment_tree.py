"""Capacity rounding shared by the device trees.

Counterpart of ``next_pow2`` in ``d4pg_tpu/replay/segment_tree.py``; the
host segment trees themselves are not ported yet.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p <<= 1
    return p
