"""Bytes the fused projection + cross-entropy kernels must move.

Forward: reads the target distribution and the predicted one ([B, A]
float32 each), the rewards and discounts ([B]); writes the TD errors
([B]). Backward: reads the same four and the TD errors' cotangent
([B]); writes the predicted distribution's gradient ([B, A]). Each
operand read once and each result written once. The arithmetic (about
ten operations per atom) is far below the bytes' time at the H100's
ratio of operations to bandwidth, so the bytes bound both kernels.
"""

from __future__ import annotations


def forward_bytes(batch: int, atoms: int) -> int:
    return 4 * (2 * batch * atoms + 3 * batch)


def backward_bytes(batch: int, atoms: int) -> int:
    return 4 * (3 * batch * atoms + 3 * batch)


def bytes_per_step(batch: int, atoms: int) -> int:
    """One forward and one backward, as each grad step launches them."""
    return forward_bytes(batch, atoms) + backward_bytes(batch, atoms)
