"""The PER prefix-sum descent kernel: wrapper and plain version.

Counterpart of ``d4pg_tpu/ops/sampler_descent.py::descend_pallas``, which
is bitwise equal to ``d4pg_tpu/replay/device_per.py::descend``. Q
inverse-CDF descents of prefix masses through a sum tree of ``2 * cap``
float32 nodes (root at 1, leaf ``i`` at ``cap + i``); at each of the
log2(cap) levels ``mass >= left_sum`` goes right and subtracts. Returns
int32 leaf slots.

``descend`` runs the plain version for a tree on the CPU and the CUDA
kernel (``csrc/sampler_descent.cu``) for a tree on the card, bitwise equal
to each other. The kernel resolves several levels per dependent round
trip to memory (``rounds``), visiting the same nodes with the same
arithmetic. The port's fit rule: the tree stays in device memory (no
shared-memory bound such as the Pallas kernel's VMEM budget), so any
capacity up to 2^30 leaves works. Each call is a ``kernel.descent``
span (``io/profiling.span``, host side only: no device events).
"""

from __future__ import annotations

import math

import torch

from d4pg_tpu_torch.io.profiling import span, spans
from d4pg_tpu_torch.ops.kernels import library


def levels(sum_tree: torch.Tensor) -> int:
    cap = sum_tree.shape[0] // 2
    return int(math.log2(cap))


def rounds(cap: int) -> int:
    """Dependent round trips to memory of one query's descent in the
    kernel at capacity ``cap`` (builds the kernel library)."""
    per_round = library().cdll.d4pg_descent_levels_per_round()
    return -(-int(math.log2(cap)) // per_round)


def descend_plain(sum_tree: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Lock-step descent in plain torch; ``mass`` of any shape."""
    cap = sum_tree.shape[0] // 2
    p = mass
    node = torch.ones(mass.shape, dtype=torch.int64, device=mass.device)
    for _ in range(levels(sum_tree)):
        left = node << 1
        left_sum = sum_tree[left]
        go_right = p >= left_sum
        p = torch.where(go_right, p - left_sum, p)
        node = torch.where(go_right, left | 1, left)
    return (node - cap).to(torch.int32)


@span("kernel.descent")
def descend(sum_tree: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Leaf slots (int32, ``mass``'s shape) of prefix masses ``mass``
    (float32) in ``sum_tree`` ([2 * cap] float32). Each kernel launch adds
    one to ``descend.launches``."""
    if sum_tree.device.type == "cpu":
        return descend_plain(sum_tree, mass)
    if sum_tree.device.type != "cuda":
        raise ValueError(f"no descent kernel for {sum_tree.device}")
    cap = sum_tree.shape[0] // 2
    if sum_tree.dim() != 1 or cap < 1 or cap & (cap - 1) or cap > 1 << 30:
        raise ValueError(f"sum_tree must be [2 * cap] with cap a power of "
                         f"two <= 2^30, got {tuple(sum_tree.shape)}")
    for name, t in (("sum_tree", sum_tree), ("mass", mass)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mass.device != sum_tree.device:
        raise ValueError(f"mass is on {mass.device}, sum_tree on "
                         f"{sum_tree.device}")
    slot = torch.empty(mass.shape, dtype=torch.int32, device=mass.device)
    if mass.numel() == 0:
        return slot
    lib = library()
    stream = torch.cuda.current_stream(sum_tree.device).cuda_stream
    code = lib.cdll.d4pg_descend(sum_tree.data_ptr(), mass.data_ptr(),
                                 slot.data_ptr(), mass.numel(), cap,
                                 levels(sum_tree), stream)
    lib.check(code, "descent")
    descend.launches += 1
    return slot


descend.launches = 0
spans.count_launches("descent", lambda: descend.launches)
