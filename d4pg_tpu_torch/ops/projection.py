"""The categorical Bellman projection kernel: wrapper and plain version.

Counterpart of ``d4pg_tpu/ops/projection.py::projection_pallas``. The
kernel (``csrc/projection.cu``) computes exactly
``core.distribution.categorical_projection``:

    tz    = clip(r + disc * z, v_min, v_max)
    b     = (tz - v_min) / delta
    out_j = sum_i p_i * clip(1 - |b_i - j|, 0, 1)

``projection`` runs the plain version for a tensor on the CPU and the
CUDA kernel for a tensor on the card; there is no other path. It is
forward only: the learner stops the gradient at the projected target.
Each call is a ``kernel.projection`` span (``io/profiling.span``, host
side only: no device events).
"""

from __future__ import annotations

import torch

from d4pg_tpu_torch.core.distribution import (
    CategoricalSupport,
    categorical_projection,
)
from d4pg_tpu_torch.io.profiling import span, spans
from d4pg_tpu_torch.ops.kernels import library

projection_plain = categorical_projection


def check_operands(support: CategoricalSupport, target_probs, rewards,
                   discounts, *, matrices=(), vectors=()) -> tuple[int, int]:
    """Raise unless target_probs and each ``(name, tensor)`` of
    ``matrices`` are [B, A] (A = the support's atoms), rewards, discounts
    and each of ``vectors`` are [B], all contiguous float32 on one device.
    Returns ``(B, A)``."""
    if target_probs.dim() != 2:
        raise ValueError(f"target_probs must be [B, A], got "
                         f"{tuple(target_probs.shape)}")
    b, a = target_probs.shape
    if a != support.n_atoms:
        raise ValueError(f"{a} atoms in target_probs, support has "
                         f"{support.n_atoms}")
    expected = [("target_probs", target_probs, (b, a)),
                *[(name, t, (b, a)) for name, t in matrices],
                ("rewards", rewards, (b,)), ("discounts", discounts, (b,)),
                *[(name, t, (b,)) for name, t in vectors]]
    for name, t, shape in expected:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != target_probs.device:
            raise ValueError(f"{name} is on {t.device}, target_probs on "
                             f"{target_probs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, a


@span("kernel.projection")
def projection(
    support: CategoricalSupport,
    target_probs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
) -> torch.Tensor:
    """Projected target distribution [B, A] from target_probs [B, A] and
    rewards, discounts [B]. Each kernel launch adds one to
    ``projection.launches``."""
    if target_probs.device.type == "cpu":
        return projection_plain(support, target_probs, rewards, discounts)
    if target_probs.device.type != "cuda":
        raise ValueError(f"no projection kernel for {target_probs.device}")
    b, a = check_operands(support, target_probs, rewards, discounts)
    out = torch.empty_like(target_probs)
    if b == 0:
        return out
    lib = library()
    stream = torch.cuda.current_stream(target_probs.device).cuda_stream
    code = lib.cdll.d4pg_projection(
        target_probs.data_ptr(), rewards.data_ptr(), discounts.data_ptr(),
        out.data_ptr(), b, a, float(support.v_min), float(support.v_max),
        float(support.delta), stream)
    lib.check(code, "projection")
    projection.launches += 1
    return out


projection.launches = 0
spans.count_launches("projection", lambda: projection.launches)
