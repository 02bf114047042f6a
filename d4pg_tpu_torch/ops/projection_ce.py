"""The fused projection + cross-entropy kernels: wrapper and plain version.

Counterpart of ``d4pg_tpu/ops/projection_ce.py::projection_ce_pallas``.
The per-sample distributional TD error against the projected Bellman
target, with the projection never written out:

    proj_bj = categorical_projection(p, r, d)_bj
    td_b    = -sum_j proj_bj * log(q_bj + 1e-10)

Gradients reach ``pred_probs`` (q) only: the projected target is a
constant of the loss, as the learner's stop-gradient makes it, so the
backward (``dq = -g * proj / (q + 1e-10)``, proj recomputed) returns no
gradient for ``target_probs``, ``rewards`` or ``discounts``.

``projection_ce`` runs the plain version for a tensor on the CPU and
``ProjectionCE`` (forward and backward CUDA kernels of
``csrc/projection_ce.cu``) for a tensor on the card; there is no other
path. Each forward launch adds one to ``projection_ce.fwd_launches``,
each backward launch one to ``projection_ce.bwd_launches``.
"""

from __future__ import annotations

import torch

from d4pg_tpu_torch.core.distribution import (
    CategoricalSupport,
    categorical_projection,
)
from d4pg_tpu_torch.core.losses import cross_entropy_per_sample
from d4pg_tpu_torch.ops.kernels import library
from d4pg_tpu_torch.ops.projection import check_operands


def projection_ce_plain(
    support: CategoricalSupport,
    target_probs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    pred_probs: torch.Tensor,
) -> torch.Tensor:
    """``CE(stop_gradient(projection), q)`` in plain torch: td [B]."""
    proj = categorical_projection(support, target_probs, rewards, discounts)
    return cross_entropy_per_sample(proj.detach(), pred_probs)


def _launch_args(support: CategoricalSupport, p: torch.Tensor):
    stream = torch.cuda.current_stream(p.device).cuda_stream
    return (float(support.v_min), float(support.v_max), float(support.delta),
            stream)


def forward_kernel(support, target_probs, rewards, discounts,
                   pred_probs) -> torch.Tensor:
    """td [B] from the forward kernel (CUDA tensors, checked)."""
    b, a = check_operands(support, target_probs, rewards, discounts,
                          matrices=[("pred_probs", pred_probs)])
    td = torch.empty(b, dtype=torch.float32, device=target_probs.device)
    if b == 0:
        return td
    lib = library()
    code = lib.cdll.d4pg_projection_ce_fwd(
        target_probs.data_ptr(), rewards.data_ptr(), discounts.data_ptr(),
        pred_probs.data_ptr(), td.data_ptr(), b, a,
        *_launch_args(support, target_probs))
    lib.check(code, "projection_ce forward")
    projection_ce.fwd_launches += 1
    return td


def backward_kernel(support, target_probs, rewards, discounts, pred_probs,
                    grad_td) -> torch.Tensor:
    """dq [B, A] from the backward kernel for the cotangent ``grad_td``
    [B] of td (CUDA tensors, checked)."""
    b, a = check_operands(support, target_probs, rewards, discounts,
                          matrices=[("pred_probs", pred_probs)],
                          vectors=[("grad_td", grad_td)])
    dq = torch.empty_like(pred_probs)
    if b == 0:
        return dq
    lib = library()
    code = lib.cdll.d4pg_projection_ce_bwd(
        target_probs.data_ptr(), rewards.data_ptr(), discounts.data_ptr(),
        pred_probs.data_ptr(), grad_td.data_ptr(), dq.data_ptr(), b, a,
        *_launch_args(support, target_probs))
    lib.check(code, "projection_ce backward")
    projection_ce.bwd_launches += 1
    return dq


class ProjectionCE(torch.autograd.Function):
    """td = CE(stop_gradient(projection), q) through the two kernels."""

    @staticmethod
    def forward(ctx, support, target_probs, rewards, discounts, pred_probs):
        ctx.support = support
        ctx.save_for_backward(target_probs, rewards, discounts, pred_probs)
        return forward_kernel(support, target_probs, rewards, discounts,
                              pred_probs)

    @staticmethod
    def backward(ctx, grad_td):
        dq = None
        if ctx.needs_input_grad[4]:
            # the cotangent of a mean arrives expanded with stride 0; the
            # kernel reads it as B contiguous floats
            dq = backward_kernel(ctx.support, *ctx.saved_tensors,
                                 grad_td.contiguous())
        return None, None, None, None, dq


def projection_ce(
    support: CategoricalSupport,
    target_probs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    pred_probs: torch.Tensor,
) -> torch.Tensor:
    """Per-sample TD error td [B] of pred_probs [B, A] against the
    projected target of target_probs [B, A], rewards and discounts [B];
    differentiable in ``pred_probs`` only."""
    if target_probs.device.type == "cpu":
        return projection_ce_plain(support, target_probs, rewards, discounts,
                                   pred_probs)
    if target_probs.device.type != "cuda":
        raise ValueError(f"no projection_ce kernel for {target_probs.device}")
    return ProjectionCE.apply(support, target_probs, rewards, discounts,
                              pred_probs)


projection_ce.fwd_launches = 0
projection_ce.bwd_launches = 0
