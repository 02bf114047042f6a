"""D4PG losses as plain tensor functions.

Counterpart of ``d4pg_tpu/core/losses.py``: the distributional critic
loss is the cross-entropy between the projected target and the predicted
distribution, IS-weighted for PER; the policy loss is the negative
expected Q through the support bin centers.
"""

from __future__ import annotations

import torch

from d4pg_tpu_torch.core.distribution import CategoricalSupport

_LOG_EPS = 1e-10  # the reference's log(q + 1e-10)


def cross_entropy_per_sample(proj: torch.Tensor,
                             pred_probs: torch.Tensor) -> torch.Tensor:
    """Per-sample CE: [..., A] x [..., A] -> [...]."""
    return -torch.sum(proj * torch.log(pred_probs + _LOG_EPS), dim=-1)


def weighted_mean(td: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of per-sample errors, PER IS-weighted when ``weights`` is given."""
    return torch.mean(td if weights is None else weights * td)


def categorical_td_loss(
    proj: torch.Tensor,
    pred_probs: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(scalar_loss, td_error)``; ``td_error`` [...] is the per-sample
    cross-entropy, the PER priority signal."""
    td = cross_entropy_per_sample(proj, pred_probs)
    return weighted_mean(td, weights), td


def expected_q(support: CategoricalSupport,
               probs: torch.Tensor) -> torch.Tensor:
    """E[Z] via the support bin centers: [..., A] -> [...]."""
    return torch.sum(probs * support.atoms(probs.device), dim=-1)
