"""Mixture-of-Gaussian distributional critic math.

Counterpart of ``d4pg_tpu/core/mog.py``:

  - the Bellman-backed target of a mixture is again a mixture, with
    ``mu' = r + d * mu`` and ``std' = max(d * std, min_std)``
    (``d = gamma^n * (1 - done)``; a terminal collapses toward a point
    mass at r, the floor keeps the log-density finite);
  - the critic loss is the cross-entropy H(target, pred), estimated with
    ``n_samples`` reparameterized draws from the (stop-gradient) target
    mixture;
  - expected Q is the closed-form mixture mean.

Draws: the reference picks components with
``jax.random.categorical(key_c, log_weights[..., None, :], shape=(B,
S))``, which is ``argmax(log_weights[..., None, :] + gumbel(key_c, (B,
S, K)), -1)``, then adds ``std * normal(key_z, (B, S))``. ``mog_td_loss``
takes the same two draws injected (``gumbel`` [B, S, K], ``normal``
[B, S]), or draws them from its ``generator``.
"""

from __future__ import annotations

import math

import torch

from d4pg_tpu_torch.core.losses import weighted_mean
from d4pg_tpu_torch.models.critic import MoGParams

_LOG2PI = math.log(2.0 * math.pi)


def mog_log_prob(params: MoGParams, x: torch.Tensor) -> torch.Tensor:
    """log p(x) under the mixture. x: [..., S] -> [..., S]."""
    mu = params.means[..., None, :]  # [..., 1, K]
    std = params.stds[..., None, :]
    lw = params.log_weights[..., None, :]
    z = (x[..., :, None] - mu) / std
    comp = -0.5 * (z * z + _LOG2PI) - torch.log(std)
    return torch.logsumexp(lw + comp, dim=-1)


def mog_mean(params: MoGParams) -> torch.Tensor:
    """Closed-form E[Z] = sum_k w_k mu_k."""
    return torch.sum(torch.exp(params.log_weights) * params.means, dim=-1)


def mog_target(params: MoGParams, rewards: torch.Tensor,
               discounts: torch.Tensor, min_std: float = 1e-2) -> MoGParams:
    """Bellman-map the target critic's mixture: an affine shift and scale
    of each component."""
    return MoGParams(
        log_weights=params.log_weights,
        means=rewards[..., None] + discounts[..., None] * params.means,
        stds=torch.clamp_min(discounts[..., None] * params.stds, min_std),
    )


def mog_td_loss(
    pred: MoGParams,
    target: MoGParams,
    generator: torch.Generator | None = None,
    n_samples: int = 32,
    weights: torch.Tensor | None = None,
    *,
    gumbel: torch.Tensor | None = None,
    normal: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sampled cross-entropy -E_{z ~ target}[log p_pred(z)]. Returns
    ``(scalar loss, per-sample td_error)`` like
    ``losses.categorical_td_loss``; td_error is the per-transition CE
    estimate (the PER priority signal). The draws are injected or come
    from ``generator`` (on the mixtures' device)."""
    target = MoGParams(*[t.detach() for t in target])
    means = target.means
    shape = means.shape[:-1] + (n_samples,)
    if (gumbel is None or normal is None) and generator is None:
        raise ValueError("mog_td_loss needs a generator or injected "
                         "gumbel and normal draws")
    if gumbel is None:
        u = torch.rand(shape + means.shape[-1:], generator=generator,
                       device=means.device)
        tiny = torch.finfo(u.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    comp = torch.argmax(target.log_weights[..., None, :] + gumbel, dim=-1)
    mu = torch.gather(means, -1, comp)
    std = torch.gather(target.stds, -1, comp)
    if normal is None:
        normal = torch.randn(mu.shape, generator=generator,
                             device=mu.device)
    z = mu + std * normal
    td = -torch.mean(mog_log_prob(pred, z), dim=-1)
    return weighted_mean(td, weights), td
