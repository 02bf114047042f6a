"""CURL's contrastive head: the bilinear similarity of anchors and keys.

Srinivas, Laskin and Abbeel 2020, "CURL: Contrastive Unsupervised
Representations for Reinforcement Learning" (arXiv:2004.04136), as
``curl_sac.py``'s ``CURL`` module builds it: a ``latent x latent``
parameter ``W`` drawn from ``torch.rand``, and a reference to the
critic's encoder, so that ``CURL.parameters()`` (the ``cpc_optimizer``'s
parameters) are ``W`` and the encoder's. ``curl_sac.py`` also holds the
target critic's encoder in the module; it is computed under ``no_grad``
and so gets no gradient and no Adam step, and here it stays with the
target critic alone.

``logits(z_a, z_pos)`` is ``z_a (W z_pos^T)``, [B, B], less each row's
largest entry; row i's positive is column i (``core.losses.
contrastive_loss``).
"""

from __future__ import annotations

import torch
from torch import nn


class CURL(nn.Module):
    def __init__(self, encoder: nn.Module, latent_dim: int = 50,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.W = nn.Parameter(torch.rand(latent_dim, latent_dim,
                                         generator=generator))
        self.encoder = encoder  # the critic's: its parameters are shared

    def logits(self, z_a: torch.Tensor, z_pos: torch.Tensor) -> torch.Tensor:
        """[B, B] logits of anchors ``z_a`` [B, latent] against keys
        ``z_pos`` [B, latent], each row less its max."""
        wz = torch.matmul(self.W, z_pos.T)
        logits = torch.matmul(z_a, wz)
        return logits - torch.max(logits, 1)[0][:, None]
