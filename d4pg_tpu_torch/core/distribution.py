"""Categorical value-distribution support and Bellman projection.

Counterpart of ``d4pg_tpu/core/distribution.py``. Semantics:

  Tz_i = clip(r + discount * z_i, v_min, v_max)
  b_i  = (Tz_i - v_min) / delta
  p_i's mass is split linearly between floor(b_i) and ceil(b_i),
  i.e. W[i, j] = clip(1 - |b_i - j|, 0, 1) and out_j = sum_i p_i W[i, j].

Terminal transitions pass discount 0, which collapses the target onto a
delta at clip(r). The einsum formulation below is the plain version the
CUDA projection kernel (``ops/projection.py``) is held against.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CategoricalSupport:
    """Fixed categorical support: n_atoms bins on [v_min, v_max]."""

    v_min: float
    v_max: float
    n_atoms: int

    @property
    def delta(self) -> float:
        return (self.v_max - self.v_min) / float(self.n_atoms - 1)

    def atoms(self, device=None) -> torch.Tensor:
        return torch.linspace(self.v_min, self.v_max, self.n_atoms,
                              dtype=torch.float32, device=device)


def projection_weights(support: CategoricalSupport,
                       target_atoms: torch.Tensor) -> torch.Tensor:
    """W[..., i, j]: mass fraction of target atom i landing on bin j.

    ``target_atoms`` [..., A] is already Bellman-mapped and clipped;
    returns [..., A, A] whose rows sum to 1."""
    # the divisor as a tensor on the operand's device: torch on CUDA turns
    # a division by a Python scalar into a product with its float32
    # reciprocal, which moves b by an ulp from the IEEE quotient that the
    # CPU and the kernels compute (at b ~ 1,100 an ulp is 1.2e-4). A fill,
    # not a copy from the host, so the card's queue does not wait on it.
    delta = torch.full((), support.delta, dtype=target_atoms.dtype,
                       device=target_atoms.device)
    b = (target_atoms - support.v_min) / delta
    j = torch.arange(support.n_atoms, dtype=b.dtype, device=b.device)
    return torch.clamp(1.0 - torch.abs(b[..., :, None] - j), 0.0, 1.0)


def categorical_projection(
    support: CategoricalSupport,
    target_probs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
) -> torch.Tensor:
    """Project the Bellman-backed target distribution onto the support.

    target_probs [..., A]; rewards, discounts [...] (discount is
    ``gamma**n * (1 - done)``). Returns [..., A] with rows summing to 1."""
    atoms = support.atoms(target_probs.device)
    tz = rewards[..., None] + discounts[..., None] * atoms
    tz = torch.clamp(tz, support.v_min, support.v_max)
    w = projection_weights(support, tz)
    return torch.einsum("...i,...ij->...j", target_probs, w)
