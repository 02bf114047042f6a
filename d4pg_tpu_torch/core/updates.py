"""Target-network update rules over ``nn.Module`` parameters.

Counterpart of ``d4pg_tpu/core/updates.py``: Polyak averaging
``theta' <- (1 - tau) * theta' + tau * theta`` (CURL's ``encoder_tau``
for the encoder leaves), the hard copy and the tie of what the actor's
encoder shares with the critic's. Unlike
the JAX pytree maps these update the target module in place, with the
multi-tensor ``_foreach`` ops (two launches for all parameters).
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, tau: float,
                encoder_tau: float | None = None) -> None:
    """In place: every target parameter becomes ``(1 - tau) * t + tau * o``;
    with ``encoder_tau`` the parameters under ``encoder.`` take it in
    place of ``tau`` (CURL's momentum key encoder)."""
    t, o = list(target.parameters()), list(online.parameters())
    groups = [(t, o, tau)]
    if encoder_tau is not None:
        enc = [n.startswith("encoder.") for n, _ in target.named_parameters()]
        groups = [([x for x, e in zip(t, enc) if e == side],
                   [x for x, e in zip(o, enc) if e == side], rate)
                  for side, rate in ((True, encoder_tau), (False, tau))]
    for t, o, rate in groups:
        torch._foreach_mul_(t, 1.0 - rate)
        torch._foreach_add_(t, o, alpha=rate)


@torch.no_grad()
def hard_update(target: nn.Module, online: nn.Module) -> None:
    """In place: copy the online parameters into the target."""
    torch._foreach_copy_(list(target.parameters()),
                         list(online.parameters()))


@torch.no_grad()
def tie_shared(actor: nn.Module, critic: nn.Module, shares: str) -> None:
    """In place: the actor encoder's parameters that ``shares`` names
    (``D4PGConfig.shares``) become copies of the critic's: all of them
    for ``"encoder"`` (``--share_encoder``: the critic loss alone trains
    the encoder), the convolutions for ``"convs"`` (CURL's
    ``copy_conv_weights_from``, which aliases where this copies; the
    actor keeps its own trunk). One
    definition for every tie site: init, the online ties and the target
    tie. It copies, never aliases, so the actor's Adam state keeps its
    own tensors."""
    def part(module):
        return [p for n, p in module.encoder.named_parameters()
                if shares == "encoder" or n.startswith("conv")]

    torch._foreach_copy_(part(actor), part(critic))
