"""Target-network update rules over ``nn.Module`` parameters.

Counterpart of ``d4pg_tpu/core/updates.py``: Polyak averaging
``theta' <- (1 - tau) * theta' + tau * theta`` (CURL's ``encoder_tau``
for the encoder leaves), the hard copy, the shared-encoder tie and
CURL's tie of the convolutions alone. Unlike
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
def tie_encoder(actor: nn.Module, critic: nn.Module) -> None:
    """In place: the actor's ``encoder`` parameters become copies of the
    critic's (``--share_encoder``: the critic loss alone trains the conv
    encoder). One definition for every tie site: init, the per-step
    online tie and the target tie. It copies, never aliases, so the
    actor's Adam state keeps its own tensors."""
    torch._foreach_copy_(list(actor.encoder.parameters()),
                         list(critic.encoder.parameters()))


@torch.no_grad()
def tie_convs(actor: nn.Module, critic: nn.Module) -> None:
    """In place: the actor's encoder convolutions become copies of the
    critic's, its trunk (``proj``, ``ln``) its own (CURL's
    ``copy_conv_weights_from``, which aliases where this copies)."""
    torch._foreach_copy_(
        [p for n, p in actor.encoder.named_parameters()
         if n.startswith("conv")],
        [p for n, p in critic.encoder.named_parameters()
         if n.startswith("conv")])
