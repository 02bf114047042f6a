"""Target-network update rules over ``nn.Module`` parameters.

Counterpart of ``d4pg_tpu/core/updates.py``: Polyak averaging
``theta' <- (1 - tau) * theta' + tau * theta`` and the hard copy. Unlike
the JAX pytree maps these update the target module in place, with the
multi-tensor ``_foreach`` ops (two launches for all parameters).
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """In place: every target parameter becomes ``(1 - tau) * t + tau * o``."""
    t, o = list(target.parameters()), list(online.parameters())
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, o, alpha=tau)


@torch.no_grad()
def hard_update(target: nn.Module, online: nn.Module) -> None:
    """In place: copy the online parameters into the target."""
    torch._foreach_copy_(list(target.parameters()),
                         list(online.parameters()))
