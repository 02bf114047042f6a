"""Layers run in a compute dtype over float32 parameters.

Counterpart of the ``dtype`` argument of Flax's ``Dense`` and ``Conv``:
parameters stay float32, and each product runs on its input, weight and
bias cast to the compute dtype (``float32`` or ``bfloat16``), so the
rounding happens where Flax's happens. For float32 every cast is a
no-op and the layer is ``nn.Linear``'s or ``nn.Conv2d``'s own product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def same_padding(size: int, stride: int, kernel: int) -> tuple[int, int]:
    """(before, after) padding of XLA's ``SAME`` along one axis of
    ``size``: the output has ceil(size / stride) positions and the odd
    pixel of an uneven total goes after (84 px at stride 2 and a 3-tap
    kernel: (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(layer: nn.Conv2d, x: torch.Tensor, pads: tuple[int, ...],
              dtype: torch.dtype) -> torch.Tensor:
    """``layer`` over NCHW ``x`` in ``dtype`` with the explicit ``pads``
    (top, bottom, left, right) of Flax's ``padding='SAME'``."""
    top, bottom, left, right = pads
    padding = 0
    if top == bottom and left == right:
        padding = (top, left)
    else:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype), stride=layer.stride,
                    padding=padding)
