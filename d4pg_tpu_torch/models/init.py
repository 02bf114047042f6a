"""Weight initializers.

Counterpart of ``d4pg_tpu/models/init.py``: hidden kernels draw
N(0, std = 1/sqrt(fan_in)) and output heads N(0, std). Biases start at
zero, like Flax's ``Dense`` (torch's default bias init is not zero).
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def fanin_init(layer: nn.Linear, generator: torch.Generator) -> None:
    """N(0, 1/sqrt(fan_in)) weight, zero bias. ``Linear.weight`` is
    [out, in], so fan_in is its second dimension."""
    scaled_normal(layer, 1.0 / math.sqrt(layer.weight.shape[1]), generator)


@torch.no_grad()
def scaled_normal(layer: nn.Linear, std: float,
                  generator: torch.Generator) -> None:
    """N(0, std) weight, zero bias."""
    layer.weight.normal_(0.0, std, generator=generator)
    layer.bias.zero_()
