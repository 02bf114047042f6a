"""Deterministic policy network pi(s) -> a in (-1, 1)^act_dim.

Counterpart of ``d4pg_tpu/models/actor.py``: an MLP (default 256-256-256)
with ReLU after every hidden layer, fan-in init on hidden kernels,
N(0, 3e-3) on the output kernel, tanh on the output. Layer names follow
the Flax module's (``fc1`` .. ``fcN``, ``out``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from d4pg_tpu_torch.models.init import fanin_init, scaled_normal


class Actor(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (256, 256, 256),
                 final_init_std: float = 3e-3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_names = [f"fc{i + 1}" for i in range(len(hidden))]
        width = obs_dim
        for name, h in zip(self.hidden_names, hidden):
            layer = nn.Linear(width, h)
            fanin_init(layer, generator)
            self.add_module(name, layer)
            width = h
        self.out = nn.Linear(width, act_dim)
        scaled_normal(self.out, final_init_std, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for name in self.hidden_names:
            x = torch.relu(getattr(self, name)(x))
        return torch.tanh(self.out(x))
