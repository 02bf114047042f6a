"""Categorical distributional critic Z(s, a).

Counterpart of ``d4pg_tpu/models/critic.py``'s ``CategoricalCritic``:
state through ``fc1``, the action concatenated after it, the remaining
hidden layers with ReLU, then an ``n_atoms``-way softmax head (fan-in init
on hidden kernels, N(0, 3e-4) on the head). It returns probabilities, or
logits on request. Layer names follow the Flax module's torso
(``fc1`` .. ``fcN``) and ``head``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from d4pg_tpu_torch.models.init import fanin_init, scaled_normal


class CategoricalCritic(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, n_atoms: int = 51,
                 hidden: Sequence[int] = (256, 256, 256),
                 final_init_std: float = 3e-4,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_names = [f"fc{i + 1}" for i in range(len(hidden))]
        widths_in = [obs_dim, hidden[0] + act_dim, *hidden[1:-1]]
        for name, w_in, h in zip(self.hidden_names, widths_in, hidden):
            layer = nn.Linear(w_in, h)
            fanin_init(layer, generator)
            self.add_module(name, layer)
        # with one hidden layer the torso ends at the concatenation
        torso_out = hidden[-1] if len(hidden) > 1 else hidden[0] + act_dim
        self.head = nn.Linear(torso_out, n_atoms)
        scaled_normal(self.head, final_init_std, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor,
                return_logits: bool = False) -> torch.Tensor:
        x = torch.relu(self.fc1(obs))
        x = torch.cat([x, action], dim=-1)
        for name in self.hidden_names[1:]:
            x = torch.relu(getattr(self, name)(x))
        logits = self.head(x)
        return logits if return_logits else torch.softmax(logits, dim=-1)
