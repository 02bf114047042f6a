"""Distributional critic networks Z(s, a).

Counterpart of ``d4pg_tpu/models/critic.py``: state through ``fc1``, the
action concatenated after it, the remaining hidden layers with ReLU
(fan-in init on hidden kernels), then a distribution head with N(0, 3e-4)
init:

  - ``CategoricalCritic``: an ``n_atoms``-way softmax; it returns
    probabilities, or logits on request;
  - ``MixtureOfGaussianCritic``: a ``3 * n_components`` head split into
    component logits (log-softmaxed), means and ``softplus + min_std``
    standard deviations (``MoGParams``).

Layer names follow the Flax modules' torso (``fc1`` .. ``fcN``) and
``head``. ``dtype`` is the compute dtype: the torso and head run in it,
the action is cast before the concatenation, and the head's output goes
back to float32 before the softmax or the mixture split, as in Flax.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from d4pg_tpu_torch.models.init import fanin_init, scaled_normal
from d4pg_tpu_torch.models.layers import dense


class _Critic(nn.Module):
    """The shared torso s -> fc1 -> [., a] -> fc2 .. fcN and a
    ``head_width`` linear head."""

    def __init__(self, obs_dim: int, act_dim: int, head_width: int,
                 hidden: Sequence[int], final_init_std: float,
                 generator: torch.Generator | None, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.hidden_names = [f"fc{i + 1}" for i in range(len(hidden))]
        widths_in = [obs_dim, hidden[0] + act_dim, *hidden[1:-1]]
        for name, w_in, h in zip(self.hidden_names, widths_in, hidden):
            layer = nn.Linear(w_in, h)
            fanin_init(layer, generator)
            self.add_module(name, layer)
        # with one hidden layer the torso ends at the concatenation
        torso_out = hidden[-1] if len(hidden) > 1 else hidden[0] + act_dim
        self.head = nn.Linear(torso_out, head_width)
        scaled_normal(self.head, final_init_std, generator)

    def head_out(self, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        """The head's output [..., head_width] in float32."""
        dt = self.dtype
        x = torch.relu(dense(self.fc1, obs, dt))
        x = torch.cat([x, action.to(dt)], dim=-1)
        for name in self.hidden_names[1:]:
            x = torch.relu(dense(getattr(self, name), x, dt))
        return dense(self.head, x, dt).float()


class CategoricalCritic(_Critic):
    def __init__(self, obs_dim: int, act_dim: int, n_atoms: int = 51,
                 hidden: Sequence[int] = (256, 256, 256),
                 final_init_std: float = 3e-4,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(obs_dim, act_dim, n_atoms, hidden, final_init_std,
                         generator, dtype)

    def forward(self, obs: torch.Tensor, action: torch.Tensor,
                return_logits: bool = False) -> torch.Tensor:
        logits = self.head_out(obs, action)
        return logits if return_logits else torch.softmax(logits, dim=-1)


class MoGParams(NamedTuple):
    """Parameters of a K-component Gaussian mixture over returns."""

    log_weights: torch.Tensor  # [..., K] log mixture weights (log-softmaxed)
    means: torch.Tensor  # [..., K]
    stds: torch.Tensor  # [..., K] (positive)


class MixtureOfGaussianCritic(_Critic):
    def __init__(self, obs_dim: int, act_dim: int, n_components: int = 5,
                 hidden: Sequence[int] = (256, 256, 256),
                 final_init_std: float = 3e-4, min_std: float = 1e-3,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(obs_dim, act_dim, 3 * n_components, hidden,
                         final_init_std, generator, dtype)
        self.min_std = float(min_std)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> MoGParams:
        logits, means, raw_std = self.head_out(obs, action).chunk(3, dim=-1)
        return MoGParams(log_weights=torch.log_softmax(logits, dim=-1),
                         means=means,
                         stds=F.softplus(raw_std) + self.min_std)
