"""Exploration noise with explicit state.

Counterpart of ``d4pg_tpu/core/noise.py``: epsilon-scaled Gaussian noise
and an Ornstein-Uhlenbeck process, each with the decay schedule
``eps = min_eps + (1 - min_eps) * exp(-decay * k)`` advanced on episode
reset, ``decay = 5 / horizon``. The state is a small tuple of tensors
(``batch_shape`` leading dimensions for a vector of environments), so an
acting loop threads it as the reference does.

The reference draws its normals from ``jax.random`` keys; here ``sample``
draws them from a ``torch.Generator``, or takes the standard-normal draw
itself as ``normal`` (the tests inject the same draw into both packages).
The reference's documented divergence from the original code carries
over: the decay schedule runs on reset, starting from eps_0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from d4pg_tpu_torch import resolve_device


def _epsilon(k: torch.Tensor, min_epsilon: float,
             decay_rate: float) -> torch.Tensor:
    return min_epsilon + (1.0 - min_epsilon) * torch.exp(-decay_rate * k)


def _standard_normal(shape, generator: torch.Generator | None,
                     normal: torch.Tensor | None,
                     device: torch.device) -> torch.Tensor:
    if normal is not None:
        if tuple(normal.shape) != tuple(shape):
            raise ValueError(f"normal must be {tuple(shape)}, got "
                             f"{tuple(normal.shape)}")
        return normal
    if generator is None:
        raise ValueError("sample needs a generator or an injected normal")
    return torch.randn(shape, generator=generator, device=device)


class GaussianNoiseState(NamedTuple):
    """State of epsilon-decayed Gaussian action noise."""

    epsilon: torch.Tensor  # float32 [batch_shape] current scale
    resets: torch.Tensor  # int32 [batch_shape] reset counter


class gaussian:
    """eps * N(mu, sigma^2) per action dimension."""

    @staticmethod
    def init(horizon: int = 5000, epsilon_0: float = 0.3,
             batch_shape: tuple = (),
             device: str | torch.device | None = None) -> GaussianNoiseState:
        del horizon  # the decay rate is recomputed in reset()
        dev = resolve_device(device)
        return GaussianNoiseState(
            epsilon=torch.full(batch_shape, epsilon_0, dtype=torch.float32,
                               device=dev),
            resets=torch.zeros(batch_shape, dtype=torch.int32, device=dev))

    @staticmethod
    def sample(state: GaussianNoiseState,
               generator: torch.Generator | None, shape: tuple,
               mu: float = 0.0, sigma: float = 1.0, *,
               normal: torch.Tensor | None = None) -> torch.Tensor:
        eps = state.epsilon.reshape(
            tuple(state.epsilon.shape)
            + (1,) * (len(shape) - state.epsilon.dim()))
        z = _standard_normal(shape, generator, normal, eps.device)
        return eps * (mu + sigma * z)

    @staticmethod
    def reset(state: GaussianNoiseState, horizon: int = 5000,
              min_epsilon: float = 0.01) -> GaussianNoiseState:
        """Advance the decay schedule by one episode."""
        k = state.resets + 1
        return GaussianNoiseState(
            epsilon=_epsilon(k.to(torch.float32), min_epsilon, 5.0 / horizon),
            resets=k)


class OUNoiseState(NamedTuple):
    """State of an Ornstein-Uhlenbeck process with epsilon decay."""

    x: torch.Tensor  # float32 [batch_shape, act_dim] mean-reverting state
    epsilon: torch.Tensor  # float32 [batch_shape] scale
    resets: torch.Tensor  # int32 [batch_shape] reset counter


class ou:
    """Temporally correlated OU noise,
    ``x += theta * (mu - x) * dt + sigma * sqrt(dt) * N(0, I)``, scaled by
    a decaying epsilon."""

    @staticmethod
    def init(act_dim: int, batch_shape: tuple = (), epsilon_0: float = 1.0,
             device: str | torch.device | None = None) -> OUNoiseState:
        dev = resolve_device(device)
        return OUNoiseState(
            x=torch.zeros((*batch_shape, act_dim), dtype=torch.float32,
                          device=dev),
            epsilon=torch.full(batch_shape, epsilon_0, dtype=torch.float32,
                               device=dev),
            resets=torch.zeros(batch_shape, dtype=torch.int32, device=dev))

    @staticmethod
    def sample(state: OUNoiseState, generator: torch.Generator | None,
               theta: float = 0.25, mu: float = 0.0, sigma: float = 0.05,
               dt: float = 0.01, *, normal: torch.Tensor | None = None,
               ) -> tuple[OUNoiseState, torch.Tensor]:
        """Advance the process one step; returns ``(new_state,
        epsilon * x)``."""
        z = _standard_normal(state.x.shape, generator, normal, state.x.device)
        # float32 sqrt(dt), as the reference rounds it
        sqrt_dt = torch.sqrt(torch.tensor(dt, dtype=torch.float32,
                                          device=state.x.device))
        x = state.x + theta * (mu - state.x) * dt + sigma * sqrt_dt * z
        return state._replace(x=x), state.epsilon[..., None] * x

    @staticmethod
    def reset(state: OUNoiseState, horizon: int = 5000,
              min_epsilon: float = 0.01) -> OUNoiseState:
        """Zero the process and advance the epsilon decay."""
        k = state.resets + 1
        return OUNoiseState(
            x=torch.zeros_like(state.x),
            epsilon=_epsilon(k.to(torch.float32), min_epsilon, 5.0 / horizon),
            resets=k)
