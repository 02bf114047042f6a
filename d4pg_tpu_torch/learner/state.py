"""D4PG configuration and learner state.

Counterpart of ``d4pg_tpu/learner/state.py``. The JAX state is one
immutable pytree; here it is a small mutable object holding the online
and target modules, one ``torch.optim.Adam`` per network and the step
counter. Updates mutate it in place.

Adam: ``optax.adam(lr, b1, b2)`` (eps 1e-8, bias-corrected) and
``torch.optim.Adam(lr, betas=(b1, b2), eps=1e-8)`` apply the same update;
their rounding differs in the last bits.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Sequence

import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.core.distribution import CategoricalSupport
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.models.critic import CategoricalCritic

PROJECTIONS = ("einsum", "pallas", "pallas_ce")


@dataclasses.dataclass(frozen=True)
class D4PGConfig:
    """The categorical subset of the reference's ``D4PGConfig``.

    ``projection`` keeps the reference's arm names so a reference config
    carries over. ``einsum`` runs the plain ``categorical_projection`` on
    every device and ``pallas`` ``ops.projection.projection`` (the CUDA
    kernel for tensors on the card, its plain version for tensors on the
    CPU), each then the cross-entropy. ``pallas_ce`` fuses the projection into the cross-entropy
    (``ops.projection_ce.projection_ce``: forward and backward CUDA
    kernels on the card, the plain version on the CPU). Like the
    reference's field it must be concrete: ``auto`` is resolved first by
    ``ops.autotune.select_projection``."""

    obs_dim: int
    act_dim: int
    v_min: float = -300.0
    v_max: float = 0.0
    n_atoms: int = 51
    hidden: Sequence[int] = (256, 256, 256)
    lr_actor: float = 1e-4
    lr_critic: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    tau: float = 0.001
    gamma: float = 0.99
    action_l2: float = 0.0
    projection: str = "pallas"

    def __post_init__(self):
        object.__setattr__(self, "hidden", tuple(self.hidden))
        if self.projection not in PROJECTIONS:
            raise ValueError(f"unknown projection {self.projection!r}")

    @property
    def support(self) -> CategoricalSupport:
        return CategoricalSupport(self.v_min, self.v_max, self.n_atoms)

    def build_actor(self, generator: torch.Generator) -> Actor:
        return Actor(self.obs_dim, self.act_dim, self.hidden,
                     generator=generator)

    def build_critic(self, generator: torch.Generator) -> CategoricalCritic:
        return CategoricalCritic(self.obs_dim, self.act_dim, self.n_atoms,
                                 self.hidden, generator=generator)

    def optimizer(self, module: torch.nn.Module,
                  lr: float) -> torch.optim.Adam:
        return torch.optim.Adam(module.parameters(), lr=lr,
                                betas=(self.adam_b1, self.adam_b2), eps=1e-8)


@dataclasses.dataclass
class D4PGState:
    """The complete learner state. ``step`` is a host int: the fused chunk
    reads it for the PER beta schedule without a device sync."""

    actor: Actor
    critic: CategoricalCritic
    target_actor: Actor
    target_critic: CategoricalCritic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.actor.out.weight.device


def init_state(config: D4PGConfig, seed: int = 0,
               device: str | torch.device | None = None) -> D4PGState:
    """Fresh networks (drawn on the CPU from ``seed``, then moved, so a seed
    gives the same weights on every device), targets as hard copies, and
    Adam states. ``device`` defaults to ``cuda`` and raises without a card."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    actor = config.build_actor(gen).to(dev)
    critic = config.build_critic(gen).to(dev)
    return D4PGState(
        actor=actor,
        critic=critic,
        target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=config.optimizer(actor, config.lr_actor),
        critic_opt=config.optimizer(critic, config.lr_critic),
    )
