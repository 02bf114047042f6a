"""D4PG configuration and learner state.

Counterpart of ``d4pg_tpu/learner/state.py``. The JAX state is one
immutable pytree; here it is a small mutable object holding the online
and target modules, one ``torch.optim.Adam`` per network, the step
counter and the state's ``torch.Generator`` (the reference's ``key``).
Updates mutate it in place.

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
from d4pg_tpu_torch.core.updates import tie_shared
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.models.critic import (
    CategoricalCritic,
    MixtureOfGaussianCritic,
)
from d4pg_tpu_torch.models.contrastive import CURL
from d4pg_tpu_torch.models.encoder import PixelActor, PixelCategoricalCritic
from d4pg_tpu_torch.models.layers import COMPUTE_DTYPES

PROJECTIONS = ("einsum", "pallas", "pallas_ce")


@dataclasses.dataclass(frozen=True)
class D4PGConfig:
    """The reference's ``D4PGConfig``, field for field.

    ``projection`` keeps the reference's arm names so a reference config
    carries over. ``einsum`` runs the plain ``categorical_projection`` on
    every device and ``pallas`` ``ops.projection.projection`` (the CUDA
    kernel for tensors on the card, its plain version for tensors on the
    CPU), each then the cross-entropy. ``pallas_ce`` fuses the projection
    into the cross-entropy (``ops.projection_ce.projection_ce``: forward
    and backward CUDA kernels on the card, the plain version on the CPU).
    Like the reference's field it must be concrete: ``auto`` is resolved
    first by ``ops.autotune.select_projection``. The MoG family ignores
    it.

    ``critic_family`` is ``categorical`` or ``mog`` (``n_components``,
    ``mog_samples``). ``compute_dtype`` (``float32`` or ``bfloat16``) is
    the dtype of the network products; parameters, Adam state, losses
    and the kernels' operands stay float32. ``pixels`` selects the conv
    encoder over [H, W, C] frames (``obs_shape``, ``encoder_channels``),
    with the DrQ shift (``augment='shift'``, ``augment_pad``) and the
    shared encoder (``share_encoder``) as options.

    CURL (``contrastive='curl'``) brings, with no option of its own:
    three random ``crop_size`` crops of the stored ``obs_shape`` frames
    a step in place of ``augment`` (the actor center-crops when it
    acts), CURL's encoder (unpadded convolutions, no tanh after the
    LayerNorm), the actor's own trunk over the critic's convolutions
    (``shares``), the target critic's encoder as the momentum key
    encoder (``encoder_tau`` on every ``encoder.`` leaf, ``tau`` on the
    heads) and the contrastive step with two Adams at ``lr_encoder``
    (``learner/update.py``). It runs on
    one learner: the data-parallel learner, the model axis, the replica
    group and MoG refuse it."""

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
    critic_family: str = "categorical"  # 'categorical' | 'mog'
    n_components: int = 5
    mog_samples: int = 32
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    pixels: bool = False
    obs_shape: tuple = ()  # [H, W, C] when pixels=True
    encoder_channels: tuple = (32, 32, 32, 32)
    augment: str = "none"  # 'none' | 'shift'
    augment_pad: int = 4
    share_encoder: bool = False
    crop_size: int = 84
    contrastive: str = "none"  # 'none' | 'curl'
    encoder_tau: float = 0.05
    lr_encoder: float = 1e-3

    def __post_init__(self):
        object.__setattr__(self, "hidden", tuple(self.hidden))
        object.__setattr__(self, "obs_shape", tuple(self.obs_shape))
        object.__setattr__(self, "encoder_channels",
                           tuple(self.encoder_channels))
        if self.critic_family not in ("categorical", "mog"):
            raise ValueError(f"unknown critic_family {self.critic_family!r}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.projection not in PROJECTIONS:
            raise ValueError(f"unknown projection {self.projection!r}")
        if self.augment not in ("none", "shift"):
            raise ValueError(f"unknown augment {self.augment!r}")
        if self.contrastive not in ("none", "curl"):
            raise ValueError(f"unknown contrastive {self.contrastive!r}")
        if self.augment != "none" and not self.pixels:
            raise ValueError(
                "--augment is an image augmentation; it requires the "
                "pixel (conv-encoder) observation path")
        if self.augment != "none" and self.augment_pad < 1:
            raise ValueError(
                f"--augment {self.augment} with augment_pad="
                f"{self.augment_pad} would silently train UNaugmented; "
                "set a positive shift radius (or --augment none)")
        if self.share_encoder and not (
                self.pixels and self.critic_family == "categorical"):
            raise ValueError(
                "--share_encoder ties the actor's conv encoder to the "
                "critic's; it requires the pixel path with the "
                "categorical critic")
        if self.pixels and self.critic_family == "mog":
            # the reference builds its vector MoG critic over the frames
            # and fails in the first forward; refuse it up front
            raise ValueError(
                "--critic_family mog has no pixel encoder; the pixel path "
                "takes the categorical critic")
        if self.pixels and len(self.obs_shape) != 3:
            raise ValueError(f"pixels=True needs obs_shape [H, W, C], got "
                             f"{self.obs_shape}")
        if self.contrastive == "curl":
            if self.critic_family != "categorical":
                raise ValueError(
                    "--contrastive curl trains the categorical critic's "
                    "pixel encoder; --critic_family mog has none")
            if not self.pixels:
                raise ValueError(
                    "--contrastive curl contrasts crops of frames; it "
                    "requires the pixel (conv-encoder) observation path")
            if self.augment != "none":
                raise ValueError(
                    "--contrastive curl augments with its own random "
                    "crops; drop --augment")
            if not 0 < self.crop_size <= min(self.obs_shape[:2]):
                raise ValueError(
                    f"--crop_size {self.crop_size} does not fit the "
                    f"stored {self.obs_shape[:2]} frames")
            if self.share_encoder:
                raise ValueError(
                    "--contrastive curl ties the convolutions alone (the "
                    "actor keeps its own trunk); drop --share_encoder")

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return COMPUTE_DTYPES[self.compute_dtype]

    @property
    def support(self) -> CategoricalSupport:
        return CategoricalSupport(self.v_min, self.v_max, self.n_atoms)

    @property
    def shares(self) -> str | None:
        """What the pixel actor's encoder shares with the critic's, the
        one value the tie (``core.updates.tie_shared``) and the update's
        tied path (``learner/update.py``) read: ``"convs"`` under CURL
        (its own trunk over the critic's convolutions), ``"encoder"``
        under ``share_encoder`` (the whole encoder), ``None`` otherwise.
        The policy loss trains no shared parameter."""
        if self.contrastive == "curl":
            return "convs"
        return "encoder" if self.share_encoder else None

    @property
    def encoder_shape(self) -> tuple:
        """The [H, W, C] frames the encoders see: CURL's crops, else the
        stored frames."""
        if self.contrastive == "curl":
            return (self.crop_size, self.crop_size, self.obs_shape[-1])
        return tuple(self.obs_shape)

    def _encoder_kwargs(self) -> dict:
        # CURL's encoder pads nothing and ends at the LayerNorm
        curl = self.contrastive == "curl"
        return dict(padding="valid" if curl else "same", tanh=not curl)

    @property
    def obs_spec(self) -> int | tuple:
        """Replay/folder storage spec: [H, W, C] for pixels, else obs_dim."""
        return tuple(self.obs_shape) if self.pixels else self.obs_dim

    def build_actor(self, generator: torch.Generator) -> torch.nn.Module:
        if self.pixels:
            return PixelActor(self.obs_shape, self.act_dim,
                              channels=self.encoder_channels,
                              hidden=self.hidden,
                              generator=generator, dtype=self.dtype,
                              crop=(self.crop_size
                                    if self.contrastive == "curl" else None),
                              **self._encoder_kwargs())
        return Actor(self.obs_dim, self.act_dim, self.hidden,
                     generator=generator, dtype=self.dtype)

    def build_critic(self, generator: torch.Generator) -> torch.nn.Module:
        if self.critic_family == "mog":
            return MixtureOfGaussianCritic(
                self.obs_dim, self.act_dim, self.n_components, self.hidden,
                generator=generator, dtype=self.dtype)
        if self.pixels:
            return PixelCategoricalCritic(
                self.encoder_shape, self.act_dim, self.n_atoms,
                channels=self.encoder_channels, hidden=self.hidden,
                generator=generator, dtype=self.dtype,
                **self._encoder_kwargs())
        return CategoricalCritic(self.obs_dim, self.act_dim, self.n_atoms,
                                 self.hidden, generator=generator,
                                 dtype=self.dtype)

    def optimizer(self, module: torch.nn.Module,
                  lr: float) -> torch.optim.Adam:
        return torch.optim.Adam(module.parameters(), lr=lr,
                                betas=(self.adam_b1, self.adam_b2), eps=1e-8)


@dataclasses.dataclass
class D4PGState:
    """The complete learner state. ``step`` is a host int: the fused chunk
    reads it for the PER beta schedule without a device sync.
    ``generator`` lives on the state's device and takes the place of the
    reference's ``key``: the DrQ offsets and the MoG draws of the updates
    come from it (the checkpoint saves it).

    ``targets_tied`` is a host fact like ``step``: the target encoders'
    shared parts (``D4PGConfig.shares``) are bitwise equal, so one
    forward of that part on ``next_obs`` serves both target heads
    (``learner/update.py``). ``init_state`` and every ``update_step`` set
    it to ``shares is not None``; every path that writes parameters into
    an existing state clears it (``io/checkpoint.restore``,
    ``io/from_jax.state_from_jax``, ``learner/replica.adopt_params``, the
    replicas' merge), so the first step after ``share_encoder`` is turned
    on over an unshared state, or after a restore, runs both target
    encoders, as the reference does.
    ``parallel/data_parallel.replicate_state`` gives every rank rank 0's.

    CURL (``contrastive='curl'``) adds ``curl`` (``models/contrastive.
    CURL``: ``W`` and the critic's encoder), ``encoder_opt`` (CURL's
    ``encoder_optimizer``, over the critic's encoder) and ``curl_opt``
    (its ``cpc_optimizer``, over ``curl``); ``None`` otherwise."""

    actor: torch.nn.Module
    critic: torch.nn.Module
    target_actor: torch.nn.Module
    target_critic: torch.nn.Module
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    step: int = 0
    generator: torch.Generator | None = None
    targets_tied: bool = False
    curl: CURL | None = None
    encoder_opt: torch.optim.Adam | None = None
    curl_opt: torch.optim.Adam | None = None

    @property
    def device(self) -> torch.device:
        return next(self.actor.parameters()).device


def refuse_contrastive(config, what: str) -> None:
    """Raise where ``what`` (the data-parallel learner, the model axis,
    the replica group) would take a CURL ``config`` (a ``D4PGConfig`` or
    the driver's ``ExperimentConfig``): CURL's state and step live on one
    learner."""
    if config.contrastive != "none":
        raise ValueError(
            f"--contrastive {config.contrastive} runs on one learner: "
            f"{what} carries neither CURL's W, encoder_opt and curl_opt "
            "nor its contrastive step")


# the state's stream is seeded apart from a driver's PER stream of the
# same seed
_STATE_STREAM = 1 << 32


def init_state(config: D4PGConfig, seed: int = 0,
               device: str | torch.device | None = None) -> D4PGState:
    """Fresh networks (drawn on the CPU from ``seed``, then moved, so a seed
    gives the same weights on every device), targets as hard copies, Adam
    states and the state's generator. The actor's shared encoder part
    (``config.shares``) is the critic's from step 0, targets included;
    CURL's ``W`` is drawn last. ``device`` defaults to ``cuda`` and
    raises without a card."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    actor = config.build_actor(gen).to(dev)
    critic = config.build_critic(gen).to(dev)
    if config.shares:
        tie_shared(actor, critic, config.shares)
    curl = {}
    if config.contrastive == "curl":
        module = CURL(critic.encoder, critic.encoder.proj.out_features,
                      gen).to(dev)
        curl = dict(curl=module,
                    encoder_opt=config.optimizer(critic.encoder,
                                                 config.lr_encoder),
                    curl_opt=config.optimizer(module, config.lr_encoder))
    return D4PGState(
        actor=actor,
        critic=critic,
        target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=config.optimizer(actor, config.lr_actor),
        critic_opt=config.optimizer(critic, config.lr_critic),
        generator=torch.Generator(device=dev).manual_seed(
            int(seed) + _STATE_STREAM),
        targets_tied=config.shares is not None,
        **curl,
    )
