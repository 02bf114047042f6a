"""Convolutional pixel encoder and the pixel actor and critic.

Counterpart of ``d4pg_tpu/models/encoder.py``: four 3x3 convolutions of
``channels`` (stride 2, then 1) with ReLU, flattened through a linear
projection, LayerNorm and tanh into a ``latent_dim`` latent that feeds
the MLP actor or critic. Frames are [..., H, W, C] (uint8 or float);
the encoder casts them to the compute dtype and divides by 255.

Matching Flax:

  - ``nn.Conv`` pads ``SAME``, with the odd pixel after
    (``layers.same_padding``): stride 2 on 84 px pads (0, 1) and gives
    42 px, and every stride-1 layer pads 1 on each side;
  - the convolutions run NCHW (channels-last strides, cuDNN's preferred
    layout for them) and the activations go back to NHWC before the
    flatten, so ``proj``'s input rows are in Flax's (h, w, c) order;
  - LayerNorm's epsilon is Flax's 1e-6; its statistics are float32 and
    its output is cast to the compute dtype; the latent comes back as
    float32.

Parameter names follow the Flax tree: ``encoder.conv1`` ..
``encoder.conv4``, ``encoder.proj``, ``encoder.ln``, then ``actor.*`` or
``critic.*``.

CURL's encoder (``padding='valid', tanh=False``, Srinivas,
Laskin and Abbeel 2020, ``curl_sac.py``'s ``PixelEncoder``) pads
nothing (84 px give maps of 41, 39, 37 and 35) and ends at the
LayerNorm (``output_logits=True``). The encoder is two halves:
``conv_map`` (the convolutions, flattened) and ``trunk`` (``proj``,
``ln`` and the tanh). What a pixel actor shares with the critic
(``D4PGConfig.shares``) picks the seam: ``shared_part`` runs the
shared half once (the conv map for ``"convs"``, CURL's; the whole
latent for ``"encoder"``, ``--share_encoder``'s) and ``own_part`` is
each network's own half on top (the trunk, or nothing). Where the
actor's gradient stops is the update's to say (``learner/update.py``);
``PixelActor`` is ``actor(encoder(pixels))``, after the center crop
that CURL's actor takes of the stored frames, as CURL's
``select_action`` does (``crop``).

On a ``{data, model}`` mesh (``parallel/model_axis.py``) each model rank
holds its out-channel slice of ``conv1`` .. ``conv4`` and
``model_axis`` is set: each convolution's input enters the model region
and its ReLU output is gathered back to all channels before the next
layer reads it. Without one (``model_axis is None``) the encoder is the
whole one. Each forward, and each ``shared_part``, is one
``model.encoder`` span (``io/profiling.span``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from d4pg_tpu_torch.io.profiling import span
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.models.critic import CategoricalCritic
from d4pg_tpu_torch.models.init import lecun_normal
from d4pg_tpu_torch.models.layers import conv_same, dense, same_padding
from d4pg_tpu_torch.ops.augment import center_crop

LN_EPS = 1e-6  # Flax's LayerNorm epsilon (torch's default is 1e-5)
PADDINGS = ("same", "valid")


class PixelEncoder(nn.Module):
    def __init__(self, obs_shape: Sequence[int], latent_dim: int = 50,
                 channels: Sequence[int] = (32, 32, 32, 32),
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32,
                 padding: str = "same", tanh: bool = True):
        super().__init__()
        if padding not in PADDINGS:
            raise ValueError(f"unknown encoder padding {padding!r}")
        self.dtype = dtype
        self.tanh = bool(tanh)
        self.obs_shape = tuple(int(s) for s in obs_shape)
        h, w, c = self.obs_shape
        self._pads = []
        for i, ch in enumerate(channels):
            stride = 2 if i == 0 else 1
            conv = nn.Conv2d(c, ch, 3, stride=stride)
            lecun_normal(conv, generator)
            self.add_module(f"conv{i + 1}", conv)
            if padding == "same":
                (top, bottom), (left, right) = (same_padding(h, stride, 3),
                                                same_padding(w, stride, 3))
                h, w = -(-h // stride), -(-w // stride)
            else:
                top = bottom = left = right = 0
                h, w = (h - 3) // stride + 1, (w - 3) // stride + 1
            if h < 1 or w < 1:
                raise ValueError(f"{self.obs_shape[:2]} frames are too "
                                 f"small for {len(channels)} unpadded "
                                 f"convolutions")
            self._pads.append((top, bottom, left, right))
            c = ch
        self.proj = nn.Linear(h * w * c, latent_dim)
        lecun_normal(self.proj, generator)
        self.ln = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.model_axis = None  # parallel/model_axis.ModelAxis when split

    @span("model.encoder")
    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """The [..., latent] float32 latent of [..., H, W, C] frames."""
        z = self.trunk(self.conv_map(pixels))
        return z.reshape(*pixels.shape[:-3], -1)

    def shared_part(self, pixels: torch.Tensor, shares: str) -> torch.Tensor:
        """The part of the frames' encoding that ``shares`` ties between
        the actor and the critic: the conv map for ``"convs"``, the latent
        for ``"encoder"``."""
        if shares == "convs":
            with span("model.encoder"):
                return self.conv_map(pixels)
        return self(pixels)

    def own_part(self, h: torch.Tensor, shares: str) -> torch.Tensor:
        """A network's own part on top of ``shared_part``'s ``h``: the
        trunk for ``"convs"``, the identity for ``"encoder"``."""
        return self.trunk(h) if shares == "convs" else h

    def conv_map(self, pixels: torch.Tensor) -> torch.Tensor:
        """The convolutions' [N, h * w * c] maps of [..., H, W, C] frames
        (N the frames), flattened in Flax's (h, w, c) order."""
        dt = self.dtype
        x = pixels.reshape(-1, *self.obs_shape).to(dt)
        # a 0-dim divisor made on the device: a Python scalar becomes a
        # multiply by its reciprocal on CUDA (an ulp off the quotient), and
        # a tensor copied from the host would sync the host per forward
        x = x / torch.full((), 255.0, dtype=dt, device=x.device)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        axis = self.model_axis
        for i, pads in enumerate(self._pads):
            conv = getattr(self, f"conv{i + 1}")
            if axis is None:
                x = torch.relu(conv_same(conv, x, pads, dt))
            else:  # column-parallel: this rank's out-channels, gathered
                x = axis.gather(torch.relu(conv_same(conv, axis.enter(x),
                                                     pads, dt)))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # Flax's order

    def trunk(self, h: torch.Tensor) -> torch.Tensor:
        """The [N, latent] float32 latent of [N, h * w * c] conv maps."""
        dt = self.dtype
        x = dense(self.proj, h, dt)
        x = F.layer_norm(x.float(), self.ln.normalized_shape, self.ln.weight,
                         self.ln.bias, self.ln.eps).to(dt)
        if self.tanh:
            x = torch.tanh(x)
        return x.float()


class PixelActor(nn.Module):
    """Encoder + MLP actor for pixel observations."""

    def __init__(self, obs_shape: Sequence[int], act_dim: int,
                 latent_dim: int = 50,
                 channels: Sequence[int] = (32, 32, 32, 32),
                 hidden: Sequence[int] = (256, 256, 256),
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32,
                 padding: str = "same", tanh: bool = True,
                 crop: int | None = None):
        super().__init__()
        self.crop = crop
        if crop is not None:
            obs_shape = (crop, crop, obs_shape[-1])
        self.encoder = PixelEncoder(obs_shape, latent_dim, channels,
                                    generator, dtype, padding, tanh)
        self.actor = Actor(latent_dim, act_dim, hidden, generator=generator,
                           dtype=dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        if self.crop is not None:
            pixels = center_crop(pixels, self.crop)
        return self.actor(self.encoder(pixels))


class PixelCategoricalCritic(nn.Module):
    """Encoder + categorical critic for pixel observations."""

    def __init__(self, obs_shape: Sequence[int], act_dim: int,
                 n_atoms: int = 51, latent_dim: int = 50,
                 channels: Sequence[int] = (32, 32, 32, 32),
                 hidden: Sequence[int] = (256, 256, 256),
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32,
                 padding: str = "same", tanh: bool = True):
        super().__init__()
        self.encoder = PixelEncoder(obs_shape, latent_dim, channels,
                                    generator, dtype, padding, tanh)
        self.critic = CategoricalCritic(latent_dim, act_dim, n_atoms, hidden,
                                        generator=generator, dtype=dtype)

    def forward(self, pixels: torch.Tensor, action: torch.Tensor,
                return_logits: bool = False) -> torch.Tensor:
        return self.critic(self.encoder(pixels), action, return_logits)
