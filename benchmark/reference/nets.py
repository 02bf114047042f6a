"""The plain pieces the families' networks are built from, as functions of
named parameter tensors.

Parameter names follow the published Flax tree that the program keeps
(``fc1`` .. ``fcN``, ``out``, ``head``; ``encoder.conv1`` ..
``encoder.conv4``, ``encoder.proj``, ``encoder.ln``), so one dict of
tensors describes a network for the program and for this reference. A
family (``families/<family>.py``) puts them together.

  - MLP policy: ReLU hidden layers, tanh output.
  - Critic torso: ``fc1`` on the state, the action joined after it, the
    other hidden layers with ReLU, a linear head of ``n_atoms`` logits
    whose softmax is the value distribution.
  - Pixel encoder (DrQ-v2): frames [B, H, W, C] uint8 scaled by 1/255,
    3x3 convolutions (the first at stride 2) with XLA's ``SAME`` padding
    (the odd pixel after) and ReLU, flattened in (h, w, c) order, a
    linear projection, LayerNorm (epsilon 1e-6) and tanh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def mlp_layout(prefix: str, width_in: int, hidden, out_name: str,
               out_width: int, action: int = 0) -> dict[str, tuple]:
    """``{name: shape}`` of an MLP over ``width_in`` features; with
    ``action`` > 0 the critic torso, whose action joins after ``fc1``."""
    hidden = list(hidden)
    out = {}
    widths_in = [width_in, hidden[0] + action, *hidden[1:-1]]
    for i, (w_in, h) in enumerate(zip(widths_in, hidden)):
        out[f"{prefix}fc{i + 1}.weight"] = (h, w_in)
        out[f"{prefix}fc{i + 1}.bias"] = (h,)
    out[f"{prefix}{out_name}.weight"] = (out_width, hidden[-1])
    out[f"{prefix}{out_name}.bias"] = (out_width,)
    return out


def encoder_layout(obs_shape, channels, latent: int) -> dict[str, tuple]:
    """``{name: shape}`` of the ``SAME``-padded pixel encoder."""
    enc = {}
    h, w, c = obs_shape
    for i, ch in enumerate(channels):
        stride = 2 if i == 0 else 1
        enc[f"encoder.conv{i + 1}.weight"] = (ch, c, 3, 3)
        enc[f"encoder.conv{i + 1}.bias"] = (ch,)
        h, w, c = -(-h // stride), -(-w // stride), ch
    enc["encoder.proj.weight"] = (latent, h * w * c)
    enc["encoder.proj.bias"] = (latent,)
    enc["encoder.ln.weight"] = (latent,)
    enc["encoder.ln.bias"] = (latent,)
    return enc


def init_scale(name: str, shape: tuple, cfg: dict, net: str) -> tuple:
    """(kind, std) of the benchmark's initial draw for one leaf: every
    kernel and convolution N(0, 1/sqrt(fan_in)), the output layers too
    (rather than D4PG's N(0, 3e-3) and N(0, 3e-4) starting heads, under
    which the outputs hardly depend on the features, so that a lower
    precision of the products shows in the losses and the gradients),
    biases zero, LayerNorm scale one."""
    if name.endswith("ln.weight"):
        return "one", 0.0
    if name.endswith(".bias"):
        return "zero", 0.0
    return "normal", 1.0 / math.sqrt(math.prod(shape[1:]))


def mlp(p: dict, prefix: str, x: torch.Tensor, n_hidden: int,
        action: torch.Tensor | None = None) -> torch.Tensor:
    for i in range(n_hidden):
        name = f"{prefix}fc{i + 1}"
        x = torch.relu(F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"]))
        if i == 0 and action is not None:
            x = torch.cat([x, action], dim=-1)
    return x


def policy(p: dict, prefix: str, x: torch.Tensor,
           n_hidden: int) -> torch.Tensor:
    """pi(x) in (-1, 1)^act_dim."""
    x = mlp(p, prefix, x, n_hidden)
    return torch.tanh(F.linear(x, p[f"{prefix}out.weight"],
                               p[f"{prefix}out.bias"]))


def critic_probs(p: dict, prefix: str, x: torch.Tensor,
                 action: torch.Tensor, n_hidden: int) -> torch.Tensor:
    """Z(x, a) as [B, n_atoms] probabilities."""
    x = mlp(p, prefix, x, n_hidden, action)
    logits = F.linear(x, p[f"{prefix}head.weight"], p[f"{prefix}head.bias"])
    return torch.softmax(logits, dim=-1)


def _same_pads(size: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + 3 - size, 0)
    return total // 2, total - total // 2


def encoder(p: dict, frames: torch.Tensor, channels) -> torch.Tensor:
    """[B, H, W, C] uint8 frames -> [B, latent] float32. An even padding
    goes to the convolution itself and an uneven one is added first, and
    the divisor is a 0-dim tensor on the frames' device, as the port
    computes them, so that the convolution library solves the same
    problems (a division by a Python scalar is a product with its
    reciprocal on CUDA, an ulp off)."""
    x = frames.to(torch.float32) / torch.full((), 255.0, device=frames.device)
    x = x.permute(0, 3, 1, 2)
    for i in range(len(channels)):
        stride = 2 if i == 0 else 1
        (top, bottom), (left, right) = (_same_pads(x.shape[2], stride),
                                        _same_pads(x.shape[3], stride))
        padding = (top, left)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
        x = torch.relu(F.conv2d(x, p[f"encoder.conv{i + 1}.weight"],
                                p[f"encoder.conv{i + 1}.bias"],
                                stride=stride, padding=padding))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.linear(x, p["encoder.proj.weight"], p["encoder.proj.bias"])
    x = F.layer_norm(x, (x.shape[-1],), p["encoder.ln.weight"],
                     p["encoder.ln.bias"], LN_EPS)
    return torch.tanh(x)
