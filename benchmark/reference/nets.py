"""Actor and critic networks as functions of named parameter tensors.

Parameter names follow the published Flax tree that the program keeps
(``fc1`` .. ``fcN``, ``out``, ``head``; ``encoder.conv1`` ..
``encoder.conv4``, ``encoder.proj``, ``encoder.ln``), so one dict of
tensors describes a network for the program and for this reference.

  - MLP actor: ReLU hidden layers, tanh output.
  - Critic: ``fc1`` on the state, the action joined after it, the other
    hidden layers with ReLU, a linear head of ``n_atoms`` logits whose
    softmax is the value distribution.
  - Pixel encoder (DrQ-v2): frames [B, H, W, C] uint8 scaled by 1/255,
    four 3x3 convolutions (the first at stride 2) with XLA's ``SAME``
    padding (the odd pixel after) and ReLU, flattened in (h, w, c) order,
    a linear projection, LayerNorm (epsilon 1e-6) and tanh. The pixel
    actor and critic put their MLP (``actor.*``, ``critic.*``) on top.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def layout(cfg: dict) -> dict[str, dict[str, tuple]]:
    """``{"actor": {name: shape}, "critic": {name: shape}}`` of a
    configuration (the harness's config file)."""
    hidden = list(cfg["hidden"])
    act = int(cfg["act_dim"])

    def mlp(prefix, width_in, out_name, out_width, critic):
        out = {}
        widths_in = ([width_in, hidden[0] + act, *hidden[1:-1]] if critic
                     else [width_in, *hidden[:-1]])
        for i, (w_in, h) in enumerate(zip(widths_in, hidden)):
            out[f"{prefix}fc{i + 1}.weight"] = (h, w_in)
            out[f"{prefix}fc{i + 1}.bias"] = (h,)
        out[f"{prefix}{out_name}.weight"] = (out_width, hidden[-1])
        out[f"{prefix}{out_name}.bias"] = (out_width,)
        return out

    if not cfg.get("pixels"):
        obs = int(cfg["obs_dim"])
        return {"actor": mlp("", obs, "out", act, False),
                "critic": mlp("", obs, "head", int(cfg["n_atoms"]), True)}
    enc = {}
    h, w, c = cfg["obs_shape"]
    for i, ch in enumerate(cfg["encoder_channels"]):
        stride = 2 if i == 0 else 1
        enc[f"encoder.conv{i + 1}.weight"] = (ch, c, 3, 3)
        enc[f"encoder.conv{i + 1}.bias"] = (ch,)
        h, w, c = -(-h // stride), -(-w // stride), ch
    latent = int(cfg["latent_dim"])
    enc["encoder.proj.weight"] = (latent, h * w * c)
    enc["encoder.proj.bias"] = (latent,)
    enc["encoder.ln.weight"] = (latent,)
    enc["encoder.ln.bias"] = (latent,)
    return {"actor": {**enc, **mlp("actor.", latent, "out", act, False)},
            "critic": {**enc, **mlp("critic.", latent, "head",
                                    int(cfg["n_atoms"]), True)}}


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


def _mlp(p: dict, prefix: str, x: torch.Tensor, n_hidden: int,
         action: torch.Tensor | None = None) -> torch.Tensor:
    for i in range(n_hidden):
        name = f"{prefix}fc{i + 1}"
        x = torch.relu(F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"]))
        if i == 0 and action is not None:
            x = torch.cat([x, action], dim=-1)
    return x


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


def actor(p: dict, obs: torch.Tensor, cfg: dict) -> torch.Tensor:
    """pi(s) in (-1, 1)^act_dim. The pixel actor's encoder output is
    detached: with the encoder shared, the critic loss alone trains it."""
    n = len(cfg["hidden"])
    prefix = ""
    if cfg.get("pixels"):
        obs = encoder(p, obs, cfg["encoder_channels"]).detach()
        prefix = "actor."
    x = _mlp(p, prefix, obs, n)
    return torch.tanh(F.linear(x, p[f"{prefix}out.weight"],
                               p[f"{prefix}out.bias"]))


def critic_probs(p: dict, obs: torch.Tensor, action: torch.Tensor,
                 cfg: dict) -> torch.Tensor:
    """Z(s, a) as [B, n_atoms] probabilities."""
    n = len(cfg["hidden"])
    prefix = ""
    if cfg.get("pixels"):
        obs = encoder(p, obs, cfg["encoder_channels"])
        prefix = "critic."
    x = _mlp(p, prefix, obs, n, action)
    logits = F.linear(x, p[f"{prefix}head.weight"], p[f"{prefix}head.bias"])
    return torch.softmax(logits, dim=-1)
