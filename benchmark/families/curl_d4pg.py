"""The D4PG family with CURL's contrastive pixel encoder
(``configs/cheetah-curl-d4pg.json``).

Its interface is ``families/mlp_d4pg.py``'s, whose program config,
losses and initial draw it extends. The actor and the critic each put
their MLP (``actor.*``, ``critic.*``) on an unpadded encoder without
tanh (``encoder.*``) over 84x84 crops of the stored 100x100 frames; the
actor's convolutions are the critic's, its trunk (``encoder.proj``,
``encoder.ln``) its own. Besides actor and critic the step keeps two
Adams, so the check compares four networks: ``encoder`` (the critic's
encoder under CURL's ``encoder_optimizer``) and ``curl`` (``W`` and the
critic's encoder under its ``cpc_optimizer``), neither with a target.
The update's own draws are the three crops of each step, obs, next_obs
and pos, in that order from the state's generator.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from harness import spec
from reference import curl, nets

_heads = spec.plugin("families", "mlp_d4pg")
LOSSES = ("critic_loss", "actor_loss", "curl_loss")
init_scale = _heads.init_scale
Learner = curl.Learner


def program_config(cfg: dict):
    heads = _heads.program_config(dict(cfg,
                                       obs_dim=math.prod(cfg["obs_shape"])))
    return dataclasses.replace(
        heads, pixels=True, obs_shape=tuple(cfg["obs_shape"]),
        encoder_channels=tuple(cfg["encoder_channels"]),
        crop_size=int(cfg["crop_size"]), contrastive=cfg["contrastive"],
        encoder_tau=float(cfg["encoder_tau"]),
        lr_encoder=float(cfg["lr_encoder"]))


def program_nets(state) -> dict:
    nets_ = _heads.program_nets(state)
    nets_["encoder"] = (state.critic.encoder, None, state.encoder_opt)
    nets_["curl"] = (state.curl, None, state.curl_opt)
    return nets_


def _crop_shape(cfg: dict) -> tuple:
    size = int(cfg["crop_size"])
    return (size, size, int(cfg["obs_shape"][-1]))


def layout(cfg: dict) -> dict[str, dict[str, tuple]]:
    act, hidden, latent = int(cfg["act_dim"]), cfg["hidden"], \
        int(cfg["latent_dim"])
    enc = curl.encoder_layout(_crop_shape(cfg), cfg["encoder_channels"],
                              latent)
    return {"actor": {**enc, **nets.mlp_layout("actor.", latent, hidden,
                                               "out", act)},
            "critic": {**enc, **nets.mlp_layout(
                "critic.", latent, hidden, "head", int(cfg["n_atoms"]),
                action=act)},
            "encoder": {k[len(curl.ENCODER):]: v for k, v in enc.items()},
            "curl": {"W": (latent, latent), **enc}}


def tie(params: dict, cfg: dict) -> None:
    """The actor's convolutions and the other two networks' encoder
    leaves become copies of the critic's."""
    critic = params["critic"]
    for k, v in critic.items():
        if k.startswith("encoder.conv"):
            params["actor"][k] = v.clone()
        if k.startswith(curl.ENCODER):
            params["encoder"][k[len(curl.ENCODER):]] = v.clone()
            params["curl"][k] = v.clone()


def observations(cfg: dict, n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """uint8 frames uniform over [0, 255], at the stored size."""
    return torch.randint(0, 256, (n, *cfg["obs_shape"]),
                         generator=generator, device=device,
                         dtype=torch.uint8)


def draws(cfg: dict, traffic: dict, generator: torch.Generator, device,
          steps: int) -> dict:
    """The crop offsets of obs, next_obs and pos of each step, ``crop``
    [steps] -> three [b, 2] in [0, H - crop_size]."""
    b = int(traffic["batch_size"])
    hi = min(cfg["obs_shape"][:2]) - int(cfg["crop_size"]) + 1
    return {"crop": [tuple(torch.randint(0, hi, (b, 2), generator=generator,
                                         device=device)
                           for _ in range(3)) for _ in range(steps)]}


def apply_draws(cfg: dict, row: dict, draws: dict, t: int,
                rows: slice) -> dict:
    obs_off, next_off, pos_off = draws["crop"][t]
    size = int(cfg["crop_size"])
    row["pos"] = curl.crop(row["obs"], size, pos_off[rows])
    row["obs"] = curl.crop(row["obs"], size, obs_off[rows])
    row["next_obs"] = curl.crop(row["next_obs"], size, next_off[rows])
    return row


def tiny(cfg: dict, traffic: dict) -> None:
    cfg.update(obs_shape=[20, 20, 3], crop_size=16,
               encoder_channels=[4, 4, 4, 4],
               hidden=[16] * len(cfg["hidden"]), memory_size=300)
    traffic.update(batch_size=8, k=4, fill_rows=300, fill_block=64)
