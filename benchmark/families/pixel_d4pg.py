"""The D4PG family with DrQ's pixel encoder, shared by actor and critic,
and the DrQ shift (``configs/cheetah-pixels-d4pg.json``).

Its interface is ``families/mlp_d4pg.py``'s, whose program config,
networks, losses and initial draw it extends. The actor and the critic
each put their MLP (``actor.*``, ``critic.*``) on the ``SAME``-padded
encoder (``encoder.*``); the actor's encoder output is detached, so the
critic loss alone trains it, and with ``share_encoder`` the actor's
encoder is the critic's after every Adam step and the soft update.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from harness import spec
from reference import d4pg, nets
from reference.augment import shift

# the heads are the MLP family's: its losses, initial draw and program
# networks, and the program config this family extends
_heads = spec.plugin("families", "mlp_d4pg")
LOSSES = _heads.LOSSES
init_scale = _heads.init_scale
program_nets = _heads.program_nets


def program_config(cfg: dict):
    heads = _heads.program_config(dict(cfg,
                                       obs_dim=math.prod(cfg["obs_shape"])))
    return dataclasses.replace(
        heads, pixels=True, obs_shape=tuple(cfg["obs_shape"]),
        encoder_channels=tuple(cfg["encoder_channels"]),
        augment=cfg["augment"], augment_pad=int(cfg["augment_pad"]),
        share_encoder=bool(cfg["share_encoder"]))


def layout(cfg: dict) -> dict[str, dict[str, tuple]]:
    act, hidden, latent = int(cfg["act_dim"]), cfg["hidden"], \
        int(cfg["latent_dim"])
    enc = nets.encoder_layout(cfg["obs_shape"], cfg["encoder_channels"],
                              latent)
    return {"actor": {**enc, **nets.mlp_layout("actor.", latent, hidden,
                                               "out", act)},
            "critic": {**enc, **nets.mlp_layout(
                "critic.", latent, hidden, "head", int(cfg["n_atoms"]),
                action=act)}}


def tie(params: dict, cfg: dict) -> None:
    """With ``share_encoder`` the actor's encoder leaves become copies of
    the critic's."""
    if not cfg["share_encoder"]:
        return
    for name in params["actor"]:
        if name.startswith("encoder."):
            params["actor"][name] = params["critic"][name].clone()


def observations(cfg: dict, n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """uint8 frames uniform over [0, 255]."""
    return torch.randint(0, 256, (n, *cfg["obs_shape"]),
                         generator=generator, device=device,
                         dtype=torch.uint8)


def draws(cfg: dict, traffic: dict, generator: torch.Generator, device,
          steps: int) -> dict:
    """The DrQ offsets of obs and next_obs of each step, ``shift``
    [steps] -> (obs [R b, 2], next_obs [R b, 2]), in [0, 2 pad]."""
    if cfg["augment"] != "shift":
        return {}
    n = int(traffic.get("ranks", 1)) * int(traffic["batch_size"])
    hi = 2 * int(cfg["augment_pad"]) + 1
    return {"shift": [tuple(torch.randint(0, hi, (n, 2), generator=generator,
                                          device=device)
                            for _ in range(2)) for _ in range(steps)]}


def apply_draws(cfg: dict, row: dict, draws: dict, t: int,
                rows: slice) -> dict:
    if "shift" in draws:
        obs_off, next_off = draws["shift"][t]
        pad = int(cfg["augment_pad"])
        row["obs"] = shift(row["obs"], pad, obs_off[rows])
        row["next_obs"] = shift(row["next_obs"], pad, next_off[rows])
    return row


class Learner(d4pg.Learner):
    def actor(self, p, obs):
        latent = nets.encoder(p, obs, self.cfg["encoder_channels"]).detach()
        return nets.policy(p, "actor.", latent, len(self.cfg["hidden"]))

    def critic(self, p, obs, action):
        latent = nets.encoder(p, obs, self.cfg["encoder_channels"])
        return nets.critic_probs(p, "critic.", latent, action,
                                 len(self.cfg["hidden"]))

    def tie(self, params):
        tie(params, self.cfg)


def tiny(cfg: dict, traffic: dict) -> None:
    cfg.update(obs_shape=[16, 16, 3], encoder_channels=[4, 4, 4, 4],
               hidden=[16] * len(cfg["hidden"]), memory_size=300)
    traffic.update(batch_size=8, k=4, fill_rows=300, fill_block=64)
