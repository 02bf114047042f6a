"""The D4PG family with MLP actor and critic over state vectors
(``configs/humanoid-d4pg*.json``).

A family file gives the harness everything that depends on the model
family, under fixed names (``harness/spec.py`` finds it by the
configuration's ``family``):

  - ``program_config(cfg)``: the program's ``D4PGConfig``;
  - ``program_nets(state)``: ``{net: (online, target or None,
    optimizer)}`` of the program's state, the networks the check
    compares;
  - ``LOSSES``: the names of the losses the program's chunk and the
    reference's grad step both report;
  - ``layout(cfg)``: ``{net: {name: shape}}`` of the initial weights;
    ``init_scale(name, shape, cfg, net)``: each leaf's draw;
    ``tie(params, cfg)``: what the networks share, made equal in place;
  - ``observations(cfg, n, generator, device)``: ``n`` ring observations;
  - ``draws(cfg, traffic, generator, device, steps)``: the draws the
    program's state generator makes in the first ``steps`` grad steps;
    ``apply_draws(cfg, row, draws, t, rows)``: them applied to the row
    of the batch's rows ``rows`` at step ``t``, as the reference needs;
  - ``Learner(cfg, params)``: the reference's grad step;
  - ``tiny(cfg, traffic)``: both shrunk in place for the CPU tests.

Only ``program_config`` and ``program_nets`` touch the program, and they
import it when called.
"""

from __future__ import annotations

import torch

from reference import d4pg, nets

LOSSES = ("critic_loss", "actor_loss")

init_scale = nets.init_scale


def program_config(cfg: dict):
    from d4pg_tpu_torch.learner.state import D4PGConfig

    return D4PGConfig(
        obs_dim=int(cfg["obs_dim"]), act_dim=int(cfg["act_dim"]),
        v_min=float(cfg["v_min"]), v_max=float(cfg["v_max"]),
        n_atoms=int(cfg["n_atoms"]), hidden=tuple(cfg["hidden"]),
        lr_actor=float(cfg["lr_actor"]), lr_critic=float(cfg["lr_critic"]),
        adam_b1=float(cfg["adam_b1"]), adam_b2=float(cfg["adam_b2"]),
        tau=float(cfg["tau"]), gamma=float(cfg["gamma"]),
        projection=cfg["projection"], compute_dtype=cfg["compute_dtype"])


def program_nets(state) -> dict:
    return {net: (getattr(state, net), getattr(state, f"target_{net}"),
                  getattr(state, f"{net}_opt"))
            for net in ("actor", "critic")}


def layout(cfg: dict) -> dict[str, dict[str, tuple]]:
    obs, act, hidden = int(cfg["obs_dim"]), int(cfg["act_dim"]), cfg["hidden"]
    return {"actor": nets.mlp_layout("", obs, hidden, "out", act),
            "critic": nets.mlp_layout("", obs, hidden, "head",
                                      int(cfg["n_atoms"]), action=act)}


def tie(params: dict, cfg: dict) -> None:
    """Actor and critic share nothing."""


def observations(cfg: dict, n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """State vectors N(0, 1)."""
    return torch.randn(n, int(cfg["obs_dim"]), generator=generator,
                       device=device)


def draws(cfg: dict, traffic: dict, generator: torch.Generator, device,
          steps: int) -> dict:
    """None: the update draws nothing."""
    return {}


def apply_draws(cfg: dict, row: dict, draws: dict, t: int,
                rows: slice) -> dict:
    return row


class Learner(d4pg.Learner):
    def actor(self, p, obs):
        return nets.policy(p, "", obs, len(self.cfg["hidden"]))

    def critic(self, p, obs, action):
        return nets.critic_probs(p, "", obs, action, len(self.cfg["hidden"]))


def tiny(cfg: dict, traffic: dict) -> None:
    ranks = int(traffic.get("ranks", 1))
    cfg.update(obs_dim=12, act_dim=3, hidden=[16, 16, 16],
               memory_size=1000 * min(ranks, 2))
    traffic.update(batch_size=32, k=4, fill_rows=1000, fill_block=256)
