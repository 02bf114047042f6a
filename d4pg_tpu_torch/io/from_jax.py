"""Carry a learner state across from the JAX package.

Input is the JAX ``D4PGState`` with every leaf turned into a numpy array
(what ``jax.tree_util.tree_map(np.asarray, state)`` gives), so this module
never sees a JAX type and imports nothing of JAX: it reads the fields by
name. Mapping:

  - a Flax ``Dense`` ``kernel`` [in, out] becomes ``Linear.weight``
    [out, in]; ``bias`` is copied; the critic's ``torso`` level is
    flattened (``torso/fc1`` -> ``fc1``);
  - each ``optax.adam`` state (``count``, ``mu``, ``nu``) becomes the
    ``torch.optim.Adam`` state (``step``, ``exp_avg``, ``exp_avg_sq``) of
    the matching parameter;
  - ``step`` becomes the host step counter.
"""

from __future__ import annotations

import numpy as np
import torch

from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState, init_state


def torch_layout(tree: dict) -> dict[str, np.ndarray]:
    """A Flax param tree (the dict under ``'params'``) as torch parameter
    names -> arrays in torch layout."""
    out = {}
    for layer, leaves in tree.items():
        if "kernel" not in leaves:  # a submodule such as the critic torso
            out.update(torch_layout(leaves))
            continue
        out[f"{layer}.weight"] = np.asarray(leaves["kernel"]).T
        out[f"{layer}.bias"] = np.asarray(leaves["bias"])
    return out


@torch.no_grad()
def _load_params(module: torch.nn.Module, params: dict) -> None:
    arrays = torch_layout(params["params"])
    named = dict(module.named_parameters())
    if set(arrays) != set(named):
        raise ValueError(f"param names differ: {sorted(arrays)} vs "
                         f"{sorted(named)}")
    for name, p in named.items():
        src = torch.tensor(arrays[name])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} vs "
                             f"{tuple(p.shape)}")
        p.copy_(src)


def _load_adam(opt: torch.optim.Adam, module: torch.nn.Module,
               opt_state) -> None:
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    mu, nu = torch_layout(adam.mu["params"]), torch_layout(adam.nu["params"])
    step = float(np.asarray(adam.count))
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            # copies: Adam updates its moments in place, and the caller's
            # arrays may be views of the JAX buffers
            "exp_avg": torch.tensor(mu[name], device=p.device),
            "exp_avg_sq": torch.tensor(nu[name], device=p.device),
        }


def state_from_jax(config: D4PGConfig, jax_state,
                   device: str | torch.device | None = None) -> D4PGState:
    """The port's ``D4PGState`` holding ``jax_state``'s weights, Adam
    moments and step, on ``device`` (default ``cuda``)."""
    state = init_state(config, 0, device)
    for module, params in (
            (state.actor, jax_state.actor_params),
            (state.critic, jax_state.critic_params),
            (state.target_actor, jax_state.target_actor_params),
            (state.target_critic, jax_state.target_critic_params)):
        _load_params(module, params)
    _load_adam(state.actor_opt, state.actor, jax_state.actor_opt_state)
    _load_adam(state.critic_opt, state.critic, jax_state.critic_opt_state)
    state.step = int(np.asarray(jax_state.step))
    return state
