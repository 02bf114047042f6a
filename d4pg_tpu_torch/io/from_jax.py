"""Carry a learner state across from the JAX package, and weights back.

Input is the JAX ``D4PGState`` with every leaf turned into a numpy array
(what ``jax.tree_util.tree_map(np.asarray, state)`` gives), so this module
never sees a JAX type and imports nothing of JAX: it reads the fields by
name. Mapping:

  - a Flax ``Dense`` ``kernel`` [in, out] becomes ``Linear.weight``
    [out, in], a ``Conv`` ``kernel`` [kh, kw, in, out] (HWIO) becomes
    ``Conv2d.weight`` [out, in, kh, kw] (OIHW), a ``LayerNorm``
    ``scale`` becomes its ``weight``; ``bias`` is copied;
  - the critic's ``torso`` level is flattened (``torso/fc1`` -> ``fc1``),
    every other level keeps its name as a prefix (``encoder/conv1`` ->
    ``encoder.conv1``, ``critic/torso/fc1`` -> ``critic.fc1``); the MoG
    head carries across as the categorical head does;
  - each ``optax.adam`` state (``count``, ``mu``, ``nu``) becomes the
    ``torch.optim.Adam`` state (``step``, ``exp_avg``, ``exp_avg_sq``) of
    the matching parameter;
  - ``step`` becomes the host step counter. The PRNG ``key`` has no
    torch counterpart: the state keeps the generator ``init_state``
    seeds.

``flax_layout`` is the other direction for a module's parameters: torch
names and layouts back to the Flax tree (``kernel`` [in, out] or HWIO,
``scale``, ``bias``), with the keys of every level sorted as JAX's dict
pytrees hold them. The v1 weight frames carry the actor in that tree, so
a JAX actor adopts a torch learner's weights as its own.
"""

from __future__ import annotations

import numpy as np
import torch

from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState, init_state


def torch_layout(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A Flax param tree (the dict under ``'params'``) as torch parameter
    names -> arrays in torch layout."""
    out = {}
    for name, leaves in tree.items():
        if "kernel" in leaves:  # Dense [in, out] or Conv HWIO
            kernel = np.asarray(leaves["kernel"])
            out[f"{prefix}{name}.weight"] = (
                kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4
                else kernel.T)
            out[f"{prefix}{name}.bias"] = np.asarray(leaves["bias"])
        elif "scale" in leaves:  # LayerNorm
            out[f"{prefix}{name}.weight"] = np.asarray(leaves["scale"])
            out[f"{prefix}{name}.bias"] = np.asarray(leaves["bias"])
        elif name == "torso":  # the critic torso is flat in the port
            out.update(torch_layout(leaves, prefix))
        else:  # a submodule: encoder, actor, critic
            out.update(torch_layout(leaves, f"{prefix}{name}."))
    return out


def flax_layout(named: dict) -> dict:
    """Torch parameter names -> tensors (a module's ``state_dict``) as the
    Flax variable dict ``{"params": tree}`` of numpy arrays: the inverse
    of ``torch_layout`` for modules without the critic's flattened
    ``torso`` level (the actor, the encoder). A 2-D ``weight`` is a Dense
    kernel (transposed to [in, out]), a 4-D one a Conv kernel (OIHW to
    HWIO), a 1-D one a LayerNorm ``scale``."""
    tree: dict = {}
    for name, t in named.items():
        arr = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
               else np.asarray(t))
        *path, leaf = name.split(".")
        if leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            else:
                leaf = "scale"
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)

    def sort(node):
        return ({k: sort(node[k]) for k in sorted(node)}
                if isinstance(node, dict) else node)

    return {"params": sort(tree)}


@torch.no_grad()
def load_params(module: torch.nn.Module, params: dict) -> None:
    """Copy a Flax variable dict (``{"params": tree}``) into ``module``
    (names and shapes checked)."""
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
        load_params(module, params)
    _load_adam(state.actor_opt, state.actor, jax_state.actor_opt_state)
    _load_adam(state.critic_opt, state.critic, jax_state.critic_opt_state)
    state.step = int(np.asarray(jax_state.step))
    return state
