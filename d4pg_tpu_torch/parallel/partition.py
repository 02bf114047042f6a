"""Partition rules: the single source of placement truth.

Counterpart of ``d4pg_tpu/parallel/partition.py``'s regex rule engine:
``(pattern, spec)`` pairs matched against '/'-joined names, the wire
names of the reference (``actor_params/params/encoder/conv1/kernel``,
``critic_opt_state/0/mu/params/fc1/kernel``, ``step``; the Flax tree
names the port's weight frames already carry, byte-equal to the
reference's, ``distributed/weight_server.py``). The semantics are the
reference's:

- scalar leaves (ndim 0 or size 1) are never partitioned;
- the first ``re.search`` match in table order wins;
- a leaf no rule matches fails loudly with the resolved table.

A spec is written in the reference's (Flax) layout, one entry per
dimension (``PS(None, None, None, MODEL_AXIS)`` splits a conv kernel's
out-channels, HWIO). The placements translate it to the port's tensors:
``state_placements`` resolves every tensor of a ``D4PGState``'s four
networks (by its wire name) to ``None`` (replicated) or the torch
dimension split over the ``model`` axis (an OIHW conv weight's dim 0, a
bias's dim 0); the Adam moments of a parameter take its placement, as
the reference's ``mu``/``nu`` leaves match the same rule.
``make_shard_and_gather_fns`` turns placements into per-leaf callables
(shard: a full host tensor to this rank's slice on its device; gather:
this rank's slice to the full tensor on the host), which the model
axis's ``data_parallel.replicate_state`` and its tests read.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np

import torch

from d4pg_tpu_torch.parallel.mesh import MODEL_AXIS

__all__ = ["PS", "D4PG_RULES", "named_tree_map", "match_partition_rules",
           "format_rules", "state_placements", "make_shard_and_gather_fns"]

# a D4PGState's networks by their reference field names
MODULE_FIELDS = (("actor_params", "actor"), ("critic_params", "critic"),
                 ("target_actor_params", "target_actor"),
                 ("target_critic_params", "target_critic"))


class PS(tuple):
    """A partition spec: one mesh axis name (or None) per dimension."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):  # pickles as PS(*axes), not PS(axes)
        return tuple(self)

    def __repr__(self) -> str:
        return f"PS{tuple(self)!r}"


def named_tree_map(fn: Callable[[str, Any], Any], tree: Any,
                   sep: str = "/") -> Any:
    """Structure-preserving map with the leaf's '/'-joined path name:
    dicts by key, NamedTuples by field, lists and tuples by index;
    ``None`` passes through, and a ``PS`` is a leaf."""

    def join(prefix: str, part: str) -> str:
        return f"{prefix}{sep}{part}" if prefix else part

    def walk(prefix: str, node: Any) -> Any:
        if isinstance(node, PS):
            return fn(prefix, node)
        if isinstance(node, dict):
            return {k: walk(join(prefix, str(k)), v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[walk(join(prefix, f), getattr(node, f))
                                for f in node._fields])
        if isinstance(node, (list, tuple)):
            vals = [walk(join(prefix, str(i)), v) for i, v in enumerate(node)]
            return vals if isinstance(node, list) else tuple(vals)
        if node is None:
            return None
        return fn(prefix, node)

    return walk("", tree)


# (pattern, spec), first match wins: the pixel conv encoder's kernels
# [3, 3, in, out] and biases [out] over out-channels on the model axis,
# everything else (MLP trunks, LayerNorm, the Adam moments of all of
# them) replicated
D4PG_RULES: tuple[tuple[str, PS], ...] = (
    (r"encoder/conv\d+/kernel", PS(None, None, None, MODEL_AXIS)),
    (r"encoder/conv\d+/bias", PS(MODEL_AXIS)),
    (r".*", PS()),
)


def _is_scalar(leaf: Any) -> bool:
    shape = tuple(getattr(leaf, "shape", ()))
    return len(shape) == 0 or int(np.prod(shape)) == 1


def format_rules(rules=D4PG_RULES) -> str:
    """The rule table, one ``pattern -> spec`` row per line."""
    width = max(len(p) for p, _ in rules)
    return "\n".join(f"  {p:<{width}}  ->  {s}" for p, s in rules)


def match_partition_rules(rules, tree: Any) -> Any:
    """Resolve ``tree`` to a structure-matching tree of specs (see the
    module docstring for the semantics)."""

    def resolve(name: str, leaf: Any) -> PS:
        if _is_scalar(leaf):
            return PS()
        for pattern, s in rules:
            if re.search(pattern, name):
                return s
        raise ValueError(
            f"no partition rule matches leaf {name!r}; resolved table:\n"
            f"{format_rules(rules)}")

    return named_tree_map(resolve, tree)


def wire_name(field: str, torch_name: str, ndim: int) -> str:
    """The reference's name of a network tensor: ``encoder.conv1.weight``
    of the critic (4-D) is ``critic_params/params/encoder/conv1/kernel``;
    a 1-D ``weight`` is a LayerNorm ``scale``."""
    *path, leaf = torch_name.split(".")
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "/".join([field, "params", *path, leaf])


def torch_dim(flax_dim: int, ndim: int) -> int:
    """A Flax axis in the port's layout: a conv kernel HWIO -> OIHW, a
    Dense kernel [in, out] -> [out, in], a 1-D leaf as it is."""
    if ndim == 4:
        return (3, 2, 0, 1).index(flax_dim)
    if ndim == 2:
        return 1 - flax_dim
    return flax_dim


def _placement(spec: PS, ndim: int) -> int | None:
    dims = [d for d, axis in enumerate(spec) if axis == MODEL_AXIS]
    if not dims:
        return None
    if len(dims) > 1 or any(a is not None for d, a in enumerate(spec)
                            if d != dims[0]):
        raise ValueError(f"spec {spec} is not a split of one dimension "
                         "over the model axis")
    return torch_dim(dims[0], ndim)


def state_placements(state, rules=D4PG_RULES) -> dict[str, dict]:
    """``{module attr: {torch name: None | dim}}`` for the four networks
    of ``state`` (see the module docstring)."""
    out = {}
    for field, attr in MODULE_FIELDS:
        named = getattr(state, attr).state_dict()
        wire = {n: wire_name(field, n, t.dim()) for n, t in named.items()}
        specs = match_partition_rules(
            rules, {wire[n]: t for n, t in named.items()})
        out[attr] = {n: _placement(specs[wire[n]], t.dim())
                     for n, t in named.items()}
    return out


def make_shard_and_gather_fns(placements: Any, mesh) -> tuple[Any, Any]:
    """Per-leaf shard and gather callables for a tree of placements
    (``None`` or a dim) over ``mesh`` (a ``parallel/mesh.RankMesh``).
    A shard fn maps a full tensor (or array) to this rank's slice on its
    device, a copy; a gather fn maps this rank's slice to the full tensor
    on the host (collective over the model group for a split leaf).
    Apply leaf by leaf, e.g. ``fns[m][n](tensor)``."""

    def shard_fn(dim):
        def shard(full):
            t = torch.as_tensor(full)
            if dim is not None:
                n = t.shape[dim]
                if n % mesh.model_parallel:
                    raise ValueError(
                        f"{n} channels along dim {dim} do not divide over "
                        f"model_parallel={mesh.model_parallel}")
                t = torch.chunk(t, mesh.model_parallel, dim)[
                    mesh.model_index]
            return t.to(mesh.device, copy=True).contiguous()
        return shard

    def gather_fn(dim):
        def gather(local):
            t = local.detach()
            if dim is not None:
                t = mesh.model_gather(t, dim)
            return t.to("cpu", copy=True)
        return gather

    def build(make):
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            return make(node)
        return walk(placements)

    return build(shard_fn), build(gather_fn)
