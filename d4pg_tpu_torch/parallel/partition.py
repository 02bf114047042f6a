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
out-channels, HWIO). The port's rank mesh replicates the whole state on
every rank, so the one runtime reader of the table is the refusal of the
kernel arms on a mesh (``data_parallel.check_mesh_compatible``); the
placements a spec resolves to, and the shard and gather functions that
act on them, come with the first caller that splits a leaf (ROADMAP
Queue 1 item 16b, the model axis, or item 15b, the replica axis).
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np

from d4pg_tpu_torch.parallel.mesh import MODEL_AXIS

__all__ = ["PS", "D4PG_RULES", "named_tree_map", "match_partition_rules",
           "format_rules"]


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
