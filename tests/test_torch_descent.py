"""Port vs reference: the PER prefix-sum descent, bitwise.

The port's plain ``descend`` (the function its CUDA kernel is held to,
bitwise, on the card) against the JAX package's Pallas kernel in
interpret mode and its jnp ``device_per.descend``, on trees and masses
made with numpy. The cases are tests/test_devsample.py's pallas-parity
ones (capacities 8/64/256 with zero runs, the all-zero tree) plus ties:
masses exactly equal to a left-subtree sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.ops.sampler_descent import descend_pallas
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu_torch.ops import sampler_descent as tdesc
from d4pg_tpu_torch.replay import device_per as tdper

pytestmark = pytest.mark.torchport


def _tree(vals):
    cap = len(vals)
    trees = jdper.set_leaves(jdper.init(cap), jnp.arange(cap),
                             jnp.asarray(vals, jnp.float32))
    return np.array(trees.sum_tree)


def _left_sums(tree):
    """Masses equal to a left-subtree sum along paths through the tree:
    the prefix mass at every internal node's left/right boundary."""
    cap = tree.shape[0] // 2
    out = []
    for node in range(1, cap):
        # prefix mass before `node`'s subtree, plus its left child's sum
        before, n = np.float32(0.0), node
        while n > 1:
            if n & 1:
                before = np.float32(before + tree[n - 1])
            n >>= 1
        out.append(np.float32(before + tree[2 * node]))
    return np.asarray(out, np.float32)


def _assert_all_agree(tree, mass):
    want = np.asarray(jdper.descend(jnp.asarray(tree), jnp.asarray(mass)))
    pallas = np.asarray(descend_pallas(jnp.asarray(tree), jnp.asarray(mass),
                                       True))
    got = tdesc.descend_plain(torch.from_numpy(tree),
                              torch.from_numpy(mass))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap", [8, 64, 256])
def test_plain_descent_bitwise_with_zero_runs(rng, cap):
    vals = rng.random(cap).astype(np.float32)
    vals[rng.random(cap) < 0.5] = 0.0
    tree = _tree(vals)
    mass = (rng.random(300) * tree[1]).astype(np.float32)
    _assert_all_agree(tree, mass)


@pytest.mark.parametrize("cap", [8, 64])
def test_plain_descent_bitwise_at_left_sum_ties(rng, cap):
    vals = rng.random(cap).astype(np.float32)
    vals[rng.random(cap) < 0.3] = 0.0
    tree = _tree(vals)
    _assert_all_agree(tree, _left_sums(tree))


def test_plain_descent_duplicate_prefix_tie_rule():
    """Leaves [1, 0, 0, 1]: mass exactly 1.0 skips the zero run to leaf 3."""
    tree = _tree([1.0, 0.0, 0.0, 1.0])
    mass = np.array([0.0, 0.5, 1.0, 1.5], np.float32)
    _assert_all_agree(tree, mass)
    got = tdesc.descend_plain(torch.from_numpy(tree), torch.from_numpy(mass))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 3, 3])


def test_plain_descent_all_zero_tree():
    tree = np.array(jdper.init(16).sum_tree)
    _assert_all_agree(tree, np.zeros(5, np.float32))


def test_device_per_descend_on_cpu_takes_plain_path(rng):
    tree = _tree(rng.random(32).astype(np.float32))
    mass = torch.from_numpy((rng.random(50) * tree[1]).astype(np.float32))
    before = tdesc.descend.launches
    got = tdper.descend(torch.from_numpy(tree), mass)
    assert tdesc.descend.launches == before
    assert torch.equal(got, tdesc.descend_plain(torch.from_numpy(tree), mass))
