"""Port vs reference: the PER prefix-sum descent, bitwise.

The port's plain ``descend`` (the function its CUDA kernel is held to,
bitwise, on the card) against the JAX package's Pallas kernel in
interpret mode and its jnp ``device_per.descend``, on trees and masses
made with numpy. The cases are tests/test_devsample.py's pallas-parity
ones (capacities 8/64/256 with zero runs, the all-zero tree) plus ties:
masses exactly equal to a left-subtree sum.

``descend_rounds`` states in numpy the round procedure that the CUDA
kernel (``d4pg_tpu_torch/ops/csrc/sampler_descent.cu``) follows: k levels
per round, one candidate path per lane of a group of 2^(k - 1) lanes,
the lane whose path agrees with every decision it computes taking the
round. It is held bitwise against the JAX descent at k = 1 (one level per
round), 5 and 6, at every capacity up to 4,096, where k does not divide
the level count and where the tree has fewer levels than k.
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


def descend_rounds(tree, mass, k):
    """The kernel's descent of ``mass`` ([Q] float32) through ``tree``
    ([2 * cap] float32), k levels per round. A round at node n resolves
    m = min(k, levels left) levels: lane c of the query's 2^(k - 1)
    lanes takes the path whose first m - 1 decisions are the bits of
    c >> (k - m); its left sum at step t is node
    n * 2^t + 2 * (path >> (m - t)), inside n's subtree segment
    [n * 2^t, (n + 1) * 2^t). Each lane walks its path with the reference's
    compare and float32 subtraction; the first lane whose decisions all
    agree with its path gives the round's mass and node."""
    cap = tree.shape[0] // 2
    levels = cap.bit_length() - 1
    lanes = 1 << (k - 1)
    q = np.arange(mass.shape[0])
    cand = np.arange(lanes)
    p = np.asarray(mass, np.float32)
    node = np.ones(mass.shape[0], np.int64)
    for done in range(0, levels, k):
        m = min(k, levels - done)
        path = cand >> (k - m)  # [lanes]: m - 1 decision bits each
        lp = np.repeat(p[:, None], lanes, 1)  # [Q, lanes]
        agrees = np.ones(lp.shape, bool)
        for t in range(1, m + 1):
            left_sum = tree[(node[:, None] << t) + 2 * (path >> (m - t))]
            right = lp >= left_sum
            lp = np.where(right, lp - left_sum, lp)
            if t < m:
                agrees &= right == (((path >> (m - 1 - t)) & 1) == 1)
        assert lp.dtype == np.float32
        assert agrees.any(axis=1).all()  # the true path is always a lane
        win = agrees.argmax(axis=1)
        node = (node << m) + 2 * path[win] + right[q, win]
        p = lp[q, win]
    return (node - cap).astype(np.int32)


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


ROUND_LEVELS = [1, 5, 6]  # k: the old one-level chain, and the kernel's


def _assert_rounds_agree(tree, mass, k):
    want = np.asarray(jdper.descend(jnp.asarray(tree), jnp.asarray(mass)))
    got = descend_rounds(tree, mass, k)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", ROUND_LEVELS)
@pytest.mark.parametrize("cap", [2 ** e for e in range(13)])
def test_round_procedure_bitwise_at_every_capacity(rng, cap, k):
    """Capacities 1 to 4,096: zero levels, fewer levels than k, and level
    counts that k does not divide; leaves with zero runs, masses across
    the whole range and past it."""
    vals = rng.random(cap).astype(np.float32)
    vals[rng.random(cap) < 0.4] = 0.0
    vals[: cap // 4] = 0.0  # a leading zero run
    tree = _tree(vals)
    mass = (rng.random(200) * tree[1] * 1.01).astype(np.float32)
    _assert_rounds_agree(tree, np.concatenate([mass, [0.0, tree[1]]])
                         .astype(np.float32), k)


@pytest.mark.parametrize("k", ROUND_LEVELS)
@pytest.mark.parametrize("cap", [8, 64, 128])
def test_round_procedure_bitwise_at_left_sum_ties(rng, cap, k):
    vals = rng.random(cap).astype(np.float32)
    vals[rng.random(cap) < 0.3] = 0.0
    tree = _tree(vals)
    _assert_rounds_agree(tree, _left_sums(tree), k)


@pytest.mark.parametrize("k", ROUND_LEVELS)
def test_round_procedure_duplicate_prefix_tie_rule(k):
    tree = _tree([1.0, 0.0, 0.0, 1.0])
    mass = np.array([0.0, 0.5, 1.0, 1.5], np.float32)
    _assert_rounds_agree(tree, mass, k)
    np.testing.assert_array_equal(descend_rounds(tree, mass, k), [0, 0, 3, 3])


@pytest.mark.parametrize("k", ROUND_LEVELS)
def test_round_procedure_all_zero_tree(k):
    tree = np.array(jdper.init(64).sum_tree)
    _assert_rounds_agree(tree, np.zeros(5, np.float32), k)
