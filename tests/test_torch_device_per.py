"""Port vs reference: the device PER trees.

The same numpy leaves, indices, TD errors and uniforms go through
``d4pg_tpu.replay.device_per`` and ``d4pg_tpu_torch.replay.device_per``.
Tree writes and sampling are bitwise equal. Where the value written is
``x ** alpha`` with a fractional alpha, float32 ``**`` differs by an ulp
between XLA and torch, so those cases compare at rtol 1e-6 (with alpha = 1
the power is exact in both and the comparison is bitwise); the IS weights
are ``**`` throughout and compare at rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu_torch.replay import device_per as tdper

pytestmark = pytest.mark.torchport


def _to_torch(trees):
    return tdper.PerTrees(*[torch.from_numpy(np.array(a)) for a in trees])


def _assert_trees_equal(jt, tt, rtol=None):
    for name, j, t in zip(("sum", "min", "max_priority"), jt, tt):
        j, t = np.asarray(j), t.numpy()
        if rtol is None:
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, rtol=rtol, err_msg=name)


def _random_trees(rng, cap, n):
    idx = rng.integers(0, cap, n)
    vals = (rng.random(n) * 3).astype(np.float32)
    jt = jdper.set_leaves(jdper.init(cap), jnp.asarray(idx), jnp.asarray(vals))
    return jt, _to_torch(jt)


def test_init_matches():
    _assert_trees_equal(jdper.init(100), tdper.init(100, "cpu"))


@pytest.mark.parametrize("cap,n", [(8, 5), (64, 40), (256, 300)])
def test_set_leaves_bitwise_with_duplicates_and_pads(rng, cap, n):
    jt, tt = _random_trees(rng, cap, 2 * cap)
    idx = rng.integers(0, cap, n)
    idx[: n // 4] = idx[n // 4: 2 * (n // 4)]  # force duplicate indices
    idx[-2:] = [cap, cap + 3]  # pads: dropped
    vals = (rng.random(n) * 5).astype(np.float32)
    jt2 = jdper.set_leaves(jt, jnp.asarray(idx), jnp.asarray(vals))
    tt2 = tdper.set_leaves(tt, torch.from_numpy(idx), torch.from_numpy(vals))
    _assert_trees_equal(jt2, tt2)
    _assert_trees_equal(jt, tt)  # inputs untouched


def test_set_leaves_duplicate_index_last_occurrence_wins():
    idx = np.array([1, 1, 2, 1])
    vals = np.array([5, 7, 1, 9], np.float32)
    jt = jdper.set_leaves(jdper.init(4), jnp.asarray(idx), jnp.asarray(vals))
    tt = tdper.set_leaves(tdper.init(4, "cpu"), torch.from_numpy(idx),
                          torch.from_numpy(vals))
    _assert_trees_equal(jt, tt)
    assert tt.sum_tree[4 + 1] == 9.0 and tt.min_tree[4 + 1] == 9.0
    assert tt.sum_tree[1] == 10.0


def test_last_occurrence_dedupe_is_order_free(rng):
    """Every duplicate carries its index's last value, so a scatter lands
    the same tree whichever duplicate writes last."""
    idx = torch.from_numpy(rng.integers(0, 16, 200))
    vals = torch.from_numpy(rng.random(200).astype(np.float32))
    out = tdper._last_occurrence_values(idx, vals)
    for slot in idx.unique():
        pos = (idx == slot).nonzero().flatten()
        assert torch.all(out[pos] == vals[pos[-1]])


@pytest.mark.parametrize("alpha", [0.6, 1.0])
def test_insert_bitwise_on_fresh_trees(rng, alpha):
    """Fresh trees hold max_priority 1, and 1 ** alpha is exact."""
    idx = rng.integers(0, 64, 50)
    jt = jdper.insert(jdper.init(64), jnp.asarray(idx), alpha)
    tt = tdper.insert(tdper.init(64, "cpu"), torch.from_numpy(idx), alpha)
    _assert_trees_equal(jt, tt)


def test_update_from_td_then_insert_bitwise_at_alpha_one(rng):
    jt, tt = _random_trees(rng, 64, 100)
    idx = rng.integers(0, 64, 40)
    idx[:10] = idx[10:20]  # duplicates: last occurrence wins
    td = (rng.standard_normal(40) * 4).astype(np.float32)
    jt = jdper.update_from_td(jt, jnp.asarray(idx), jnp.asarray(td), 1.0)
    tt = tdper.update_from_td(tt, torch.from_numpy(idx),
                              torch.from_numpy(td), 1.0)
    _assert_trees_equal(jt, tt)
    new = rng.integers(0, 64, 16)  # enters at max_priority ** 1
    _assert_trees_equal(jdper.insert(jt, jnp.asarray(new), 1.0),
                        tdper.insert(tt, torch.from_numpy(new), 1.0))


def test_update_from_td_at_fractional_alpha(rng):
    """The written values are |td| + eps to the 0.6: an ulp apart between
    the frameworks; the repair above them matches."""
    jt, tt = _random_trees(rng, 64, 100)
    idx = rng.integers(0, 64, 40)
    td = (rng.standard_normal(40) * 4).astype(np.float32)
    jt = jdper.update_from_td(jt, jnp.asarray(idx), jnp.asarray(td), 0.6)
    tt = tdper.update_from_td(tt, torch.from_numpy(idx),
                              torch.from_numpy(td), 0.6)
    _assert_trees_equal(jt, tt, rtol=1e-6)
    assert np.asarray(jt.max_priority) == tt.max_priority.numpy()
    # the tree above the leaves is exactly the repair of the port's leaves
    leaves = tt.sum_tree[64:].clone()
    rebuilt = tdper.set_leaves(tdper.init(64, "cpu"), torch.arange(64), leaves)
    assert torch.equal(rebuilt.sum_tree, tt.sum_tree)


@pytest.mark.parametrize("cap,b,limit", [(64, 16, 64), (256, 64, 200)])
def test_sample_from_uniforms_bitwise(rng, cap, b, limit):
    vals = (rng.random(cap) * 2).astype(np.float32)
    vals[limit:] = 0.0
    vals[rng.random(cap) < 0.3] = 0.0
    jt = jdper.set_leaves(jdper.init(cap), jnp.arange(cap), jnp.asarray(vals))
    tt = _to_torch(jt)
    u = rng.random(b).astype(np.float32)
    u[:2] = [0.0, np.nextafter(np.float32(1.0), np.float32(0.0))]
    want = np.asarray(jdper.sample_from_uniforms(jt, jnp.asarray(u),
                                                 jnp.int32(limit)))
    got = tdper.sample_from_uniforms(tt, torch.from_numpy(u), limit)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tdper.strata_mass(torch.from_numpy(u), tt.sum_tree[1]).numpy(),
        np.asarray(jdper.strata_mass(jnp.asarray(u), jt.sum_tree[1])))


def test_sample_draws_from_generator(rng):
    jt, tt = _random_trees(rng, 64, 100)
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = tdper.sample(tt, g1, 32, 64)
    b = tdper.sample_from_uniforms(tt, torch.rand(32, generator=g2), 64)
    assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 12_345, 100_000, 250_000])
def test_beta_schedule_matches_reference_bitwise(step):
    want = np.asarray(jdper.beta_schedule(jnp.int32(step), 0.4, 100_000))
    assert np.float32(tdper.beta_schedule(step, 0.4, 100_000)) == want


@pytest.mark.parametrize("step", [0, 50_000])
def test_is_weights_match(rng, step):
    jt, tt = _random_trees(rng, 128, 300)
    idx = rng.integers(0, 100, 64)
    beta = tdper.beta_schedule(step, 0.4, 100_000)
    want = np.asarray(jdper.is_weights(
        jt, jnp.asarray(idx), jdper.beta_schedule(jnp.int32(step), 0.4,
                                                  100_000), jnp.int32(100)))
    got = tdper.is_weights(tt, torch.from_numpy(idx), beta, 100)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_random_op_sequence_stays_equal(rng):
    """Interleaved inserts, write-backs and samples (alpha = 1, so every
    step is bitwise) keep the two packages' trees identical."""
    cap = 128
    jt, tt = jdper.init(cap), tdper.init(cap, "cpu")
    for step in range(12):
        new = (np.arange(16) + 16 * step) % cap
        jt = jdper.insert(jt, jnp.asarray(new), 1.0)
        tt = tdper.insert(tt, torch.from_numpy(new), 1.0)
        u = rng.random(32).astype(np.float32)
        size = min(16 * (step + 1), cap)
        ji = jdper.sample_from_uniforms(jt, jnp.asarray(u), jnp.int32(size))
        ti = tdper.sample_from_uniforms(tt, torch.from_numpy(u), size)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        td = (rng.standard_normal(32) * 2).astype(np.float32)
        jt = jdper.update_from_td(jt, ji, jnp.asarray(td), 1.0)
        tt = tdper.update_from_td(tt, ti, torch.from_numpy(td), 1.0)
        _assert_trees_equal(jt, tt)
