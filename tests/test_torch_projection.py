"""Port vs reference: the categorical Bellman projection.

The port's plain projection (the function its CUDA kernel is held to on
the card) against the JAX package's Pallas kernel in interpret mode and
its einsum formulation, on the same numpy inputs. Bar: the reference's
own, max abs error 1e-5 and rows summing to 1 (tests/test_ops.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.core.distribution import CategoricalSupport as JaxSupport
from d4pg_tpu.core.distribution import categorical_projection as jax_projection
from d4pg_tpu.ops.projection import projection_pallas
from d4pg_tpu_torch.core.distribution import CategoricalSupport
from d4pg_tpu_torch.ops import projection as tproj

pytestmark = pytest.mark.torchport


def _inputs(rng, batch, atoms, v_min, v_max):
    p = rng.random((batch, atoms))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    span = v_max - v_min
    # rewards run past both ends of the support
    r = rng.uniform(v_min - 0.2 * span, v_max + 0.2 * span,
                    batch).astype(np.float32)
    done = rng.random(batch) < 0.3
    d = ((0.99 ** 3) * ~done).astype(np.float32)
    return p, r, d


@pytest.mark.parametrize("batch,v_min,v_max", [
    (1, -10.0, 0.0), (64, -10.0, 0.0), (100, -10.0, 0.0),
    (256, 0.0, 800.0),  # the fused chunk's shape and support
])
def test_plain_projection_matches_reference(rng, batch, v_min, v_max):
    p, r, d = _inputs(rng, batch, 51, v_min, v_max)
    jsup = JaxSupport(v_min, v_max, 51)
    want_pallas = np.asarray(projection_pallas(
        jsup, jnp.asarray(p), jnp.asarray(r), jnp.asarray(d), True))
    want_einsum = np.asarray(jax_projection(
        jsup, jnp.asarray(p), jnp.asarray(r), jnp.asarray(d)))
    got = tproj.projection_plain(
        CategoricalSupport(v_min, v_max, 51), torch.from_numpy(p),
        torch.from_numpy(r), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want_pallas, atol=1e-5)
    np.testing.assert_allclose(got, want_einsum, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_plain_projection_terminal_delta(rng):
    """Terminal transitions (discount 0) collapse to a delta at clip(r):
    the reference's tests/test_ops.py case, through both packages."""
    p = rng.random((8, 11))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    r = np.full(8, 5.0, np.float32)
    d = np.zeros(8, np.float32)
    want = np.zeros((8, 11), np.float32)
    want[:, 5] = 1.0  # atom exactly at 5.0
    ref = np.asarray(projection_pallas(
        JaxSupport(0.0, 10.0, 11), jnp.asarray(p), jnp.asarray(r),
        jnp.asarray(d), True))
    got = tproj.projection(
        CategoricalSupport(0.0, 10.0, 11), torch.from_numpy(p),
        torch.from_numpy(r), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(ref, want, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_wrapper_on_cpu_takes_plain_path(rng):
    """A CPU tensor goes to the plain version: same bits, no launch."""
    p, r, d = _inputs(rng, 64, 51, -10.0, 0.0)
    sup = CategoricalSupport(-10.0, 0.0, 51)
    args = (torch.from_numpy(p), torch.from_numpy(r), torch.from_numpy(d))
    before = tproj.projection.launches
    got = tproj.projection(sup, *args)
    assert tproj.projection.launches == before
    assert torch.equal(got, tproj.projection_plain(sup, *args))


def test_wrapper_rejects_unsupported_device():
    sup = CategoricalSupport(-10.0, 0.0, 3)
    p = torch.full((2, 3), 1 / 3, device="meta")
    with pytest.raises(ValueError, match="no projection kernel"):
        tproj.projection(sup, p, torch.zeros(2, device="meta"),
                         torch.zeros(2, device="meta"))


def _support_atoms(v_min, v_max, atoms):
    """numpy statement of ``projection_common.cuh::support_atom``: the
    float32 step, then one rounding (an FMA) per atom, from v_min for the
    first half and from v_max for the rest. float64 holds each product
    exactly, so the cast to float32 is the one rounding."""
    lo, hi = np.float32(v_min), np.float32(v_max)
    step = np.float64((hi - lo) / np.float32(atoms - 1))
    i = np.arange(atoms, dtype=np.float64)
    first = step * i + np.float64(lo)
    rest = np.float64(hi) - step * (atoms - 1 - i)
    return np.where(i < atoms // 2, first, rest).astype(np.float32)


@pytest.mark.parametrize("v_min,v_max,atoms", [
    (-10.0, 0.0, 51), (-1.0, 1.0, 51), (0.0, 1.0, 101), (-0.1, 0.3, 51),
    (-3.7, 12.9, 77), (0.0, 800.0, 51), (0.0, 800.0, 101), (0.0, 800.0, 2),
])
def test_kernel_support_atoms_are_the_plain_versions(v_min, v_max, atoms):
    """The kernels compute z_i in place of reading the plain version's
    ``torch.linspace``; the formula gives its bits, also where the
    spacing is inexact in float32 and v_min + delta * i would not."""
    want = CategoricalSupport(v_min, v_max, atoms).atoms().numpy()
    np.testing.assert_array_equal(_support_atoms(v_min, v_max, atoms), want)
