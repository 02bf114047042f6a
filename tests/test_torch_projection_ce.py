"""Port vs reference: the fused projection + cross-entropy.

The port's wrapper (its plain version on the CPU, the function its CUDA
kernels are held to on the card) against the JAX package's Pallas kernel
in interpret mode, forward and gradient, on the same numpy inputs. Bars:
the reference's own (tests/test_ops.py), td at atol 1e-4 / rtol 1e-5,
the gradient at 1e-5. ``ProjectionCE``'s autograd wiring is checked on
the CPU with its two kernel launches swapped for the plain arithmetic.

``forward_rows`` states in numpy what the CUDA forward kernel
(``d4pg_tpu_torch/ops/csrc/projection_ce.cu::ce_forward_kernel``)
computes, in its order: b_i as ``projection_common.cuh::bin_position``
rounds it, proj_j as the fixed-order sum over i, the products
proj_j * log(q_j + 1e-10), then each row's fixed reduction (lane l of a
warp sums the products l, l + 32, ..., then an xor-shuffle tree adds the
32 lanes). It is held against the JAX kernel at the reference's bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.core.distribution import CategoricalSupport as JaxSupport
from d4pg_tpu.ops.projection_ce import projection_ce_pallas
from d4pg_tpu_torch.core.distribution import CategoricalSupport
from d4pg_tpu_torch.ops import projection_ce as pce
from d4pg_tpu_torch.ops.projection import check_operands

pytestmark = pytest.mark.torchport


def _dist(rng, batch, atoms):
    x = rng.random((batch, atoms))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(rng, batch, atoms, v_min, v_max):
    span = v_max - v_min
    # rewards run past both ends of the support, ~30% terminal rows
    r = rng.uniform(v_min - 0.2 * span, v_max + 0.2 * span,
                    batch).astype(np.float32)
    done = rng.random(batch) < 0.3
    d = ((0.99 ** 3) * ~done).astype(np.float32)
    return _dist(rng, batch, atoms), r, d, _dist(rng, batch, atoms)


@pytest.mark.parametrize("batch", [1, 64, 100])
def test_forward_matches_reference_kernel(rng, batch):
    p, r, d, q = _inputs(rng, batch, 51, -10.0, 0.0)
    want = np.asarray(projection_ce_pallas(
        JaxSupport(-10.0, 0.0, 51), *map(jnp.asarray, (p, r, d, q)), True))
    sup = CategoricalSupport(-10.0, 0.0, 51)
    args = [torch.from_numpy(x) for x in (p, r, d, q)]
    got = pce.projection_ce(sup, *args).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(
        got, pce.projection_ce_plain(sup, *args).numpy())


def test_gradient_matches_reference_and_stops_at_the_target(rng):
    """dq equals jax.grad through the JAX kernel's custom VJP, and no
    gradient reaches target_probs, rewards or discounts."""
    batch, atoms, v_min, v_max = 64, 31, -5.0, 0.0
    p, r, d, q = _inputs(rng, batch, atoms, v_min, v_max)
    w = rng.random(batch).astype(np.float32)  # IS-weighted mean
    jp, jr, jd, jw = map(jnp.asarray, (p, r, d, w))
    g_ref = np.asarray(jax.grad(lambda q_: jnp.mean(jw * projection_ce_pallas(
        JaxSupport(v_min, v_max, atoms), jp, jr, jd, q_, True)))(
            jnp.asarray(q)))

    tp, tr, td_, tq = (torch.from_numpy(x).requires_grad_(True)
                       for x in (p, r, d, q))
    loss = torch.mean(torch.from_numpy(w) * pce.projection_ce(
        CategoricalSupport(v_min, v_max, atoms), tp, tr, td_, tq))
    loss.backward()
    np.testing.assert_allclose(tq.grad.numpy(), g_ref, atol=1e-5, rtol=1e-5)
    assert tp.grad is None and tr.grad is None and td_.grad is None


def test_function_wiring_with_kernels_replaced(rng, monkeypatch):
    """ProjectionCE on the CPU with its two launches swapped for plain
    arithmetic: the forward saves its inputs, the backward hands the
    kernel a contiguous cotangent (a mean's arrives with stride 0) and
    returns a gradient for pred_probs only."""
    sup = CategoricalSupport(-10.0, 0.0, 11)
    p, r, d, q = (torch.from_numpy(x) for x in _inputs(rng, 8, 11, -10.0,
                                                       0.0))
    seen = []

    def forward_kernel(support, *args):
        return pce.projection_ce_plain(support, *args)

    def backward_kernel(support, tp, tr, td, tq, g):
        seen.append(g.stride())
        proj = pce.categorical_projection(support, tp, tr, td)
        return -g[:, None] * proj / (tq + 1e-10)

    monkeypatch.setattr(pce, "forward_kernel", forward_kernel)
    monkeypatch.setattr(pce, "backward_kernel", backward_kernel)
    q_fn = q.clone().requires_grad_(True)
    p_fn = p.clone().requires_grad_(True)
    td = pce.ProjectionCE.apply(sup, p_fn, r, d, q_fn)
    td.mean().backward()
    assert seen == [(1,)]
    q_ref = q.clone().requires_grad_(True)
    pce.projection_ce_plain(sup, p, r, d, q_ref).mean().backward()
    torch.testing.assert_close(q_fn.grad, q_ref.grad, atol=1e-7, rtol=1e-6)
    assert p_fn.grad is None


def test_wrapper_on_cpu_takes_plain_path(rng):
    sup = CategoricalSupport(-10.0, 0.0, 51)
    args = [torch.from_numpy(x) for x in _inputs(rng, 16, 51, -10.0, 0.0)]
    before = (pce.projection_ce.fwd_launches, pce.projection_ce.bwd_launches)
    args[3].requires_grad_(True)
    pce.projection_ce(sup, *args).sum().backward()
    assert (pce.projection_ce.fwd_launches,
            pce.projection_ce.bwd_launches) == before


def test_wrapper_rejects_unsupported_device():
    sup = CategoricalSupport(-10.0, 0.0, 3)
    p = torch.full((2, 3), 1 / 3, device="meta")
    with pytest.raises(ValueError, match="no projection_ce kernel"):
        pce.projection_ce(sup, p, torch.zeros(2, device="meta"),
                          torch.zeros(2, device="meta"), p)


@pytest.mark.parametrize("bad,error", [
    ("q_shape", ValueError), ("q_dtype", TypeError),
    ("g_strided", ValueError), ("atoms", ValueError)])
def test_operand_check_names_the_bad_tensor(bad, error):
    """What the kernels' launches check first (on CPU tensors here)."""
    sup = CategoricalSupport(-10.0, 0.0, 5)
    p, q = torch.full((4, 5), 0.2), torch.full((4, 5), 0.2)
    r, d, g = torch.zeros(4), torch.zeros(4), torch.ones(4)
    if bad == "q_shape":
        q = q[:3]
    elif bad == "q_dtype":
        q = q.double()
    elif bad == "g_strided":
        g = torch.ones(1).expand(4)
    else:
        sup = CategoricalSupport(-10.0, 0.0, 6)
    with pytest.raises(error):
        check_operands(sup, p, r, d, matrices=[("pred_probs", q)],
                       vectors=[("grad_td", g)])


def _bin_positions(sup, r, d):
    """b [B, A] in float32 as ``bin_position`` rounds it: the support's
    atoms as torch.linspace gives them (the kernels' ``support_atom``,
    pinned by test_torch_projection.py), r + d * z with its product and
    sum rounded apart, clipped, then divided by delta."""
    z = sup.atoms().numpy()
    lo, hi = np.float32(sup.v_min), np.float32(sup.v_max)
    tz = np.clip(r[:, None] + d[:, None] * z, lo, hi)
    return (tz - lo) / np.float32(sup.delta)


def _projected(p, b):
    """proj [B, A] as ``projected_atom`` sums it: over source atoms i in
    increasing order, one FMA per term (float64 holds p_i * w exactly;
    the one rounding to float32 per step stands for the FMA's)."""
    atoms = p.shape[1]
    j = np.arange(atoms, dtype=np.float32)
    w = np.maximum(np.float32(0.0),
                   np.float32(1.0) - np.abs(b[:, :, None] - j))
    acc = np.zeros(p.shape, np.float32)
    for i in range(atoms):
        acc = (p[:, i, None].astype(np.float64) * w[:, i]
               + acc).astype(np.float32)
    return acc


def _row_sums(c):
    """Each row of c [B, A] summed as the kernel's reducing warp does:
    lane l adds c_l, c_(l + 32), ... to 0 in order, then five xor-shuffle
    steps (offsets 16 to 1) add lane pairs; lane 0 holds the sum."""
    lanes = np.zeros((c.shape[0], 32), np.float32)
    for j0 in range(0, c.shape[1], 32):
        part = c[:, j0:j0 + 32]
        lanes[:, :part.shape[1]] += part
    for offset in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ offset]
    # float32 addition commutes: every lane ends with the same sum
    assert (lanes == lanes[:, :1]).all()
    return lanes[:, 0]


def forward_rows(sup, p, r, d, q):
    """td [B] in the CUDA forward kernel's arithmetic and order."""
    proj = _projected(p, _bin_positions(sup, r, d))
    return -_row_sums(proj * np.log(q + np.float32(1e-10)))


@pytest.mark.parametrize("atoms,v_min,v_max,batch", [
    (2, 0.0, 800.0, 64), (51, 0.0, 800.0, 256), (51, 0.0, 800.0, 1),
    (101, 0.0, 800.0, 100), (51, -10.0, 0.0, 100), (51, -10.0, 0.0, 1),
    (77, -3.7, 12.9, 33),
])
def test_forward_reduction_order_matches_reference_kernel(
        rng, atoms, v_min, v_max, batch):
    """The forward kernel's fixed-order row sum, stated in numpy, against
    the JAX kernel (interpret mode) at the reference's bar; rows of 2
    atoms (one lane live), of 51 (two products on lanes 0-18) and of 101
    (four on lanes 0-4)."""
    p, r, d, q = _inputs(rng, batch, atoms, v_min, v_max)
    want = np.asarray(projection_ce_pallas(
        JaxSupport(v_min, v_max, atoms), *map(jnp.asarray, (p, r, d, q)),
        True))
    got = forward_rows(CategoricalSupport(v_min, v_max, atoms), p, r, d, q)
    assert got.dtype == np.float32 and got.shape == (batch,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
