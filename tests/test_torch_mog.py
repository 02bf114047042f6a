"""Port vs reference: the mixture-of-Gaussians critic family.

``MixtureOfGaussianCritic`` (float32 forward at atol 1e-5 / rtol 1e-5
from perturbed weights carried across), ``mog_log_prob``, ``mog_mean``
and ``mog_target`` at the same bar, and ``mog_td_loss`` with the
reference's own draws injected: ``jax.random.categorical(key_c,
logits[..., None, :], shape=(B, S))`` is ``argmax(logits[..., None, :] +
gumbel(key_c, (B, S, K)), -1)``, so the port takes those Gumbel draws and
``normal(key_z, (B, S))``; loss and td at rtol 1e-5. Then the
reference's own MoG tests (``tests/test_core.py``,
``tests/test_models.py``, ``tests/test_learner.py``) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.core import mog as jmog
from d4pg_tpu.models.critic import MixtureOfGaussianCritic as JaxMoG
from d4pg_tpu.models.critic import MoGParams as JaxMoGParams
from d4pg_tpu_torch.core import mog as tmog
from d4pg_tpu_torch.io.from_jax import load_params
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.learner.update import update_step
from d4pg_tpu_torch.models.critic import MixtureOfGaussianCritic, MoGParams
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-5, atol=1e-5)


def _mixture(rng, b=6, k=4):
    logits = rng.standard_normal((b, k)).astype(np.float32)
    lw = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return (lw.astype(np.float32),
            rng.uniform(-20, 5, (b, k)).astype(np.float32),
            rng.uniform(0.05, 3.0, (b, k)).astype(np.float32))


def _pair(arrays):
    return (JaxMoGParams(*[jnp.asarray(a) for a in arrays]),
            MoGParams(*[torch.from_numpy(a) for a in arrays]))


def test_mog_critic_forward_matches_reference(rng):
    obs = rng.standard_normal((5, 7)).astype(np.float32)
    act = rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    jm = JaxMoG(n_components=3, hidden=(32, 32, 32))
    params = jm.init(jax.random.key(0), jnp.asarray(obs), jnp.asarray(act))
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * noise.standard_normal(
            x.shape).astype(np.float32)), params)
    tm = MixtureOfGaussianCritic(7, 2, 3, (32, 32, 32))
    load_params(tm, params)
    want = jm.apply(params, jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        got = tm(torch.from_numpy(obs), torch.from_numpy(act))
    for name, g, w in zip(MoGParams._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_mog_math_matches_reference(rng):
    jp, tp = _pair(_mixture(rng))
    x = rng.uniform(-25, 10, (6, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tmog.mog_log_prob(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jmog.mog_log_prob(jp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tmog.mog_mean(tp).numpy(),
                               np.asarray(jmog.mog_mean(jp)), **TOL)
    r = rng.uniform(-2, 0, 6).astype(np.float32)
    d = np.where(rng.random(6) < 0.3, 0.0, 0.97).astype(np.float32)
    want = jmog.mog_target(jp, jnp.asarray(r), jnp.asarray(d))
    got = tmog.mog_target(tp, torch.from_numpy(r), torch.from_numpy(d))
    for name, g, w in zip(MoGParams._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_mog_td_loss_with_the_reference_draws(rng, weighted):
    jpred, tpred = _pair(_mixture(rng))
    jtgt, ttgt = _pair(_mixture(rng))
    w = (0.5 + rng.random(6)).astype(np.float32) if weighted else None
    key, s = jax.random.key(5), 16
    want_loss, want_td = jmog.mog_td_loss(
        jpred, jtgt, key, n_samples=s,
        weights=None if w is None else jnp.asarray(w))
    key_c, key_z = jax.random.split(key)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key_c, (6, s, 4))))
    normal = torch.from_numpy(np.array(jax.random.normal(key_z, (6, s))))
    loss, td = tmog.mog_td_loss(
        tpred, ttgt, None, s, None if w is None else torch.from_numpy(w),
        gumbel=gumbel, normal=normal)
    np.testing.assert_allclose(td.numpy(), np.asarray(want_td), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_mog_td_loss_draws_from_its_generator(rng):
    _, pred = _pair(_mixture(rng))
    _, tgt = _pair(_mixture(rng))
    a = tmog.mog_td_loss(pred, tgt, torch.Generator().manual_seed(2), 8)
    b = tmog.mog_td_loss(pred, tgt, torch.Generator().manual_seed(2), 8)
    assert torch.equal(a[1], b[1]) and a[1].shape == (6,)
    with pytest.raises(ValueError, match="generator"):
        tmog.mog_td_loss(pred, tgt, None, 8)


def test_mog_td_loss_passes_no_gradient_to_the_target(rng):
    pred = MoGParams(*[torch.from_numpy(a).requires_grad_()
                       for a in _mixture(rng)])
    tgt = MoGParams(*[torch.from_numpy(a).requires_grad_()
                      for a in _mixture(rng)])
    loss, _ = tmog.mog_td_loss(pred, tgt, torch.Generator().manual_seed(0),
                               8)
    loss.backward()
    assert all(t.grad is None for t in tgt)
    assert all(p.grad is not None for p in pred)


# --- the reference's own MoG tests, on the port ---------------------------

def test_mog_critic_outputs_valid_mixture():
    gen = torch.Generator().manual_seed(0)
    m = MixtureOfGaussianCritic(7, 2, n_components=5, generator=gen)
    obs, act = torch.randn(4, 7, generator=gen), torch.randn(4, 2,
                                                             generator=gen)
    with torch.no_grad():
        out = m(obs, act)
    assert out.means.shape == (4, 5)
    np.testing.assert_allclose(out.log_weights.exp().sum(-1).numpy(), 1.0,
                               rtol=1e-4)
    assert (out.stds > 0).all()


def test_mog_target_and_loss_decreases_toward_truth():
    params = MoGParams(log_weights=torch.log(torch.tensor([[0.5, 0.5]])),
                       means=torch.tensor([[0.0, 2.0]]),
                       stds=torch.tensor([[1.0, 1.0]]))
    tgt = tmog.mog_target(params, torch.tensor([1.0]), torch.tensor([0.5]))
    np.testing.assert_allclose(tgt.means.numpy(), [[1.0, 2.0]])
    np.testing.assert_allclose(tgt.stds.numpy(), [[0.5, 0.5]])
    assert float(tmog.mog_mean(params)) == pytest.approx(1.0)
    term = tmog.mog_target(params, torch.tensor([3.0]), torch.tensor([0.0]))
    np.testing.assert_allclose(term.means.numpy(), [[3.0, 3.0]])
    loss_match, td = tmog.mog_td_loss(tgt, tgt,
                                      torch.Generator().manual_seed(0), 256)
    far = MoGParams(tgt.log_weights, tgt.means + 10.0, tgt.stds)
    loss_far, _ = tmog.mog_td_loss(far, tgt,
                                   torch.Generator().manual_seed(0), 256)
    assert float(loss_match) < float(loss_far)
    assert td.shape == (1,)


def test_mog_log_prob_matches_scipy_single_gaussian():
    from scipy.stats import norm

    params = MoGParams(log_weights=torch.zeros(1, 1),
                       means=torch.tensor([[1.5]]),
                       stds=torch.tensor([[2.0]]))
    got = tmog.mog_log_prob(params, torch.tensor([[0.0, 1.5, 4.0]]))[0]
    want = norm.logpdf([0.0, 1.5, 4.0], loc=1.5, scale=2.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_mog_family_end_to_end(rng):
    """The MoG family's full update runs 40 times on one batch and its
    critic loss falls; the TD error is per sample; no categorical
    projection runs."""
    config = D4PGConfig(obs_dim=3, act_dim=1, v_min=-10.0, v_max=10.0,
                        n_atoms=11, hidden=(32, 32, 32), critic_family="mog",
                        n_components=3, mog_samples=16)
    state = init_state(config, 3, "cpu")
    done = (rng.random(32) < 0.25).astype(np.float32)
    batch = TransitionBatch(
        obs=torch.from_numpy(rng.standard_normal((32, 3)).astype(np.float32)),
        action=torch.from_numpy(
            rng.uniform(-1, 1, (32, 1)).astype(np.float32)),
        reward=torch.from_numpy(rng.standard_normal(32).astype(np.float32)),
        next_obs=torch.from_numpy(
            rng.standard_normal((32, 3)).astype(np.float32)),
        done=torch.from_numpy(done),
        discount=torch.from_numpy((0.99 * (1 - done)).astype(np.float32)))
    losses = []
    for _ in range(40):
        metrics = update_step(config, state, batch)
        losses.append(float(metrics["critic_loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert metrics["td_error"].shape == (32,)
