"""Port vs reference: networks, learner updates, exploration noise.

A JAX ``init_state`` is carried into the port with ``io.from_jax`` (as
plain numpy trees). Forwards then match at rtol 1e-5 / atol 1e-6, and so
does one ``update_step`` on a shared batch with IS weights under each
projection arm on both sides (the JAX kernels in interpret mode, the
port's plain versions on the CPU): losses, TD errors, all four parameter
sets and both Adam moments; and so do K = 3 steps of
``multi_update_step``. The noise processes and ``act_ou`` take the
reference's own normal draws, injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.learner import state as jstate
from d4pg_tpu.core import noise as jnoise
from d4pg_tpu.learner.update import act_ou as jax_act_ou
from d4pg_tpu.learner.update import multi_update_step as jax_multi_update_step
from d4pg_tpu.learner.update import update_step as jax_update_step
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.core import noise as tnoise
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.learner.update import (
    act,
    act_deterministic,
    act_ou,
    multi_update_step,
    update_step,
)
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = dict(obs_dim=8, act_dim=2, v_min=-10.0, v_max=10.0, n_atoms=11,
            hidden=(32, 32, 32), projection="pallas")


def _pair(seed=0, **kw):
    jcfg = jstate.D4PGConfig(**{**DIMS, **kw})
    tcfg = tstate.D4PGConfig(**{**DIMS, **kw})
    js = jstate.init_state(jcfg, jax.random.key(seed))
    return jcfg, js, tcfg, state_from_jax(tcfg, _as_numpy(js), "cpu")


def _as_numpy(js):
    """The JAX state as plain numpy trees (the typed PRNG key as its raw
    bits; the port does not read it)."""
    js = js._replace(key=jax.random.key_data(js.key))
    return jax.tree_util.tree_map(np.asarray, js)


def _batch(rng, b, obs=8, act=2):
    done = (rng.random(b) < 0.25).astype(np.float32)
    return dict(
        obs=rng.standard_normal((b, obs)).astype(np.float32),
        action=rng.uniform(-1, 1, (b, act)).astype(np.float32),
        reward=rng.uniform(-12, 12, b).astype(np.float32),
        next_obs=rng.standard_normal((b, obs)).astype(np.float32),
        done=done,
        discount=(0.99 ** 3 * (1 - done)).astype(np.float32),
    )


def _assert_params(jparams, module):
    arrays = torch_layout(jparams["params"])
    named = dict(module.named_parameters())
    assert set(arrays) == set(named)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), arrays[name],
                                   err_msg=name, **TOL)


def _assert_adam(jopt, opt, module):
    adam = jopt[0]
    mu, nu = torch_layout(adam.mu["params"]), torch_layout(adam.nu["params"])
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == float(np.asarray(adam.count))
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name],
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name],
                                   err_msg=name, **TOL)


def test_from_jax_carries_every_tree():
    jcfg, js, tcfg, ts = _pair()
    _assert_params(js.actor_params, ts.actor)
    _assert_params(js.critic_params, ts.critic)
    _assert_params(js.target_actor_params, ts.target_actor)
    _assert_params(js.target_critic_params, ts.target_critic)
    _assert_adam(js.actor_opt_state, ts.actor_opt, ts.actor)
    _assert_adam(js.critic_opt_state, ts.critic_opt, ts.critic)
    assert ts.step == 0


def test_init_state_layout_and_bias_init():
    """The port's own init: Flax-like zero biases and fan-in weights."""
    ts = tstate.init_state(tstate.D4PGConfig(**DIMS), seed=3, device="cpu")
    assert all(torch.all(m.bias == 0) for m in ts.critic.modules()
               if isinstance(m, torch.nn.Linear))
    std = ts.critic.fc2.weight.std().item()
    assert abs(std - 1 / np.sqrt(32 + 2)) < 0.05
    assert ts.critic.fc2.weight.shape == (32, 34)  # action joins after fc1
    again = tstate.init_state(tstate.D4PGConfig(**DIMS), seed=3, device="cpu")
    assert torch.equal(again.actor.fc1.weight, ts.actor.fc1.weight)


def test_forwards_match(rng):
    jcfg, js, tcfg, ts = _pair(seed=1)
    b = _batch(rng, 32)
    obs, act_ = jnp.asarray(b["obs"]), jnp.asarray(b["action"])
    want_a = np.asarray(jcfg.build_actor().apply(js.actor_params, obs))
    want_q = np.asarray(jcfg.build_critic().apply(js.critic_params, obs, act_))
    with torch.no_grad():
        got_a = ts.actor(torch.from_numpy(b["obs"])).numpy()
        got_q = ts.critic(torch.from_numpy(b["obs"]),
                          torch.from_numpy(b["action"])).numpy()
    np.testing.assert_allclose(got_a, want_a, **TOL)
    np.testing.assert_allclose(got_q, want_q, **TOL)
    np.testing.assert_allclose(
        act_deterministic(ts.actor, torch.from_numpy(b["obs"])).numpy(),
        want_a, **TOL)


def test_act_adds_clipped_noise(rng):
    _, _, _, ts = _pair()
    obs = torch.from_numpy(_batch(rng, 16)["obs"])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = act(ts.actor, obs, g1, epsilon=0.3)
    noise = torch.randn((16, 2), generator=g2) * 0.3
    want = torch.clamp(act_deterministic(ts.actor, obs) + noise, -1.0, 1.0)
    assert torch.equal(a, want)


@pytest.mark.parametrize("projection", ["pallas", "einsum", "pallas_ce"])
def test_update_step_matches_reference(rng, projection):
    jcfg, js, tcfg, ts = _pair(seed=2, projection=projection)
    b = _batch(rng, 16)
    w = (0.5 + rng.random(16)).astype(np.float32)
    js2, jm = jax.jit(lambda s, bb, ww: jax_update_step(jcfg, s, bb, ww))(
        js, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
        jnp.asarray(w))
    tm = update_step(tcfg, ts, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in b.items()}), torch.from_numpy(w))
    for name in ("critic_loss", "actor_loss", "q_mean", "td_error"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   err_msg=name, **TOL)
    _assert_params(js2.actor_params, ts.actor)
    _assert_params(js2.critic_params, ts.critic)
    _assert_params(js2.target_actor_params, ts.target_actor)
    _assert_params(js2.target_critic_params, ts.target_critic)
    _assert_adam(js2.actor_opt_state, ts.actor_opt, ts.actor)
    _assert_adam(js2.critic_opt_state, ts.critic_opt, ts.critic)
    assert ts.step == int(js2.step) == 1


@pytest.mark.parametrize("projection", [None, "pallas", "einsum"])
def test_update_step_projects_through_the_kernel_wrapper(
        rng, monkeypatch, projection):
    """``pallas``, and the default, reach the projection wrapper (the CUDA
    kernel on the card); ``einsum`` never does: it projects with the plain
    ``categorical_projection`` on every device, as the reference does."""
    from d4pg_tpu_torch.learner import update as tupdate
    from d4pg_tpu_torch.ops import projection as tproj

    dims = {k: v for k, v in DIMS.items() if k != "projection"}
    if projection is not None:
        dims["projection"] = projection
    cfg = tstate.D4PGConfig(**dims)
    assert cfg.projection == (projection or "pallas")
    calls = []

    def counted(*args):
        calls.append(args[0])
        return tproj.projection(*args)

    monkeypatch.setattr(tupdate, "projection", counted)
    ts = tstate.init_state(cfg, seed=0, device="cpu")
    tupdate.update_step(cfg, ts, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in _batch(rng, 8).items()}))
    assert calls == ([] if projection == "einsum" else [cfg.support])


@pytest.mark.parametrize("projection,launches", [("einsum", 0),
                                                 ("pallas", 4)])
def test_einsum_launches_no_projection_kernel(rng, monkeypatch, projection,
                                              launches):
    """``--projection einsum`` leaves ``projection.launches`` at 0 in
    ``update_step`` and ``multi_update_step``. The kernel entry is
    stood in for by a wrapper that counts a launch on the CPU, as the
    CUDA branch does on the card; ``pallas`` is the control (1 + K = 3
    launches)."""
    from d4pg_tpu_torch.learner import update as tupdate
    from d4pg_tpu_torch.ops import projection as tproj

    def launching(*args):
        tproj.projection.launches += 1
        return tproj.projection_plain(*args)

    monkeypatch.setattr(tupdate, "projection", launching)
    monkeypatch.setattr(tproj.projection, "launches", 0)
    cfg = tstate.D4PGConfig(**{**DIMS, "projection": projection})
    ts = tstate.init_state(cfg, seed=0, device="cpu")
    tupdate.update_step(cfg, ts, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in _batch(rng, 8).items()}))
    batches = [_batch(rng, 8) for _ in range(3)]
    tupdate.multi_update_step(cfg, ts, TransitionBatch(
        **{n: torch.from_numpy(np.stack([b[n] for b in batches]))
           for n in batches[0]}))
    assert tproj.projection.launches == launches


def test_update_step_pallas_ce_goes_through_the_fused_wrapper(
        rng, monkeypatch):
    """``pallas_ce`` reaches the fused wrapper (the CE kernels on the card)
    once per step and never the standalone projection."""
    from d4pg_tpu_torch.learner import update as tupdate
    from d4pg_tpu_torch.ops import projection_ce as tpce

    cfg = tstate.D4PGConfig(**{**DIMS, "projection": "pallas_ce"})
    calls = []

    def counted(*args):
        calls.append(args[0])
        return tpce.projection_ce(*args)

    def refused(*args):
        raise AssertionError("the standalone projection ran under pallas_ce")

    monkeypatch.setattr(tupdate, "projection_ce", counted)
    monkeypatch.setattr(tupdate, "projection", refused)
    ts = tstate.init_state(cfg, seed=0, device="cpu")
    m = tupdate.update_step(cfg, ts, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in _batch(rng, 8).items()}))
    assert calls == [cfg.support]
    assert not m["td_error"].requires_grad


@pytest.mark.parametrize("projection", ["pallas", "pallas_ce"])
def test_multi_update_step_matches_reference(rng, projection):
    """K = 3 stacked updates against the reference's lax.scan over the
    same batches and IS weights (tests/test_learner.py's K-step case)."""
    jcfg, js, tcfg, ts = _pair(seed=8, projection=projection)
    k, b = 3, 16
    batches = [_batch(rng, b) for _ in range(k)]
    stacked = {name: np.stack([x[name] for x in batches])
               for name in batches[0]}
    w = (0.5 + rng.random((k, b))).astype(np.float32)
    js2, jm = jax.jit(lambda s, bb, ww: jax_multi_update_step(
        jcfg, s, bb, ww))(
            js, JaxBatch(**{n: jnp.asarray(v) for n, v in stacked.items()}),
            jnp.asarray(w))
    tm = multi_update_step(tcfg, ts, TransitionBatch(
        **{n: torch.from_numpy(v) for n, v in stacked.items()}),
        torch.from_numpy(w))
    for name in ("critic_loss", "actor_loss", "q_mean", "td_error"):
        assert tm[name].shape[0] == k
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   err_msg=name, **TOL)
    _assert_params(js2.actor_params, ts.actor)
    _assert_params(js2.critic_params, ts.critic)
    _assert_params(js2.target_actor_params, ts.target_actor)
    _assert_params(js2.target_critic_params, ts.target_critic)
    _assert_adam(js2.critic_opt_state, ts.critic_opt, ts.critic)
    assert ts.step == int(js2.step) == k


def test_gaussian_noise_matches_reference():
    """sample with the reference's own draw injected, then three resets
    of the epsilon decay, on a batch of 4 environments."""
    key = jax.random.key(3)
    js = jnoise.gaussian.init(horizon=100, epsilon_0=0.3, batch_shape=(4,))
    ts = tnoise.gaussian.init(horizon=100, epsilon_0=0.3, batch_shape=(4,),
                              device="cpu")
    for _ in range(3):
        want = jnoise.gaussian.sample(js, key, (4, 2), mu=0.1, sigma=0.5)
        normal = torch.tensor(np.asarray(jax.random.normal(key, (4, 2))))
        got = tnoise.gaussian.sample(ts, None, (4, 2), mu=0.1, sigma=0.5,
                                     normal=normal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        js = jnoise.gaussian.reset(js, horizon=100, min_epsilon=0.05)
        ts = tnoise.gaussian.reset(ts, horizon=100, min_epsilon=0.05)
        np.testing.assert_allclose(ts.epsilon.numpy(), np.asarray(js.epsilon),
                                   rtol=1e-6)
        np.testing.assert_array_equal(ts.resets.numpy(), np.asarray(js.resets))
        key = jax.random.split(key)[0]
    gen = torch.Generator().manual_seed(0)
    drawn = tnoise.gaussian.sample(ts, gen, (4, 2))
    assert drawn.shape == (4, 2)
    with pytest.raises(ValueError, match="generator"):
        tnoise.gaussian.sample(ts, None, (4, 2))


def test_ou_noise_and_act_ou_match_reference(rng):
    """Five OU steps, a reset, and ``act_ou`` (greedy + OU advance +
    clip), each with the reference's normal draw injected."""
    jcfg, js, tcfg, ts = _pair(seed=9)
    obs = _batch(rng, 4)["obs"]
    jou = jnoise.ou.init(2, batch_shape=(4,), epsilon_0=0.8)
    tou = tnoise.ou.init(2, batch_shape=(4,), epsilon_0=0.8, device="cpu")
    key = jax.random.key(4)
    for _ in range(5):
        key, sub = jax.random.split(key)
        normal = torch.tensor(np.asarray(jax.random.normal(sub, (4, 2))))
        jou, want = jnoise.ou.sample(jou, sub, theta=0.3, sigma=0.2, dt=0.05)
        tou, got = tnoise.ou.sample(tou, None, theta=0.3, sigma=0.2, dt=0.05,
                                    normal=normal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(tou.x.numpy(), np.asarray(jou.x),
                                   rtol=1e-6, atol=1e-8)
    jou = jnoise.ou.reset(jou, horizon=50)
    tou = tnoise.ou.reset(tou, horizon=50)
    assert not tou.x.any()
    np.testing.assert_allclose(tou.epsilon.numpy(), np.asarray(jou.epsilon),
                               rtol=1e-6)

    key, sub = jax.random.split(key)
    want_a, jou = jax_act_ou(jcfg, js.actor_params, jnp.asarray(obs), jou,
                             sub, epsilon=2.0, sigma=3.0)
    normal = torch.tensor(np.asarray(jax.random.normal(sub, (4, 2))))
    got_a, tou = act_ou(ts.actor, torch.from_numpy(obs), tou, epsilon=2.0,
                        sigma=3.0, normal=normal)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(tou.x.numpy(), np.asarray(jou.x), rtol=1e-6)
    assert float(got_a.abs().max()) <= 1.0


def test_actor_step_leaves_no_critic_grad(rng):
    """Actor gradients reach only the actor: after a step the critic's
    .grad is still the critic loss's gradient."""
    _, _, tcfg, ts = _pair(seed=4)
    b = TransitionBatch(**{k: torch.from_numpy(v)
                           for k, v in _batch(rng, 16).items()})
    update_step(tcfg, ts, b)
    grads = [p.grad.clone() for p in ts.critic.parameters()]
    # recompute the critic-loss gradient at the pre-step critic
    _, _, _, fresh = _pair(seed=4)
    from d4pg_tpu_torch.core.losses import categorical_td_loss
    from d4pg_tpu_torch.ops.projection import projection

    with torch.no_grad():
        tp = fresh.target_critic(b.next_obs, fresh.target_actor(b.next_obs))
        proj = projection(tcfg.support, tp, b.reward, b.discount)
    loss, _ = categorical_td_loss(proj, fresh.critic(b.obs, b.action))
    want = torch.autograd.grad(loss, list(fresh.critic.parameters()))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w)


def test_from_jax_leaves_its_input_arrays_untouched(rng):
    """The port's Adam updates its moments in place; the arrays it was
    given (here views of the JAX buffers) must not change with them."""
    jcfg, js, tcfg, _ = _pair(seed=5)
    trees = _as_numpy(js)
    before = jax.tree_util.tree_map(np.copy, trees)
    ts = state_from_jax(tcfg, trees, "cpu")
    update_step(tcfg, ts, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in _batch(rng, 16).items()}))
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(trees)):
        np.testing.assert_array_equal(a, b)


def test_target_updates_match_reference():
    """soft_update is the reference's Polyak average; hard_update copies."""
    from d4pg_tpu.core.updates import soft_update as jax_soft_update
    from d4pg_tpu_torch.core.updates import hard_update, soft_update

    _, js, tcfg, ts = _pair(seed=6)
    _, js_other, _, other = _pair(seed=7)
    want = jax_soft_update(js.actor_params, js_other.actor_params, 0.005)
    soft_update(ts.actor, other.actor, 0.005)
    _assert_params(want, ts.actor)
    hard_update(ts.critic, other.critic)
    for a, b in zip(ts.critic.parameters(), other.critic.parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
