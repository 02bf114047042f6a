"""Port vs reference: the fused PER replay+learn chunk as a whole.

obs 8, act 2, hidden (32, 32, 32), 11 atoms, batch 16, capacity 64,
K = 3, with injected uniforms. The reference's ``fused_chunk_step`` draws
its uniforms with ``jax.random`` inside the scan, so the JAX side is built
step by step from its public functions: ``sample_from_uniforms`` ->
``is_weights`` -> ring gather -> ``update_step`` -> ``update_from_td``.
Both buffers are filled through their own ``add``/``drain`` with the same
rows (wrapping the ring). Slots are equal at every step; metrics,
parameters and trees match at rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.learner import state as jstate
from d4pg_tpu.learner.update import update_step as jax_update_step
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxReplay
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.learner.fused import make_fused_chunk
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-5, atol=1e-6)
OBS, ACT, CAPACITY, BATCH, K, ALPHA = 8, 2, 64, 16, 3, 0.6
DIMS = dict(obs_dim=OBS, act_dim=ACT, v_min=-10.0, v_max=10.0, n_atoms=11,
            hidden=(32, 32, 32), projection="pallas")


def _rows(rng, n):
    done = (rng.random(n) < 0.2).astype(np.float32)
    return dict(
        obs=rng.standard_normal((n, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.uniform(-12, 12, n).astype(np.float32),
        next_obs=rng.standard_normal((n, OBS)).astype(np.float32),
        done=done,
        discount=(0.99 ** 3 * (1 - done)).astype(np.float32),
    )


def _filled_pair(rng):
    jbuf = JaxReplay(CAPACITY, OBS, ACT, alpha=ALPHA)
    tbuf = FusedDeviceReplay(CAPACITY, OBS, ACT, alpha=ALPHA, device="cpu")
    for n in (20, 30, 25):  # 75 rows: the last block wraps the ring
        rows = _rows(rng, n)
        jbuf.add(JaxBatch(**rows))
        tbuf.add(TransitionBatch(**rows))
        jbuf.drain()
        tbuf.drain()
    return jbuf, tbuf


def _assert_trees(jt, tt, **tol):
    for j, t in zip(jt, tt):
        if tol:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_fill_lands_the_same_ring_and_trees(rng):
    jbuf, tbuf = _filled_pair(rng)
    assert (tbuf.size, tbuf.head) == (jbuf.size, jbuf.head) == (64, 11)
    for j, t in zip(jbuf.storage, tbuf.storage):
        np.testing.assert_array_equal(t[:CAPACITY].numpy(),
                                      np.asarray(j)[:CAPACITY])
    _assert_trees(jbuf.trees, tbuf.trees)


def test_fused_chunk_matches_reference_step_by_step(rng):
    jbuf, tbuf = _filled_pair(rng)
    jcfg = jstate.D4PGConfig(**DIMS)
    tcfg = tstate.D4PGConfig(**DIMS)
    js = jstate.init_state(jcfg, jax.random.key(0))
    ts = state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    u = rng.random((K, BATCH)).astype(np.float32)

    # the reference, one public function at a time
    update = jax.jit(lambda s, b, w: jax_update_step(jcfg, s, b, w))
    jt, size, jm = jbuf.trees, jbuf.size, []
    for t in range(K):
        idx = jdper.sample_from_uniforms(jt, jnp.asarray(u[t]),
                                         jnp.int32(size))
        beta = jdper.beta_schedule(js.step, 0.4, 100_000)
        w = jdper.is_weights(jt, idx, beta, jnp.int32(size))
        batch = JaxBatch(*[arr[idx] for arr in jbuf.storage])
        js, m = update(js, batch, w)
        jt = jdper.update_from_td(jt, idx, m["td_error"], ALPHA)
        jm.append({**m, "idx": idx})

    fn = make_fused_chunk(tcfg, k=K, batch_size=BATCH, alpha=ALPHA)
    tt, tm = fn(ts, tbuf.trees, tbuf.storage, tbuf.size,
                u=torch.from_numpy(u))

    for t in range(K):
        np.testing.assert_array_equal(tm["idx"][t].numpy(),
                                      np.asarray(jm[t]["idx"]))
        for name in ("critic_loss", "actor_loss", "q_mean", "td_error"):
            np.testing.assert_allclose(tm[name][t].numpy(),
                                       np.asarray(jm[t][name]),
                                       err_msg=f"{name} step {t}", **TOL)
    for jparams, module in ((js.actor_params, ts.actor),
                            (js.critic_params, ts.critic),
                            (js.target_actor_params, ts.target_actor),
                            (js.target_critic_params, ts.target_critic)):
        arrays = torch_layout(jparams["params"])
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), arrays[name],
                                       err_msg=name, **TOL)
    _assert_trees(jt, tt, **TOL)
    assert ts.step == int(js.step) == K


def test_fused_chunk_draws_from_generator(rng):
    """Without injected uniforms the chunk draws them from its generator:
    same generator seed, same chunk."""
    _, tbuf = _filled_pair(rng)
    cfg = tstate.D4PGConfig(**DIMS)
    runs = []
    for _ in range(2):
        ts = tstate.init_state(cfg, seed=1, device="cpu")
        fn = make_fused_chunk(cfg, k=K, batch_size=BATCH)
        trees, m = fn(ts, tbuf.trees, tbuf.storage, tbuf.size,
                      generator=torch.Generator().manual_seed(9))
        runs.append((trees, m))
    assert torch.equal(runs[0][1]["idx"], runs[1][1]["idx"])
    assert torch.equal(runs[0][0].sum_tree, runs[1][0].sum_tree)
    assert runs[0][1]["td_error"].shape == (K, BATCH)
    with pytest.raises(ValueError, match="generator"):
        fn(ts, tbuf.trees, tbuf.storage, tbuf.size)
