"""Port vs reference: the uniform fused chunk and buffer, and FusedLoop.

obs 8, act 2, hidden (32, 32, 32), 11 atoms, batch 16, capacity 64. The
uniform chunk draws its slots with ``torch.randint``; the reference's
with ``jax.random`` inside its scan, so the test injects the same slots
into both and runs the reference step by step (ring gather ->
``update_step`` without IS weights), at rtol 1e-5 / atol 1e-6.
``FusedLoop.run`` over an ``n`` that K does not divide equals the same
chunks called by hand, bitwise on the CPU (the loop fed by a
``ReplayService`` is in ``test_torch_ingest.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.learner import state as jstate
from d4pg_tpu.learner.update import update_step as jax_update_step
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxReplay
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.learner.fused import fused_chunk_step, make_fused_chunk
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-5, atol=1e-6)
OBS, ACT, CAPACITY, BATCH, K = 8, 2, 64, 16, 3
DIMS = dict(obs_dim=OBS, act_dim=ACT, v_min=-10.0, v_max=10.0, n_atoms=11,
            hidden=(32, 32, 32))


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


def _filled(rng, prioritized, with_jax=False):
    tbuf = FusedDeviceReplay(CAPACITY, OBS, ACT, prioritized=prioritized,
                             device="cpu")
    jbuf = (JaxReplay(CAPACITY, OBS, ACT, prioritized=prioritized)
            if with_jax else None)
    for n in (20, 30, 25):  # 75 rows: the last block wraps the ring
        rows = _rows(rng, n)
        tbuf.add(TransitionBatch(**rows))
        tbuf.drain()
        if jbuf is not None:
            jbuf.add(JaxBatch(**rows))
            jbuf.drain()
    return tbuf, jbuf


def test_uniform_buffer_has_no_trees_and_lands_the_same_ring(rng):
    tbuf, jbuf = _filled(rng, prioritized=False, with_jax=True)
    assert tbuf.trees is None and jbuf.trees is None
    assert (tbuf.size, tbuf.head) == (jbuf.size, jbuf.head) == (64, 11)
    for j, t in zip(jbuf.storage, tbuf.storage):
        np.testing.assert_array_equal(t[:CAPACITY].numpy(),
                                      np.asarray(j)[:CAPACITY])


@pytest.mark.parametrize("projection", ["pallas", "pallas_ce"])
def test_uniform_chunk_matches_reference_step_by_step(rng, projection):
    tbuf, jbuf = _filled(rng, prioritized=False, with_jax=True)
    jcfg = jstate.D4PGConfig(**DIMS, projection=projection)
    tcfg = tstate.D4PGConfig(**DIMS, projection=projection)
    js = jstate.init_state(jcfg, jax.random.key(0))
    ts = state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    slots = rng.integers(0, tbuf.size, (K, BATCH)).astype(np.int32)

    update = jax.jit(lambda s, b: jax_update_step(jcfg, s, b, None))
    jm = []
    for t in range(K):
        js, m = update(js, JaxBatch(*[arr[slots[t]]
                                      for arr in jbuf.storage]))
        jm.append(m)

    fn = make_fused_chunk(tcfg, k=K, batch_size=BATCH, prioritized=False)
    tm = fn(ts, tbuf.storage, tbuf.size, slots=torch.from_numpy(slots))
    np.testing.assert_array_equal(tm["idx"].numpy(), slots)
    for t in range(K):
        for name in ("critic_loss", "actor_loss", "q_mean", "td_error"):
            np.testing.assert_allclose(tm[name][t].numpy(),
                                       np.asarray(jm[t][name]),
                                       err_msg=f"{name} step {t}", **TOL)
    for jparams, module in ((js.critic_params, ts.critic),
                            (js.target_actor_params, ts.target_actor)):
        arrays = torch_layout(jparams["params"])
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), arrays[name],
                                       err_msg=name, **TOL)
    assert ts.step == int(js.step) == K


def test_uniform_chunk_draws_slots_from_generator(rng):
    tbuf, _ = _filled(rng, prioritized=False)
    cfg = tstate.D4PGConfig(**DIMS)
    fn = make_fused_chunk(cfg, k=K, batch_size=BATCH, prioritized=False)
    runs = []
    for _ in range(2):
        ts = tstate.init_state(cfg, seed=1, device="cpu")
        runs.append(fn(ts, tbuf.storage, tbuf.size,
                       generator=torch.Generator().manual_seed(9)))
    assert torch.equal(runs[0]["idx"], runs[1]["idx"])
    assert runs[0]["idx"].dtype == torch.int32
    assert int(runs[0]["idx"].max()) < tbuf.size
    with pytest.raises(ValueError, match="generator"):
        fn(ts, tbuf.storage, tbuf.size)
    draws = dict(u=torch.zeros(K, BATCH),
                 slots=torch.zeros(K, BATCH, dtype=torch.int32))
    for trees, wrong in ((None, "u"), (_filled(rng, True)[0].trees, "slots")):
        with pytest.raises(ValueError, match="uniform"):
            fused_chunk_step(cfg, ts, trees, tbuf.storage, tbuf.size, k=K,
                             batch_size=BATCH, **{wrong: draws[wrong]})


@pytest.mark.parametrize("prioritized", [True, False])
def test_loop_run_equals_chunks_by_hand(rng, prioritized):
    """n = 7 at K = 3: chunks of 3, 3 and a cached final 1."""
    buf_a, _ = _filled(rng, prioritized)
    buf_b = FusedDeviceReplay(CAPACITY, OBS, ACT, prioritized=prioritized,
                              device="cpu")
    buf_b.add(TransitionBatch(*[a[:CAPACITY].numpy()
                                for a in buf_a.storage]))
    buf_b.drain()
    cfg = tstate.D4PGConfig(**DIMS, projection="pallas_ce")

    loop_state = tstate.init_state(cfg, seed=2, device="cpu")
    loop = FusedLoop(cfg, buf_a, k=K, batch_size=BATCH,
                     generator=torch.Generator().manual_seed(4),
                     prioritized=prioritized)
    seen = []
    last = loop.run(loop_state, 7, on_chunk=lambda s, k: seen.append(k))
    assert seen == [3, 3, 1] and sorted(loop._fns) == [1, 3]
    assert (loop.steps_done, loop.chunks, loop_state.step) == (7, 3, 7)

    hand_state = tstate.init_state(cfg, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for k in (3, 3, 1):
        fn = make_fused_chunk(cfg, k=k, batch_size=BATCH,
                              prioritized=prioritized)
        if prioritized:
            buf_b.trees, hand = fn(hand_state, buf_b.trees, buf_b.storage,
                                   buf_b.size, generator=gen)
        else:
            hand = fn(hand_state, buf_b.storage, buf_b.size, generator=gen)
    for name in hand:
        assert torch.equal(last[name], hand[name]), name
    for a, b in zip(loop_state.critic.parameters(),
                    hand_state.critic.parameters()):
        assert torch.equal(a, b)
    if prioritized:
        assert torch.equal(buf_a.trees.sum_tree, buf_b.trees.sum_tree)
    assert loop.run(loop_state, 0) is None
    loop.close()


def test_loop_refuses_a_service_and_a_treeless_per_buffer(rng):
    """A service must be a ReplayService (the loop drives its ingest
    calls); anything else is refused, as is a PER loop without trees."""
    cfg = tstate.D4PGConfig(**DIMS)
    buf, _ = _filled(rng, prioritized=False)
    gen = torch.Generator()
    with pytest.raises(TypeError, match="ReplayService"):
        FusedLoop(cfg, buf, k=K, batch_size=BATCH, generator=gen,
                  prioritized=False, service=object())
    with pytest.raises(ValueError, match="PER trees"):
        FusedLoop(cfg, buf, k=K, batch_size=BATCH, generator=gen)
