"""Port vs reference: whole updates of the learner's model families.

The same weights (``io.from_jax``), batches and IS weights go through the
reference's jitted ``update_step`` / ``multi_update_step`` (K = 3) and
the port's, with the reference's own random draws injected into the
port (``UpdateDraws``): the DrQ offsets each step's key draws
(``key, sub = split(state.key)``; ``sub, k_obs, k_next = split(sub, 3)``;
one ``fold_in`` per sample) and the MoG step's Gumbel and normal draws
(``key_c, key_z = split(sub)``). Families:

  - the pixel categorical critic with ``augment='shift'`` and
    ``share_encoder=True`` under ``einsum`` and ``pallas_ce`` (the
    reference's CE kernel in interpret mode, as its own tests run it);
  - the MoG critic at ``n_components=3``, ``mog_samples=16``;
  - float32 at the learner's bars (losses and TD errors rtol 1e-4,
    parameters atol 1e-5); ``bfloat16`` products against the reference's
    bfloat16 on the first step's losses at rtol 2e-2.

Then the fused chunk over uint8 pixel rows and over MoG on the fused
buffer, and ``ChunkPipeline`` over pixel rows on both storages, against
the reference: slots and IS weights bitwise, uint8 rows bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.learner import pipeline as jpipe
from d4pg_tpu.learner import state as jstate
from d4pg_tpu.learner.update import make_multi_update
from d4pg_tpu.learner.update import multi_update_step as jax_multi_update
from d4pg_tpu.learner.update import update_step as jax_update_step
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay import prioritized as jper
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxReplay
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.io.checkpoint import CheckpointManager
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner import pipeline as tpipe
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.learner.fused import make_fused_chunk
from d4pg_tpu_torch.learner.update import (
    UpdateDraws,
    multi_update_step,
    update_step,
)
from d4pg_tpu_torch.ops.projection import check_operands
from d4pg_tpu_torch.replay import prioritized as tper
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

RTOL = 1e-4
PARAM_ATOL = 1e-5
SHAPE = (16, 16, 3)
PIXEL = dict(obs_dim=int(np.prod(SHAPE)), act_dim=2, v_min=-20.0,
             v_max=0.0, n_atoms=11, hidden=(32, 32), pixels=True,
             obs_shape=SHAPE, encoder_channels=(8, 8, 8, 8),
             augment="shift", share_encoder=True)
MOG = dict(obs_dim=6, act_dim=2, v_min=-20.0, v_max=0.0, hidden=(32, 32),
           critic_family="mog", n_components=3, mog_samples=16)
VECTOR = dict(obs_dim=6, act_dim=2, v_min=-20.0, v_max=0.0, n_atoms=11,
              hidden=(32, 32))


def _offsets(key, b, pad):
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(b))
    return np.array(jax.vmap(
        lambda k: jax.random.randint(k, (2,), 0, 2 * pad + 1))(keys))


def reference_draws(jcfg, key, k, b):
    """The draws the reference's update takes at each of ``k`` steps from
    the state's ``key``, stacked [k, ...] for the port; and the key after
    them."""
    out = {name: [] for name in UpdateDraws._fields}
    for _ in range(k):
        key, sub = jax.random.split(key)
        if jcfg.augment == "shift":
            sub, k_obs, k_next = jax.random.split(sub, 3)
            out["obs_shift"].append(_offsets(k_obs, b, jcfg.augment_pad))
            out["next_shift"].append(_offsets(k_next, b, jcfg.augment_pad))
        if jcfg.critic_family == "mog":
            key_c, key_z = jax.random.split(sub)
            s, c = jcfg.mog_samples, jcfg.n_components
            out["gumbel"].append(np.array(jax.random.gumbel(key_c,
                                                            (b, s, c))))
            out["normal"].append(np.array(jax.random.normal(key_z, (b, s))))
    return UpdateDraws(*[torch.from_numpy(np.stack(v)) if v else None
                         for v in out.values()]), key


def _pair(kw, seed=0):
    jcfg, tcfg = jstate.D4PGConfig(**kw), tstate.D4PGConfig(**kw)
    js = jstate.init_state(jcfg, jax.random.key(seed))
    ts = state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    return jcfg, js, tcfg, ts


def _rows(rng, lead, obs_shape):
    pixels = len(obs_shape) == 3
    obs = (lambda: rng.integers(0, 256, (*lead, *obs_shape), dtype=np.uint8)
           ) if pixels else (lambda: rng.standard_normal(
               (*lead, *obs_shape)).astype(np.float32))
    done = (rng.random(lead) < 0.25).astype(np.float32)
    return dict(obs=obs(), action=rng.uniform(-1, 1, (*lead, 2)).astype(
        np.float32), reward=rng.uniform(-5, 0, lead).astype(np.float32),
        next_obs=obs(), done=done,
        discount=(0.97 * (1 - done)).astype(np.float32))


def _assert_params(jparams, module, atol=PARAM_ATOL):
    arrays = torch_layout(jparams["params"])
    named = dict(module.named_parameters())
    assert set(arrays) == set(named)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), arrays[name],
                                   atol=atol, rtol=0, err_msg=name)


def _assert_states(js, ts):
    _assert_params(js.actor_params, ts.actor)
    _assert_params(js.critic_params, ts.critic)
    _assert_params(js.target_actor_params, ts.target_actor)
    _assert_params(js.target_critic_params, ts.target_critic)
    assert ts.step == int(js.step)


def _obs_shape(kw):
    return kw["obs_shape"] if kw.get("pixels") else (kw["obs_dim"],)


FAMILIES = [("pixel", PIXEL, "einsum"), ("pixel", PIXEL, "pallas_ce"),
            ("mog", MOG, "einsum")]


@pytest.mark.parametrize("name,kw,projection", FAMILIES,
                         ids=[f"{n}-{p}" for n, _, p in FAMILIES])
def test_update_step_matches_reference(rng, name, kw, projection):
    jcfg, js, tcfg, ts = _pair({**kw, "projection": projection}, seed=2)
    b = _rows(rng, (8,), _obs_shape(kw))
    w = (0.5 + rng.random(8)).astype(np.float32)
    draws, _ = reference_draws(jcfg, js.key, 1, 8)
    js2, jm = jax.jit(lambda s, bb, ww: jax_update_step(jcfg, s, bb, ww))(
        js, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
        jnp.asarray(w))
    tm = update_step(tcfg, ts, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in b.items()}),
        torch.from_numpy(w), draws.at(0))
    for metric in ("critic_loss", "actor_loss", "q_mean", "td_error"):
        np.testing.assert_allclose(tm[metric].numpy(), np.asarray(jm[metric]),
                                   rtol=RTOL, err_msg=metric)
    _assert_states(js2, ts)


@pytest.mark.parametrize("name,kw,projection", FAMILIES,
                         ids=[f"{n}-{p}" for n, _, p in FAMILIES])
def test_multi_update_step_matches_reference(rng, name, kw, projection):
    """K = 3 updates against the reference's ``lax.scan`` over the same
    stacked batches and IS weights, each step with its own draws."""
    k, b = 3, 8
    jcfg, js, tcfg, ts = _pair({**kw, "projection": projection}, seed=8)
    rows = _rows(rng, (k, b), _obs_shape(kw))
    w = (0.5 + rng.random((k, b))).astype(np.float32)
    draws, _ = reference_draws(jcfg, js.key, k, b)
    js2, jm = jax.jit(lambda s, bb, ww: jax_multi_update(jcfg, s, bb, ww))(
        js, JaxBatch(**{n: jnp.asarray(v) for n, v in rows.items()}),
        jnp.asarray(w))
    tm = multi_update_step(tcfg, ts, TransitionBatch(
        **{n: torch.from_numpy(v) for n, v in rows.items()}),
        torch.from_numpy(w), draws)
    for metric in ("critic_loss", "actor_loss", "td_error"):
        assert tm[metric].shape[0] == k
        np.testing.assert_allclose(tm[metric].numpy(), np.asarray(jm[metric]),
                                   rtol=RTOL, err_msg=metric)
    _assert_states(js2, ts)
    if kw.get("share_encoder"):
        for a, c in zip(ts.actor.encoder.parameters(),
                        ts.critic.encoder.parameters()):
            assert torch.equal(a, c)


@pytest.mark.parametrize("carry", ["from_jax", "restore"])
def test_share_encoder_flip_matches_reference(rng, tmp_path, carry):
    """An unshared pixel state, stepped three times by the reference, then
    carried into a ``share_encoder`` state (``state_from_jax``, or a
    checkpoint of it restored into a shared template): its target encoders
    are not tied, so the first shared step runs both of them and reuses
    only the actor step's latent (1 a step), the second reuses both (2).
    Both steps hold to the reference's at the learner's bars."""
    b = 8
    unshared = {**PIXEL, "share_encoder": False, "projection": "einsum"}
    shared = {**PIXEL, "projection": "einsum"}
    j0 = jstate.D4PGConfig(**unshared)
    rows = _rows(rng, (3, b), SHAPE)
    # moved off init, so each network's action and value depend on its
    # own encoder's latent beyond the bars
    noise = np.random.default_rng(5)
    js = jstate.init_state(j0, jax.random.key(5))
    js = js._replace(**{f: jax.tree_util.tree_map(
        lambda x: x + 0.1 * noise.standard_normal(x.shape).astype(np.float32),
        getattr(js, f)) for f in ("actor_params", "critic_params",
                                  "target_actor_params",
                                  "target_critic_params")})
    js, _ = jax.jit(lambda s, bb, ww: jax_multi_update(j0, s, bb, ww))(
        js,
        JaxBatch(**{n: jnp.asarray(v) for n, v in rows.items()}),
        jnp.asarray((0.5 + rng.random((3, b))).astype(np.float32)))
    carried = jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key)))
    tcfg = tstate.D4PGConfig(**shared)
    if carry == "from_jax":
        ts = state_from_jax(tcfg, carried, "cpu")
    else:
        ckpt = CheckpointManager(str(tmp_path))
        ckpt.save(state_from_jax(tstate.D4PGConfig(**unshared), carried,
                                 "cpu"))
        ts, _ = ckpt.restore(tstate.init_state(tcfg, 0, "cpu"))
    assert ts.step == 3 and not ts.targets_tied
    assert any(not torch.equal(a, c) for a, c in zip(
        ts.target_actor.encoder.parameters(),
        ts.target_critic.encoder.parameters()))
    jcfg = jstate.D4PGConfig(**shared)
    draws, _ = reference_draws(jcfg, js.key, 2, b)
    jstep = jax.jit(lambda s, bb, ww: jax_update_step(jcfg, s, bb, ww))
    for t, reused in enumerate((1, 2)):
        batch = _rows(rng, (b,), SHAPE)
        w = (0.5 + rng.random(b)).astype(np.float32)
        js, jm = jstep(js, JaxBatch(**{n: jnp.asarray(v)
                                       for n, v in batch.items()}),
                       jnp.asarray(w))
        before = update_step.encoder_reused
        tm = update_step(tcfg, ts, TransitionBatch(
            **{n: torch.from_numpy(v) for n, v in batch.items()}),
            torch.from_numpy(w), draws.at(t))
        assert update_step.encoder_reused - before == reused
        assert ts.targets_tied
        for metric in ("critic_loss", "actor_loss", "q_mean", "td_error"):
            np.testing.assert_allclose(
                tm[metric].numpy(), np.asarray(jm[metric]), rtol=RTOL,
                err_msg=f"step {t}: {metric}")
        _assert_states(js, ts)


BF16 = [("vector", VECTOR), ("pixel", PIXEL), ("mog", MOG)]


@pytest.mark.parametrize("name,kw", BF16, ids=[n for n, _ in BF16])
def test_bfloat16_first_step_matches_reference_bf16(rng, name, kw):
    """bfloat16 products on both sides (the CPU's bf16 matmuls and XLA's
    differ in accumulation order): the first step's losses at rtol 2e-2."""
    kw = {**kw, "compute_dtype": "bfloat16", "projection": "einsum"}
    jcfg, js, tcfg, ts = _pair(kw, seed=3)
    b = _rows(rng, (16,), _obs_shape(kw))
    draws, _ = reference_draws(jcfg, js.key, 1, 16)
    _, jm = jax.jit(lambda s, bb: jax_update_step(jcfg, s, bb))(
        js, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}))
    tm = update_step(tcfg, ts, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in b.items()}), None, draws.at(0))
    for metric in ("critic_loss", "actor_loss"):
        assert tm[metric].dtype == torch.float32
        np.testing.assert_allclose(float(tm[metric]), float(jm[metric]),
                                   rtol=2e-2, err_msg=metric)


def test_bfloat16_compute_dtype(rng):
    """The reference's ``test_bfloat16_compute_dtype`` on the port: the
    update runs, the loss is float32 and falls over 40 steps on a fixed
    batch, and the parameters and Adam moments stay float32."""
    config = tstate.D4PGConfig(obs_dim=3, act_dim=1, v_min=-10.0, v_max=10.0,
                               n_atoms=11, hidden=(32, 32, 32),
                               compute_dtype="bfloat16", projection="einsum")
    state = tstate.init_state(config, 6, "cpu")
    rows = _rows(rng, (32,), (3,))
    rows["action"] = rows["action"][:, :1]
    batch = TransitionBatch(**{k: torch.from_numpy(v)
                               for k, v in rows.items()})
    first = None
    for _ in range(40):
        metrics = update_step(config, state, batch)
        if first is None:
            first = float(metrics["critic_loss"])
    assert metrics["critic_loss"].dtype == torch.float32
    assert float(metrics["critic_loss"]) < first
    for p in state.critic.parameters():
        assert p.dtype == torch.float32
        assert state.critic_opt.state[p]["exp_avg"].dtype == torch.float32
    # the products really ran in bfloat16: the same forward in float32
    # differs, within bfloat16's precision
    f32 = tstate.D4PGConfig(**{**config.__dict__,
                               "compute_dtype": "float32"})
    twin = f32.build_critic(torch.Generator())
    twin.load_state_dict(state.critic.state_dict())
    with torch.no_grad():
        low = state.critic(batch.obs, batch.action, return_logits=True)
        high = twin(batch.obs, batch.action, return_logits=True)
    assert low.dtype == high.dtype == torch.float32
    assert not torch.equal(low, high)
    torch.testing.assert_close(low, high, rtol=0.05, atol=0.05)


def test_bad_compute_dtype_rejected():
    with pytest.raises(ValueError, match="compute_dtype"):
        tstate.D4PGConfig(obs_dim=3, act_dim=1, compute_dtype="float16")


def test_kernel_operands_stay_float32():
    """Under bfloat16 the head goes back to float32 before the softmax, so
    the kernels get float32; their operand check refuses anything else
    loudly and never casts."""
    config = tstate.D4PGConfig(**{**VECTOR, "compute_dtype": "bfloat16"})
    critic = config.build_critic(torch.Generator().manual_seed(0))
    with torch.no_grad():
        probs = critic(torch.randn(4, 6), torch.zeros(4, 2))
    assert probs.dtype == torch.float32
    r = torch.zeros(4)
    check_operands(config.support, probs, r, r)
    with pytest.raises(TypeError, match="float32"):
        check_operands(config.support, probs.bfloat16(), r, r)


# --- the fused chunk and the host pipeline over the new families --------

CAPACITY, BATCH, K, ALPHA = 64, 8, 3, 0.6


def _filled_fused(rng, kw):
    shape = _obs_shape(kw)
    spec = shape if len(shape) == 3 else shape[0]
    jbuf = JaxReplay(CAPACITY, spec, 2, alpha=ALPHA)
    tbuf = FusedDeviceReplay(CAPACITY, spec, 2, alpha=ALPHA, device="cpu")
    for n in (20, 30, 25):  # 75 rows: the last block wraps the ring
        rows = _rows(rng, (n,), shape)
        jbuf.add(JaxBatch(**rows))
        tbuf.add(TransitionBatch(**rows))
        jbuf.drain()
        tbuf.drain()
    return jbuf, tbuf


@pytest.mark.parametrize("name,kw", [("pixel", PIXEL), ("mog", MOG)])
def test_fused_chunk_matches_reference(rng, name, kw):
    """The reference built step by step from its public functions
    (``sample_from_uniforms`` -> ``is_weights`` -> gather -> update ->
    ``update_from_td``); the port's fused chunk with the same uniforms
    and the update's draws injected. The rings hold the same uint8 rows
    bitwise; slots are equal at every step."""
    jbuf, tbuf = _filled_fused(rng, kw)
    for j, t in zip(jbuf.storage, tbuf.storage):
        assert t.dtype == torch.from_numpy(np.array(j[:0])).dtype
        np.testing.assert_array_equal(t[:CAPACITY].numpy(),
                                      np.asarray(j)[:CAPACITY])
    jcfg, js, tcfg, ts = _pair({**kw, "projection": "pallas"}, seed=0)
    u = rng.random((K, BATCH)).astype(np.float32)
    draws, _ = reference_draws(jcfg, js.key, K, BATCH)

    update = jax.jit(lambda s, b, w: jax_update_step(jcfg, s, b, w))
    jt, size, jm = jbuf.trees, jbuf.size, []
    for t in range(K):
        idx = jdper.sample_from_uniforms(jt, jnp.asarray(u[t]),
                                         jnp.int32(size))
        beta = jdper.beta_schedule(js.step, 0.4, 100_000)
        w = jdper.is_weights(jt, idx, beta, jnp.int32(size))
        js, m = update(js, JaxBatch(*[arr[idx] for arr in jbuf.storage]), w)
        jt = jdper.update_from_td(jt, idx, m["td_error"], ALPHA)
        jm.append({**m, "idx": idx})

    fn = make_fused_chunk(tcfg, k=K, batch_size=BATCH, alpha=ALPHA)
    tt, tm = fn(ts, tbuf.trees, tbuf.storage, tbuf.size,
                u=torch.from_numpy(u), draws=draws)
    for t in range(K):
        np.testing.assert_array_equal(tm["idx"][t].numpy(),
                                      np.asarray(jm[t]["idx"]))
        for metric in ("critic_loss", "actor_loss", "td_error"):
            np.testing.assert_allclose(tm[metric][t].numpy(),
                                       np.asarray(jm[t][metric]), rtol=RTOL,
                                       err_msg=f"{metric} step {t}")
    _assert_states(js, ts)


@pytest.mark.parametrize("storage", ["host", "device"])
def test_pixel_pipeline_matches_reference(rng, storage):
    """Two K = 3 chunks of uint8 rows sampled from a host PER buffer
    through ``ChunkPipeline``, the port's ``multi_update_step`` against
    the reference's jitted one: the sampled rows bitwise, slots and IS
    weights bitwise, losses and TD errors at rtol 1e-4."""
    cap, n = 200, 150
    jcfg, js, tcfg, ts = _pair({**PIXEL, "projection": "pallas_ce"}, seed=4)
    jbuf = jper.PrioritizedReplayBuffer(cap, SHAPE, 2, seed=9,
                                        backend="numpy")
    tbuf = tper.PrioritizedReplayBuffer(cap, SHAPE, 2, seed=9,
                                        storage=storage, device="cpu")
    rows = _rows(rng, (n,), SHAPE)
    jbuf.add(jper.TransitionBatch(**rows))
    tbuf.add(tper.TransitionBatch(**rows))
    samples = {"port": [], "reference": []}
    metrics = {"port": [], "reference": []}
    chunk_draws = []

    def sampler(buf, side):
        def sample():
            batches, w, idx = buf.sample_chunk(K, BATCH, beta=0.4)
            samples[side].append(([np.array(np.asarray(f)) for f in batches],
                                  idx, w))
            return (batches, w), (idx, buf.generation[idx].copy())
        return sample

    def write_back(buf):
        def back(aux, td):
            idx, gen = aux
            for i in range(len(idx)):
                buf.update_priorities(idx[i], td[i], generation=gen[i])
        return back

    jupdate = make_multi_update(jcfg, donate=False)

    def jax_update(state, batches, w):
        chunk_draws.append(reference_draws(jcfg, state.key, K, BATCH)[0])
        state, m = jupdate(state, batches, w)
        metrics["reference"].append(m)
        return state, m

    def port_update(state, batches, w):
        m = multi_update_step(tcfg, state, batches, w, chunk_draws.pop(0))
        metrics["port"].append(m)
        return state, m

    jpipe.ChunkPipeline(jax_update, sampler(jbuf, "reference"),
                        write_back(jbuf)).run(js, 2, final_prefetch=False)
    tpipe.ChunkPipeline(port_update, sampler(tbuf, "port"),
                        write_back(tbuf), device="cpu").run(
                            ts, 2, final_prefetch=False)
    assert len(samples["port"]) == len(samples["reference"]) == 2
    for (trows, ti, tw), (jrows, ji, jw) in zip(samples["port"],
                                                samples["reference"]):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tw, jw)
        assert trows[0].dtype == np.uint8
        for t, j in zip(trows, jrows):
            np.testing.assert_array_equal(t, j)
    for tm, jm in zip(metrics["port"], metrics["reference"]):
        for metric in ("critic_loss", "actor_loss", "td_error"):
            np.testing.assert_allclose(tm[metric].numpy(),
                                       np.asarray(jm[metric]), rtol=RTOL,
                                       err_msg=metric)
