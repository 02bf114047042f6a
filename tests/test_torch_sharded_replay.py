"""Port vs reference: the data-sharded device replay and its fused chunk.

The reference's ten ``tests/test_sharded_replay.py`` cases on the port.
Buffers of both packages take the same adds: storage, trees, cursors and
sizes are bitwise equal (insert, wrap, overflow). The fused chunk is held
against ``make_sharded_fused_chunk`` itself on a 4-device slice of the
virtual CPU mesh, with the uniforms the reference's chunk draws
internally injected into the port: its key chain is ``split(state.key)``
per step, ``fold_in(k_sample, axis_index)`` per shard, then
``uniform((b_local,))`` (``d4pg_tpu/learner/fused.py``,
``d4pg_tpu/replay/device_per.py``), and ``update_step`` splits the key
once more per step. Two forms: one process holding all four shards
(``n_local = 4``), and two gloo ranks holding two each. Slots are bitwise
equal; losses at rtol 1e-5, ``td_error`` at rtol 1e-4 / atol 1e-5,
trees and parameters at rtol 1e-4 / atol 1e-6 (the reference's
``tests/test_parallel.py`` bars), and the IS weights at the port's
``is_weights`` bar, rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from d4pg_tpu.learner import D4PGConfig as JaxConfig
from d4pg_tpu.learner import init_state as jax_init_state
from d4pg_tpu.learner.fused import make_sharded_fused_chunk as jax_chunk
from d4pg_tpu.parallel import MeshSpec as JaxMeshSpec
from d4pg_tpu.parallel import make_mesh
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay.sharded_per import ShardedFusedReplay as JaxSharded
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner.fused import (
    make_sharded_fused_chunk,
    shard_weights,
)
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.parallel import RankMesh, spawn_local
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay

pytestmark = pytest.mark.torchport

LOSS = dict(rtol=1e-5)
TD = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-6)
WEIGHTS = dict(rtol=1e-5, atol=1e-6)
KW = dict(obs_dim=4, act_dim=2, v_min=-10.0, v_max=10.0, n_atoms=11,
          hidden=(16, 16, 16), projection="einsum")


def _jmesh(dp=4):
    return make_mesh(JaxMeshSpec(data_parallel=dp),
                     devices=jax.devices()[:dp])


def _rows(rng, n, lo=0):
    return dict(
        obs=rng.standard_normal((n, 4)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        reward=np.arange(lo, lo + n, dtype=np.float32),
        next_obs=rng.standard_normal((n, 4)).astype(np.float32),
        done=(rng.random(n) < 0.2).astype(np.float32),
        discount=np.full(n, 0.99, np.float32),
    )


def _pair_buffers(capacity, blocks, dp=4, prioritized=True):
    jbuf = JaxSharded(capacity, 4, 2, _jmesh(dp), alpha=0.6,
                      prioritized=prioritized)
    tbuf = ShardedFusedReplay(capacity, 4, 2, RankMesh.local("cpu", dp),
                              alpha=0.6, prioritized=prioritized)
    for block in blocks:
        for rows in block:
            jbuf.add(JaxBatch(**rows))
            tbuf.add(torch_ranks.batch_of(rows))
        assert len(jbuf) == len(tbuf)
        assert jbuf.drain() == tbuf.drain()
    return jbuf, tbuf


def _assert_buffers_equal(jbuf, tbuf):
    np.testing.assert_array_equal(tbuf._size, jbuf._size)
    np.testing.assert_array_equal(tbuf._head, jbuf._head)
    assert tbuf._rr == jbuf._rr and tbuf.cap_shard == jbuf.cap_shard
    for j, t in zip(jbuf.storage, tbuf.storage):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if jbuf.trees is not None:
        for j, t in zip(jbuf.trees, tbuf.trees):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def reference_uniforms(key, k, n_shards, b_local, sizes=None):
    """The [K, n_shards, b_local] draws of the reference's sharded chunk
    from the state's key: PER uniforms, or (``sizes`` given) the uniform
    replay's slots."""
    out = []
    for _ in range(k):
        k_sample, key = jax.random.split(key)
        row = []
        for ax in range(n_shards):
            sub = jax.random.fold_in(k_sample, ax)
            row.append(np.asarray(
                jax.random.uniform(sub, (b_local,)) if sizes is None else
                jax.random.randint(sub, (b_local,), 0,
                                   max(int(sizes[ax]), 1))))
        out.append(np.stack(row))
        key, _ = jax.random.split(key)  # update_step's own split
    return np.stack(out)


def _states(seed):
    jcfg, tcfg = JaxConfig(**KW), D4PGConfig(**KW)
    js = jax_init_state(jcfg, jax.random.key(seed))
    ts = state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    return jcfg, js, tcfg, ts


def _assert_params(jstate, got):
    for field, module in (("critic_params", "critic"),
                          ("actor_params", "actor"),
                          ("target_critic_params", "target_critic")):
        want = torch_layout(jax.device_get(getattr(jstate, field))["params"])
        for name, arr in want.items():
            np.testing.assert_allclose(got[module][name], arr, **PARAMS,
                                       err_msg=f"{module}.{name}")


def test_round_robin_insert_balances_shards(rng):
    jbuf, tbuf = _pair_buffers(64, [[_rows(rng, 10), _rows(rng, 7)]])
    assert tbuf.n_shards == 4 and tbuf.cap_shard == 16
    assert len(tbuf) == 17
    assert tbuf._size.max() - tbuf._size.min() <= 1
    rewards = np.sort(np.concatenate([
        tbuf.storage.reward[s, :tbuf._size[s]].numpy() for s in range(4)]))
    np.testing.assert_array_equal(
        rewards, np.sort(np.concatenate([np.arange(10), np.arange(7)])))
    for s in range(4):
        assert tbuf.trees.sum_tree[s, 1].item() == tbuf._size[s]
    _assert_buffers_equal(jbuf, tbuf)


def test_ring_wrap_per_shard(rng):
    jbuf, tbuf = _pair_buffers(16, [[_rows(rng, 10, 10 * i)]
                                    for i in range(3)], prioritized=False)
    assert tbuf._size.sum() == 16 and all(tbuf._size == 4)
    assert tbuf.trees is None
    _assert_buffers_equal(jbuf, tbuf)


def _chunk_pair(rng, k=3, batch=16, seed=0):
    """The reference's chunk on a full 64-row, 4-shard buffer, and what
    the port needs to replay it: its uniforms and its buffer's rows."""
    jcfg, js, tcfg, ts = _states(seed)
    jbuf, tbuf = _pair_buffers(64, [[_rows(rng, 64)]])
    u = reference_uniforms(js.key, k, 4, batch // 4)
    fn = jax_chunk(jcfg, _jmesh(4), k=k, batch_size=batch, alpha=0.6,
                   donate=False)
    jnext, jtrees, jm = fn(js, jbuf.trees, jbuf.storage, jbuf.size)
    return dict(jcfg=jcfg, js=js, tcfg=tcfg, ts=ts, jbuf=jbuf, tbuf=tbuf,
                u=u, jnext=jnext, jtrees=jtrees, jm=jm)


def test_sharded_fused_chunk_per_one_process_matches_reference(rng):
    """n_local = 4 in one process against the reference's 4-device
    chunk: slots bitwise, trees, losses, td and parameters at the bars;
    the first step's IS weights against the reference's formula."""
    p = _chunk_pair(rng)
    tbuf = p["tbuf"]
    mesh = RankMesh.local("cpu", 4)
    fn = make_sharded_fused_chunk(p["tcfg"], mesh, k=3, batch_size=16)
    trees, m = fn(p["ts"], tbuf.trees, tbuf.storage, tbuf.size,
                  u=torch.from_numpy(p["u"]))
    jm = p["jm"]
    np.testing.assert_array_equal(m["idx"].numpy(), np.asarray(jm["idx"]))
    assert p["ts"].step == 3 and tuple(m["td_error"].shape) == (3, 16)
    np.testing.assert_allclose(m["critic_loss"].numpy(),
                               np.asarray(jm["critic_loss"]), **LOSS)
    np.testing.assert_allclose(m["td_error"].numpy(),
                               np.asarray(jm["td_error"]), **TD)
    for j, t in zip(p["jtrees"], trees):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **PARAMS)
    _assert_params(p["jnext"], torch_ranks.params(p["ts"]))
    # the input trees are untouched
    for j, t in zip(p["jbuf"].trees, tbuf.trees):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # IS weights of the first step, the reference's formula in jnp
    idx = np.array(jm["idx"][0]).reshape(4, 4)
    beta = jdper.beta_schedule(jnp.int32(0), 0.4, 100_000)
    jt = p["jbuf"].trees
    total = jnp.maximum(jt.sum_tree[:, 1], 1e-30)
    q = jnp.take_along_axis(jt.sum_tree, 16 + idx, 1) / total[:, None] / 4
    want = (q / jnp.min(jt.min_tree[:, 1] / total / 4)) ** (-beta)
    got = shard_weights(tbuf.trees, torch.from_numpy(idx), 0.4, mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WEIGHTS)


def test_sharded_fused_chunk_per_two_ranks_matches_reference(rng):
    """Two gloo ranks, two shards each: rank r holds the reference's
    shards 2r and 2r + 1 (its rows fed in the order the round-robin lays
    them there); its slots are the reference's columns of those shards,
    bitwise, with one IS normalizer over all four."""
    p = _chunk_pair(rng)
    js = p["jbuf"].storage
    blocks = []
    for r in range(2):
        rows = {f: np.stack([np.asarray(getattr(js, f))[2 * r + i, :16]
                             for i in range(2)], axis=1).reshape(
                                 32, *np.asarray(getattr(js, f)).shape[2:])
                for f in JaxBatch._fields}
        blocks.append([rows])
    outs = spawn_local(torch_ranks.sharded_chunk, 2, args=(
        p["tcfg"], torch_ranks.pack_state(p["ts"]), 64, blocks, 3, 16,
        p["u"]), n_local=2)
    jm = p["jm"]
    for r, out in enumerate(outs):
        cols = slice(8 * r, 8 * (r + 1))
        for s in range(2):
            for j, t in zip(p["jbuf"].storage, out["storage"]):
                np.testing.assert_array_equal(t[s], np.asarray(j)[2 * r + s])
        np.testing.assert_array_equal(out["metrics"]["idx"],
                                      np.asarray(jm["idx"])[:, cols])
        np.testing.assert_allclose(out["metrics"]["critic_loss"],
                                   np.asarray(jm["critic_loss"]), **LOSS)
        np.testing.assert_allclose(out["metrics"]["td_error"],
                                   np.asarray(jm["td_error"])[:, cols], **TD)
        for j, t in zip(p["jtrees"], out["trees"]):
            np.testing.assert_allclose(
                t, np.asarray(j)[2 * r:2 * r + 2], **PARAMS)
        _assert_params(p["jnext"], out["params"])
        assert out["step"] == 3


def test_sharded_fused_priorities_written_per_shard(rng):
    """k = 1: each shard's leaves at its sampled local slots hold
    (|td| + eps) ** alpha; td rows [s * b_local, (s + 1) * b_local) are
    shard s's."""
    _, _, tcfg, ts = _states(1)
    _, tbuf = _pair_buffers(64, [[_rows(rng, 64)]])
    fn = make_sharded_fused_chunk(tcfg, RankMesh.local("cpu", 4), k=1,
                                  batch_size=16)
    trees, m = fn(ts, tbuf.trees, tbuf.storage, tbuf.size,
                  generator=torch.Generator().manual_seed(0))
    idx = m["idx"][0].numpy().reshape(4, 4)
    td = m["td_error"][0].numpy().reshape(4, 4)
    leaves = trees.sum_tree[:, tbuf.cap_shard:].numpy()
    expect = (np.abs(td) + 1e-6) ** 0.6
    for s in range(4):
        for slot in idx[s]:
            assert np.any(np.isclose(leaves[s, slot],
                                     expect[s][idx[s] == slot], rtol=1e-4))


def test_sharded_equal_priorities_weights_are_one(rng):
    """Every priority equal across the shards: the weights are exactly 1
    whatever beta, so the loss is the same at beta0 0.4 and 1.0."""
    _, _, tcfg, ts = _states(2)
    _, tbuf = _pair_buffers(32, [[_rows(rng, 32)]], dp=2)
    mesh = RankMesh.local("cpu", 2)
    w = shard_weights(tbuf.trees, torch.randint(0, 16, (2, 4)), 0.4, mesh)
    assert torch.equal(w, torch.ones(2, 4))
    loss = {}
    for b0 in (0.4, 1.0):
        st = torch_ranks.unpack_state(tcfg, torch_ranks.pack_state(ts))
        fn = make_sharded_fused_chunk(tcfg, mesh, k=1, batch_size=8,
                                      beta0=b0)
        _, m = fn(st, tbuf.trees, tbuf.storage, tbuf.size,
                  generator=torch.Generator().manual_seed(3))
        loss[b0] = m["critic_loss"][0].item()
    assert loss[0.4] == pytest.approx(loss[1.0], rel=1e-6)


def test_sharded_fused_uniform_chunk_matches_reference(rng):
    """Uniform replay: the reference's per-shard ``randint`` slots
    injected; slots in range and bitwise, losses at the bar."""
    jcfg, js, tcfg, ts = _states(3)
    jbuf, tbuf = _pair_buffers(64, [[_rows(rng, 64)]], prioritized=False)
    slots = reference_uniforms(js.key, 2, 4, 4, sizes=jbuf._size)
    jnext, jm = jax_chunk(jcfg, _jmesh(4), k=2, batch_size=16,
                          prioritized=False, donate=False)(
        js, jbuf.storage, jbuf.size)
    fn = make_sharded_fused_chunk(tcfg, RankMesh.local("cpu", 4), k=2,
                                  batch_size=16, prioritized=False)
    m = fn(ts, tbuf.storage, tbuf.size, slots=torch.from_numpy(slots))
    assert ts.step == 2
    idx = m["idx"].numpy()
    assert idx.min() >= 0 and idx.max() < tbuf.cap_shard
    np.testing.assert_array_equal(idx, np.asarray(jm["idx"]))
    np.testing.assert_allclose(m["critic_loss"].numpy(),
                               np.asarray(jm["critic_loss"]), **LOSS)
    _assert_params(jnext, torch_ranks.params(ts))


def test_sharded_drain_overflow_keeps_newest(rng):
    """A backlog past the capacity keeps the newest rows, bitwise the
    reference's."""
    jbuf, tbuf = _pair_buffers(16, [[_rows(rng, 11, 0), _rows(rng, 11, 11)]],
                               prioritized=False)
    assert tbuf._size.sum() == 16
    got = np.sort(np.concatenate([
        tbuf.storage.reward[s, :tbuf._size[s]].numpy() for s in range(4)]))
    np.testing.assert_array_equal(got, np.arange(6, 22))
    _assert_buffers_equal(jbuf, tbuf)


def test_sharded_state_dict_roundtrip(rng):
    """A shard-set round-trips into a fresh buffer of either package,
    bitwise (trees rebuilt level by level from the leaves)."""
    jbuf, src = _pair_buffers(64, [[_rows(rng, 40)]])
    d = src.state_dict()
    dst = ShardedFusedReplay(64, 4, 2, RankMesh.local("cpu", 4), alpha=0.6)
    dst.load_state_dict(d)
    _assert_buffers_equal(jbuf, dst)
    jdst = JaxSharded(64, 4, 2, _jmesh(4), alpha=0.6)
    jdst.load_state_dict(d)
    _assert_buffers_equal(jdst, src)


def test_sharded_checkpoint_rejected_by_flat_buffers(rng):
    _, src = _pair_buffers(64, [[_rows(rng, 20)]])
    d = src.state_dict()
    with pytest.raises(ValueError, match="sharded"):
        PrioritizedReplayBuffer(64, 4, 2, backend="numpy").load_state_dict(d)
    with pytest.raises(ValueError, match="sharded"):
        FusedDeviceReplay(64, 4, 2, device="cpu").load_state_dict(d)
    with pytest.raises(ValueError, match="data-parallel"):
        ShardedFusedReplay(64, 4, 2, RankMesh.local("cpu", 2)
                           ).load_state_dict(d)
    flat = FusedDeviceReplay(64, 4, 2, device="cpu").state_dict()
    with pytest.raises(ValueError, match="non-sharded"):
        ShardedFusedReplay(64, 4, 2, RankMesh.local("cpu", 4)
                           ).load_state_dict(flat)


def test_train_sharded_fused_end_to_end(tmp_path):
    """``train()`` with ``--data_parallel 4`` and device replay: four CPU
    ranks, each draining its actors into its shard of the fused data
    plane."""
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.train import train

    cfg = ExperimentConfig(
        env="point", max_steps=20, num_envs=2, warmup=100, n_epochs=1,
        n_cycles=2, episodes_per_cycle=1, train_steps_per_cycle=12,
        eval_trials=1, batch_size=16, memory_size=2000,
        log_dir=str(tmp_path), hidden=(16, 16), n_atoms=11,
        v_min=-5.0, v_max=0.0, replay_storage="device", fused_replay="on",
        data_parallel=4, updates_per_dispatch=8, platform="cpu")
    metrics = train(cfg)
    assert np.isfinite(metrics["critic_loss"])
