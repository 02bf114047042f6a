"""Port vs reference: the data-parallel learner over the rank mesh.

The reference's seven ``tests/test_parallel.py`` cases on the port. The
port's side runs in two ``spawn``ed gloo CPU ranks (never a process group
in the test process); the reference's on a 2-device slice of the virtual
CPU mesh the conftest gives. Both start from the same weights (the JAX
state carried across with ``state_from_jax``) and take the same global
batch; the reference's bars hold (``tests/test_parallel.py``): losses
rtol 1e-5, ``td_error`` rtol 1e-4 / atol 1e-5, parameters rtol 1e-4 /
atol 1e-6. The summation order of the averaged gradient differs from
XLA's, so nothing here is bitwise but the replicas against each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from d4pg_tpu.learner import D4PGConfig as JaxConfig
from d4pg_tpu.learner import init_state as jax_init_state
from d4pg_tpu.parallel import MeshSpec as JaxMeshSpec
from d4pg_tpu.parallel import make_mesh
from d4pg_tpu.parallel import make_sharded_multi_update as jax_multi
from d4pg_tpu.parallel import make_sharded_update as jax_sharded
from d4pg_tpu.parallel import replicate_state as jax_replicate
from d4pg_tpu.parallel import shard_batch as jax_shard_batch
from d4pg_tpu.parallel import shard_stacked as jax_shard_stacked
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.parallel import (
    MeshSpec,
    RankMesh,
    global_mesh,
    make_sharded_multi_update,
    make_sharded_update,
    spawn_local,
)

pytestmark = pytest.mark.torchport

OBS, ACT, B = 4, 2, 64
LOSS = dict(rtol=1e-5)
TD = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-6)
KW = dict(obs_dim=OBS, act_dim=ACT, v_min=-5.0, v_max=5.0, n_atoms=11,
          hidden=(32, 32, 32), projection="einsum")


def _batch(rng, lead=(B,)):
    done = (rng.random(lead) < 0.2).astype(np.float32)
    return dict(
        obs=rng.standard_normal((*lead, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (*lead, ACT)).astype(np.float32),
        reward=rng.standard_normal(lead).astype(np.float32),
        next_obs=rng.standard_normal((*lead, OBS)).astype(np.float32),
        done=done,
        discount=(0.99 * (1.0 - done)).astype(np.float32),
    )


def _pair(seed):
    jcfg, tcfg = JaxConfig(**KW), D4PGConfig(**KW)
    js = jax_init_state(jcfg, jax.random.key(seed))
    ts = state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    return jcfg, js, tcfg, torch_ranks.pack_state(ts)


def _mesh2():
    return make_mesh(JaxMeshSpec(data_parallel=2), devices=jax.devices()[:2])


def _assert_params(jstate, got):
    for field, module in (("critic_params", "critic"),
                          ("actor_params", "actor"),
                          ("target_critic_params", "target_critic")):
        want = torch_layout(jax.device_get(getattr(jstate, field))["params"])
        assert set(want) == set(got[module])
        for name, arr in want.items():
            np.testing.assert_allclose(got[module][name], arr, **PARAMS,
                                       err_msg=f"{module}.{name}")


def test_mesh_geometry():
    assert MeshSpec().resolve(8) == (8, 1)
    assert MeshSpec(data_parallel=4, model_parallel=2).resolve(8) == (4, 2)
    with pytest.raises(ValueError):
        MeshSpec(data_parallel=3).resolve(8)
    # no process group: the world-1 mesh, which may hold several shards
    mesh = global_mesh("cpu", n_local=4)
    assert (mesh.world, mesh.n_shards, mesh.local_start) == (1, 4, 0)
    assert mesh.backend is None and mesh == RankMesh.local("cpu", 4)
    with pytest.raises(NotImplementedError, match="item 16b"):
        global_mesh("cpu", model_parallel=2)


def test_batch_sharded_state_replicated(rng):
    """Each rank takes its half of the global batch; ranks seeded apart
    end with rank 0's networks, Adam state, step and generator."""
    fields = _batch(rng)
    outs = spawn_local(torch_ranks.replicate_and_shard, 2,
                       args=(D4PGConfig(**KW), fields))
    for r, out in enumerate(outs):
        assert (out["world"], out["backend"]) == (2, "gloo")
        np.testing.assert_array_equal(
            out["obs"], fields["obs"][r * B // 2:(r + 1) * B // 2])
        assert out["step"] == 7
        assert out["adam"] == outs[0]["adam"] and outs[0]["adam"][0] != 0
        np.testing.assert_array_equal(out["generator"],
                                      outs[0]["generator"])
        for m, ps in out["params"].items():
            for n, a in ps.items():
                np.testing.assert_array_equal(a, outs[0]["params"][m][n])


def test_sharded_update_matches_reference_sharded_update(rng):
    fields = _batch(rng)
    w = rng.uniform(0.2, 1.0, B).astype(np.float32)
    jcfg, js, tcfg, payload = _pair(42)
    mesh = _mesh2()
    jnext, jm = jax_sharded(jcfg, mesh, donate=False)(
        jax_replicate(js, mesh), jax_shard_batch(JaxBatch(**fields), mesh),
        jax_shard_batch(jnp.asarray(w), mesh))
    outs = spawn_local(torch_ranks.sharded_update, 2,
                       args=(tcfg, payload, fields, w, 1))
    for out in outs:
        m = out["metrics"][0]
        np.testing.assert_allclose(m["critic_loss"],
                                   float(jm["critic_loss"]), **LOSS)
        _assert_params(jnext, out["params"])
    td = np.concatenate([o["metrics"][0]["td_error"] for o in outs])
    np.testing.assert_allclose(td, np.asarray(jm["td_error"]), **TD)


def test_sharded_update_multi_step_stability(rng):
    """Three unweighted sharded steps: finite, step 3, replicas bitwise."""
    fields = _batch(rng)
    _, _, tcfg, payload = _pair(1)
    outs = spawn_local(torch_ranks.sharded_update, 2,
                       args=(tcfg, payload, fields, None, 3))
    for out in outs:
        assert out["step"] == 3
        assert np.isfinite(out["metrics"][-1]["critic_loss"])
        for m, ps in out["params"].items():
            for n, a in ps.items():
                np.testing.assert_array_equal(a, outs[0]["params"][m][n])
        assert out["metrics"][-1]["critic_loss"] == \
            outs[0]["metrics"][-1]["critic_loss"]


def test_sharded_multi_update_matches_reference(rng):
    """The K-step sharded update (K = 4, each step's batch split over two
    ranks) against the reference's ``make_sharded_multi_update`` on two
    devices, and against K sequential reference sharded updates."""
    K = 4
    fields = _batch(rng, (K, B))
    w = np.ones((K, B), np.float32)
    jcfg, js, tcfg, payload = _pair(7)
    mesh = _mesh2()
    stacked = JaxBatch(**fields)
    jnext, jm = jax_multi(jcfg, mesh, donate=False)(
        jax_replicate(js, mesh), jax_shard_stacked(stacked, mesh),
        jax_shard_stacked(jnp.asarray(w), mesh))
    outs = spawn_local(torch_ranks.sharded_multi_update, 2,
                       args=(tcfg, payload, fields, w))
    for out in outs:
        assert out["step"] == K
        np.testing.assert_allclose(out["metrics"]["critic_loss"],
                                   np.asarray(jm["critic_loss"]), **LOSS)
        _assert_params(jnext, out["params"])
    td = np.concatenate([o["metrics"]["td_error"] for o in outs], axis=1)
    np.testing.assert_allclose(td, np.asarray(jm["td_error"]), **TD)


def test_train_mesh_with_updates_per_dispatch(tmp_path):
    """``train()`` on two CPU ranks with K = 2 chunks: the default storage
    on the CPU is host RAM, so each rank samples its own replay through
    ``ChunkPipeline`` and the sharded multi-step update."""
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.train import train

    cfg = ExperimentConfig(
        env="point", max_steps=20, num_envs=2, warmup=100, n_epochs=1,
        n_cycles=2, episodes_per_cycle=1, train_steps_per_cycle=5,
        eval_trials=1, batch_size=16, memory_size=2000,
        log_dir=str(tmp_path), hidden=(16, 16), n_atoms=11,
        v_min=-5.0, v_max=0.0, data_parallel=2, updates_per_dispatch=2,
        platform="cpu")
    metrics = train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    assert "avg_test_reward" in metrics


def test_sharded_factories_reject_kernel_projections(tmp_path):
    """The kernel arms keep the reference's refusal on a mesh, with the
    rule table in the message: the factories and the driver."""
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.train import train

    for arm in ("pallas", "pallas_ce"):
        config = D4PGConfig(obs_dim=3, act_dim=1, n_atoms=11, hidden=(8,),
                            projection=arm)
        for factory in (make_sharded_update, make_sharded_multi_update):
            with pytest.raises(ValueError, match=arm) as err:
                factory(config, RankMesh.local("cpu"))
            assert "encoder/conv" in str(err.value)
    with pytest.raises(ValueError, match="pallas") as err:
        train(ExperimentConfig(env="point", data_parallel=2,
                               projection="pallas", platform="cpu",
                               log_dir=str(tmp_path)))
    assert "Resolved partition rules" in str(err.value)
