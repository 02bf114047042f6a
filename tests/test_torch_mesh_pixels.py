"""Port vs reference: the conv-encoder pixel recipe on the data and
model axes.

The reference's three ``tests/test_mesh_pixels.py`` cases on the port:

  - the data-only case (``test_pixel_mesh_chunk_matches_single_device_
    shapes``): ``--share_encoder --frame_stack 3 --augment shift``
    resolved through ``ExperimentConfig`` with ``--data_parallel 2``
    (``--projection auto`` resolving to einsum without timing, as the
    reference resolves it for a mesh learner), uint8 pixel rows in a
    two-shard ``ShardedFusedReplay``, and one sharded fused chunk beside
    the single-device fused chunk: the same metric structure, finite,
    the encoders tied;
  - the ``{data 4, model 2}`` smoke as eight gloo CPU ranks
    (``tests/torch_ranks.py``): the encoder's convolutions split over
    the model axis, one sharded fused chunk, shapes, finite metrics, the
    encoders tied; the model ranks of one data row hold the same rows,
    draw the same slots and compute the same metrics;
  - the real-shape equivalence (84 x 84 x 9, K = 2, batch 8, a DrQ pad
    of 4) as four ranks of ``{data 2, model 2}``: parameters and metrics
    within the reference's ``EQUIV_RTOL`` / ``EQUIV_ATOL`` of the port's
    single-device update and of the reference's own sharded update on a
    ``(2, 2)`` virtual mesh, the reference's DrQ offsets injected into
    the port (``test_torch_families.reference_draws``), the encoders tied
    bitwise, the four ranks' gathered networks bitwise equal.
"""

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from d4pg_tpu.config import ExperimentConfig as JaxExperimentConfig
from d4pg_tpu.learner import init_state as jax_init_state
from d4pg_tpu.learner.fused import make_sharded_fused_chunk as jax_chunk
from d4pg_tpu.parallel import MeshSpec as JaxMeshSpec
from d4pg_tpu.parallel import make_mesh
from d4pg_tpu.parallel import make_sharded_multi_update as jax_multi
from d4pg_tpu.parallel.data_parallel import replicate_state as jax_replicate
from d4pg_tpu.parallel.data_parallel import shard_stacked as jax_stacked
from d4pg_tpu.replay.sharded_per import ShardedFusedReplay as JaxSharded
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner.fused import (make_fused_chunk,
                                          make_sharded_fused_chunk)
from d4pg_tpu_torch.learner.state import init_state
from d4pg_tpu_torch.learner.update import multi_update_step
from d4pg_tpu_torch.parallel import RankMesh, spawn_local
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay
from test_torch_families import reference_draws

pytestmark = pytest.mark.torchport

SHAPE = (8, 8, 9)  # 8 px frames, frame_stack 3 -> 3 * 3 channels
REAL_SHAPE = (84, 84, 9)  # the DrQ/D4PG pixel convention at frame_stack 3
ACT = 2
# the reference's declared bars for mesh against single device
# (``tests/test_mesh_pixels.py:48-49``)
EQUIV_RTOL = 5e-4
EQUIV_ATOL = 1e-6
KW = dict(env="pixel-point", share_encoder=True, frame_stack=3,
          augment="shift", augment_pad=1, encoder_width=8, batch_size=16,
          n_atoms=11, v_min=-10.0, v_max=10.0, hidden=(16, 16),
          data_parallel=2)


def _pixel_rows(rng, n, shape=SHAPE):
    return dict(
        obs=rng.integers(0, 255, (n, *shape)).astype(np.uint8),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.integers(0, 255, (n, *shape)).astype(np.uint8),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32),
    )


def _encoders_tied(state) -> bool:
    a = state.actor.encoder.state_dict()
    c = state.critic.encoder.state_dict()
    return all(torch.equal(a[k], c[k]) for k in a)


def test_pixel_mesh_chunk_matches_single_device_shapes(rng):
    config = ExperimentConfig(**KW).learner_config(SHAPE, ACT, device="cpu")
    assert config.pixels and config.share_encoder
    assert config.augment == "shift"
    assert config.projection == "einsum"
    rows = _pixel_rows(rng, 32)
    buf_m = ShardedFusedReplay(32, SHAPE, ACT, RankMesh.local("cpu", 2),
                               alpha=0.6, obs_dtype=np.uint8)
    buf_s = FusedDeviceReplay(32, SHAPE, ACT, alpha=0.6, device="cpu",
                              obs_dtype=np.uint8, block_rows=16)
    for b in (buf_m, buf_s):
        b.add(torch_ranks.batch_of(rows))
        b.drain()
    assert buf_m.storage.obs.dtype == torch.uint8  # packed pixels
    fn_m = make_sharded_fused_chunk(config, RankMesh.local("cpu", 2), k=2,
                                    batch_size=16)
    fn_s = make_fused_chunk(config, k=2, batch_size=16)
    st_m, st_s = init_state(config, 0, "cpu"), init_state(config, 0, "cpu")
    _, m_m = fn_m(st_m, buf_m.trees, buf_m.storage, buf_m.size,
                  generator=torch.Generator().manual_seed(0))
    _, m_s = fn_s(st_s, buf_s.trees, buf_s.storage, buf_s.size,
                  generator=torch.Generator().manual_seed(0))
    assert m_m["td_error"].shape == m_s["td_error"].shape == (2, 16)
    assert st_m.step == st_s.step == 2
    for m in (m_m, m_s):
        for name in ("critic_loss", "actor_loss", "q_mean"):
            assert torch.isfinite(m[name]).all(), name
    assert _encoders_tied(st_m)
    # and the reference's data-only mesh chunk has the same structure
    jcfg = JaxExperimentConfig(**KW).learner_config(SHAPE, ACT)
    assert jcfg.projection == config.projection
    mesh = make_mesh(JaxMeshSpec(data_parallel=2), devices=jax.devices()[:2])
    jbuf = JaxSharded(32, SHAPE, ACT, mesh, alpha=0.6, obs_dtype=np.uint8)
    jbuf.add(JaxBatch(**rows))
    jbuf.drain()
    for j, t in zip(jbuf.storage, buf_m.storage):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    _, _, jm = jax_chunk(jcfg, mesh, k=2, batch_size=16, alpha=0.6,
                         donate=False)(jax_init_state(jcfg, jax.random.key(0)),
                                       jbuf.trees, jbuf.storage, jbuf.size)
    assert {k: tuple(v.shape) for k, v in m_m.items()} == {
        k: tuple(np.asarray(v).shape) for k, v in jm.items()}


def test_pixel_share_encoder_fused_chunk_on_data_model_mesh(rng):
    """The ``{data 4, model 2}`` smoke: eight ranks, rank r at
    ``(r // 2, r % 2)``; each conv slice holds 4 of the 8 channels."""
    config = ExperimentConfig(**{**KW, "data_parallel": 4}).learner_config(
        SHAPE, ACT, device="cpu")
    assert config.pixels and config.share_encoder
    assert config.augment == "shift" and config.projection == "einsum"
    payload = torch_ranks.pack_state(init_state(config, 0, "cpu"))
    blocks = [[_pixel_rows(rng, 16)] for _ in range(4)]  # one per data row
    outs = spawn_local(torch_ranks.model_axis_chunk, 8,
                       args=(config, payload, blocks, 2, 16, 7),
                       model_parallel=2)
    for r, out in enumerate(outs):
        assert out["coords"] == (r // 2, r % 2)
        assert out["step"] == 2
        assert out["conv1_shape"] == (4, 9, 3, 3)
        m = out["metrics"]
        assert m["td_error"].shape == m["idx"].shape == (2, 4)  # its rows
        for name in ("critic_loss", "actor_loss", "q_mean", "td_error"):
            assert np.isfinite(m[name]).all(), name
        for n, a in out["actor_encoder"].items():
            np.testing.assert_array_equal(a, out["critic_encoder"][n])
    for d in range(4):
        a, b = outs[2 * d], outs[2 * d + 1]
        np.testing.assert_array_equal(a["storage_obs"], b["storage_obs"])
        for name in ("idx", "td_error", "critic_loss", "actor_loss"):
            np.testing.assert_array_equal(a["metrics"][name],
                                          b["metrics"][name])
        assert not np.array_equal(a["critic_encoder"]["conv1.weight"],
                                  b["critic_encoder"]["conv1.weight"])
    # the losses are averaged over the data axis: one value everywhere
    for out in outs[1:]:
        np.testing.assert_array_equal(out["metrics"]["critic_loss"],
                                      outs[0]["metrics"]["critic_loss"])


def test_real_shape_pixel_mesh_update_matches_single_device(rng):
    k, batch = 2, 8
    kw = {**KW, "augment_pad": 4, "batch_size": batch}
    config = ExperimentConfig(**kw).learner_config(REAL_SHAPE, ACT,
                                                   device="cpu")
    jcfg = JaxExperimentConfig(**kw).learner_config(REAL_SHAPE, ACT)
    assert config.projection == jcfg.projection == "einsum"
    js = jax_init_state(jcfg, jax.random.key(0))
    ts = state_from_jax(config, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    payload = torch_ranks.pack_state(ts)
    flat = _pixel_rows(rng, k * batch, REAL_SHAPE)
    fields = {f: v.reshape(k, batch, *v.shape[1:]) for f, v in flat.items()}
    w = np.ones((k, batch), np.float32)
    draws, _ = reference_draws(jcfg, js.key, k, batch)

    single = torch_ranks.unpack_state(config, payload)
    m_single = multi_update_step(config, single, torch_ranks.batch_of(fields),
                                 torch.from_numpy(w), draws)
    outs = spawn_local(
        torch_ranks.model_axis_update, 4,
        args=(config, payload, fields, w,
              {n: None if v is None else v.numpy()
               for n, v in draws._asdict().items()}),
        model_parallel=2)

    mesh = make_mesh(JaxMeshSpec(data_parallel=2, model_parallel=2),
                     devices=jax.devices()[:4])
    s_ref, m_ref = jax_multi(jcfg, mesh, donate=False)(
        jax_replicate(js, mesh), jax_stacked(JaxBatch(**fields), mesh),
        jax_stacked(w, mesh))
    want = torch_ranks.params(single)
    ref = {m: torch_layout(jax.device_get(getattr(s_ref, f))["params"])
           for f, m in (("actor_params", "actor"),
                        ("critic_params", "critic"),
                        ("target_actor_params", "target_actor"),
                        ("target_critic_params", "target_critic"))}
    for r, out in enumerate(outs):
        assert out["coords"] == (r // 2, r % 2) and out["step"] == k
        assert out["local_conv1"] == (4, 9, 3, 3)
        for m, ps in out["params"].items():
            assert set(ps) == set(want[m])
            for n, a in ps.items():
                np.testing.assert_allclose(a, want[m][n], rtol=EQUIV_RTOL,
                                           atol=EQUIV_ATOL,
                                           err_msg=f"{m}.{n} vs single")
                np.testing.assert_allclose(a, ref[m][n], rtol=EQUIV_RTOL,
                                           atol=EQUIV_ATOL,
                                           err_msg=f"{m}.{n} vs reference")
                np.testing.assert_array_equal(a, outs[0]["params"][m][n])
        enc = {n[len("encoder."):]: a for n, a in out["params"]["actor"].items()
               if n.startswith("encoder.")}
        for n, a in enc.items():
            np.testing.assert_array_equal(
                a, out["params"]["critic"][f"encoder.{n}"])
        for n, a in out["actor_encoder"].items():
            np.testing.assert_array_equal(a, out["critic_encoder"][n])
        for name in ("critic_loss", "actor_loss", "q_mean"):
            np.testing.assert_allclose(out["metrics"][name],
                                       m_single[name].numpy(),
                                       rtol=EQUIV_RTOL, atol=EQUIV_ATOL,
                                       err_msg=name)
            np.testing.assert_allclose(out["metrics"][name],
                                       np.asarray(m_ref[name]),
                                       rtol=EQUIV_RTOL, atol=EQUIV_ATOL,
                                       err_msg=f"{name} vs reference")
    # td: this rank's rows; the data rows (model index 0) in order
    td = np.concatenate([outs[0]["metrics"]["td_error"],
                         outs[2]["metrics"]["td_error"]], axis=1)
    np.testing.assert_allclose(td, m_single["td_error"].numpy(),
                               rtol=EQUIV_RTOL, atol=EQUIV_ATOL)
    np.testing.assert_allclose(td, np.asarray(m_ref["td_error"]),
                               rtol=EQUIV_RTOL, atol=EQUIV_ATOL)
