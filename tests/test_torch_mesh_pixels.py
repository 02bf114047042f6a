"""Port vs reference: the conv-encoder pixel recipe on the data axis.

The data-only case of the reference's ``tests/test_mesh_pixels.py``
(``test_pixel_mesh_chunk_matches_single_device_shapes``) on the port:
``--share_encoder --frame_stack 3 --augment shift`` resolved through
``ExperimentConfig`` with ``--data_parallel 2`` (``--projection auto``
resolving to einsum without timing, as the reference resolves it for a
mesh learner), uint8 pixel rows in a two-shard ``ShardedFusedReplay``,
and one sharded fused chunk beside the single-device fused chunk: the
same metric structure, finite, the encoders tied. The reference's two
``{data, model}`` cases wait for the model axis (ROADMAP Queue 1 item
16b).
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
from d4pg_tpu.replay.sharded_per import ShardedFusedReplay as JaxSharded
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.learner.fused import (make_fused_chunk,
                                          make_sharded_fused_chunk)
from d4pg_tpu_torch.learner.state import init_state
from d4pg_tpu_torch.parallel import RankMesh
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay

pytestmark = pytest.mark.torchport

SHAPE = (8, 8, 9)  # 8 px frames, frame_stack 3 -> 3 * 3 channels
ACT = 2
KW = dict(env="pixel-point", share_encoder=True, frame_stack=3,
          augment="shift", augment_pad=1, encoder_width=8, batch_size=16,
          n_atoms=11, v_min=-10.0, v_max=10.0, hidden=(16, 16),
          data_parallel=2)


def _pixel_rows(rng, n):
    return dict(
        obs=rng.integers(0, 255, (n, *SHAPE)).astype(np.uint8),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.integers(0, 255, (n, *SHAPE)).astype(np.uint8),
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
