"""Port vs reference: the pixel path's modules.

The conv encoder, the pixel actor and critic (float32 forwards at atol
1e-5 / rtol 1e-5, at 16x16 and 84x84 frames with 8-channel convs, which
take both of ``SAME``'s pad cases, from perturbed, non-symmetric weights
carried across with ``io.from_jax``), the DrQ shift with the reference's
own offsets (bitwise on uint8), the encoder tie, ``PixelPointEnv`` and
``FrameStack`` (the reference's frames for one seed), uint8 rows through
the replay layers and the acting lane, and the reference's own pixel
tests (``tests/test_pixels.py``, ``tests/test_models.py::
test_pixel_models``) re-asserted on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.envs.fake import PixelPointEnv as JaxPixelPoint
from d4pg_tpu.envs.wrappers import FrameStack as JaxFrameStack
from d4pg_tpu.learner import state as jstate
from d4pg_tpu.models import encoder as jenc
from d4pg_tpu.ops.augment import random_shift as jax_random_shift
from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.core.distribution import categorical_projection
from d4pg_tpu_torch.core.losses import (
    cross_entropy_per_sample,
    expected_q,
    weighted_mean,
)
from d4pg_tpu_torch.core.updates import soft_update, tie_shared
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.envs.fake import PixelPointEnv
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.envs.wrappers import FrameStack
from d4pg_tpu_torch.io.from_jax import load_params, state_from_jax, torch_layout
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.learner.update import multi_update_step, update_step
from d4pg_tpu_torch.models import encoder as tenc
from d4pg_tpu_torch.models.layers import same_padding
from d4pg_tpu_torch.ops.augment import random_shift
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.nstep import NStepFolder
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch
from d4pg_tpu_torch.serving.client import ActorConfig, LocalPolicyClient
from d4pg_tpu_torch.serving.lane import VectorActorLane

pytestmark = pytest.mark.torchport

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (16, 16, 3)
CH8 = (8, 8, 8, 8)


def _perturbed(variables, seed):
    """Flax variables with every leaf moved by N(0, 0.05): nonzero biases,
    a LayerNorm scale off 1, no symmetry a wrong layout could hide in."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)), variables)


def _frames(rng, n, shape):
    return rng.integers(0, 256, (n, *shape), dtype=np.uint8)


def reference_offsets(key, b, pad):
    """The offsets the reference's ``random_shift`` draws for a batch of
    ``b`` under ``key`` (one ``fold_in`` per sample)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(b))
    return np.array(jax.vmap(
        lambda k: jax.random.randint(k, (2,), 0, 2 * pad + 1))(keys))


@pytest.mark.parametrize("size,stride,pads", [
    (84, 2, (0, 1)), (16, 2, (0, 1)), (42, 1, (1, 1)), (8, 1, (1, 1)),
    (15, 2, (1, 1))])
def test_same_padding_is_xla_same(size, stride, pads):
    assert same_padding(size, stride, 3) == pads


@pytest.mark.parametrize("shape", [(16, 16, 3), (84, 84, 9)])
def test_encoder_actor_critic_forwards_match_reference(rng, shape):
    obs = _frames(rng, 4, shape)
    act = rng.uniform(-1, 1, (4, 6)).astype(np.float32)
    key = jax.random.key(1)
    jobs, jact = jnp.asarray(obs), jnp.asarray(act)

    enc = jenc.PixelEncoder(channels=CH8)
    params = _perturbed(enc.init(key, jobs), 0)
    tmod = tenc.PixelEncoder(shape, channels=CH8)
    load_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(enc.apply(params, jobs)),
                               **TOL)
    h = -(-shape[0] // 2)
    assert tmod.proj.weight.shape == (50, h * h * 8)

    actor = jenc.PixelActor(6, channels=CH8, hidden=(32, 32))
    params = _perturbed(actor.init(key, jobs), 1)
    tactor = tenc.PixelActor(shape, 6, channels=CH8, hidden=(32, 32))
    load_params(tactor, params)
    with torch.no_grad():
        got = tactor(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(actor.apply(params, jobs)),
                               **TOL)

    critic = jenc.PixelCategoricalCritic(11, channels=CH8, hidden=(32, 32))
    params = _perturbed(critic.init(key, jobs, jact), 2)
    tcritic = tenc.PixelCategoricalCritic(shape, 6, 11, channels=CH8,
                                          hidden=(32, 32))
    load_params(tcritic, params)
    with torch.no_grad():
        logits = tcritic(torch.from_numpy(obs), torch.from_numpy(act),
                         return_logits=True).numpy()
        probs = tcritic(torch.from_numpy(obs), torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(critic.apply(params, jobs, jact, True)), **TOL)
    np.testing.assert_allclose(
        probs, np.asarray(critic.apply(params, jobs, jact)), **TOL)


def test_from_jax_carries_the_pixel_trees():
    """Conv kernels HWIO -> OIHW, LayerNorm scale -> weight, the
    ``encoder.``/``actor.``/``critic.`` prefixes, the critic torso
    flattened, and the Adam moments in the same layout."""
    kw = dict(obs_dim=int(np.prod(SHAPE)), act_dim=2, n_atoms=11,
              hidden=(32, 32), pixels=True, obs_shape=SHAPE,
              encoder_channels=CH8)
    js = jstate.init_state(jstate.D4PGConfig(**kw), jax.random.key(0))
    trees = jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key)))
    ts = state_from_jax(D4PGConfig(**kw), trees, "cpu")
    kernel = trees.critic_params["params"]["encoder"]["conv2"]["kernel"]
    assert kernel.shape == (3, 3, 8, 8)
    np.testing.assert_array_equal(ts.critic.encoder.conv2.weight.detach(),
                                  kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        ts.actor.encoder.ln.weight.detach(),
        trees.actor_params["params"]["encoder"]["ln"]["scale"])
    names = set(torch_layout(trees.critic_params["params"]))
    assert {"encoder.conv1.weight", "encoder.ln.bias", "critic.fc1.weight",
            "critic.head.bias"} <= names
    assert names == {n for n, _ in ts.critic.named_parameters()}


def test_random_shift_is_bitwise_the_reference(rng):
    """Edge-replicated pad then per-sample crop, with the offsets the
    reference drew: uint8 bitwise (and float32 frames too)."""
    key = jax.random.key(7)
    for shape, pad in (((16, 16, 9), 4), ((84, 84, 9), 4), ((10, 12, 3), 2)):
        imgs = _frames(rng, 6, shape)
        want = np.asarray(jax_random_shift(key, jnp.asarray(imgs), pad))
        off = torch.from_numpy(reference_offsets(key, 6, pad))
        got = random_shift(torch.from_numpy(imgs), pad, offsets=off)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        floats = imgs.astype(np.float32)
        np.testing.assert_array_equal(
            random_shift(torch.from_numpy(floats), pad, offsets=off).numpy(),
            np.asarray(jax_random_shift(key, jnp.asarray(floats), pad)))


def test_random_shift_draws_and_refuses(rng):
    imgs = torch.from_numpy(_frames(rng, 5, SHAPE))
    a = random_shift(imgs, 4, torch.Generator().manual_seed(3))
    b = random_shift(imgs, 4, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == imgs.shape
    assert random_shift(imgs, 0) is imgs
    with pytest.raises(ValueError, match="B, H, W, C"):
        random_shift(imgs[0], 4, torch.Generator())
    with pytest.raises(ValueError, match="generator"):
        random_shift(imgs, 4)
    with pytest.raises(ValueError, match="offsets"):
        random_shift(imgs, 4, offsets=torch.zeros(4, 2, dtype=torch.long))
    # offset (pad, pad) is the identity crop
    same = random_shift(imgs, 4, offsets=torch.full((5, 2), 4))
    assert torch.equal(same, imgs)


@pytest.mark.parametrize("shares", ["encoder", "convs"])
def test_tie_encoder_copies_never_aliases(shares):
    """The tie copies the shared part (every encoder leaf, or the
    convolutions alone) and never aliases it; the rest stays the
    actor's own."""
    cfg = D4PGConfig(obs_dim=int(np.prod(SHAPE)), act_dim=2, n_atoms=11,
                     hidden=(16, 16), pixels=True, obs_shape=SHAPE,
                     encoder_channels=CH8)
    ts = init_state(cfg, 0, "cpu")
    assert not torch.equal(ts.actor.encoder.conv1.weight,
                           ts.critic.encoder.conv1.weight)
    own = {n: p.clone() for n, p in ts.actor.named_parameters()}
    tie_shared(ts.actor, ts.critic, shares)
    for (name, a), c in zip(ts.actor.encoder.named_parameters(),
                            ts.critic.encoder.parameters()):
        if shares == "encoder" or name.startswith("conv"):
            assert torch.equal(a, c) and a.data_ptr() != c.data_ptr()
        else:
            assert torch.equal(a, own["encoder." + name]), name
    if shares == "convs":
        assert not torch.equal(ts.actor.encoder.proj.weight,
                               ts.critic.encoder.proj.weight)
    tie_shared(ts.actor, ts.critic, shares)
    assert torch.equal(ts.actor.actor.out.weight, own["actor.out.weight"])


@pytest.mark.parametrize("stack", [1, 3])
def test_pixel_point_and_frame_stack_give_the_reference_frames(rng, stack):
    def make(side):
        env = (PixelPointEnv if side == "port" else JaxPixelPoint)(
            horizon=12, seed=4)
        if stack > 1:
            env = (FrameStack if side == "port" else JaxFrameStack)(env,
                                                                     stack)
        return env

    port, ref = make("port"), make("reference")
    assert port.observation_space.shape == ref.observation_space.shape
    np.testing.assert_array_equal(port.observation_space.high,
                                  ref.observation_space.high)
    actions = rng.uniform(-1.5, 1.5, (15, 2)).astype(np.float32)
    for seed in (None, 11):
        po, _ = port.reset(seed=seed)
        ro, _ = ref.reset(seed=seed)
        np.testing.assert_array_equal(po, ro)
        assert po.dtype == np.uint8 and po.shape == (16, 16, 3 * stack)
        for a in actions:
            p, r = port.step(a), ref.step(a)
            np.testing.assert_array_equal(p[0], r[0])
            assert p[1:4] == r[1:4]
            if p[3]:
                break
    port.close(), ref.close()


def test_frame_stack_refuses_vector_envs():
    from d4pg_tpu_torch.envs.fake import PointMassEnv

    with pytest.raises(ValueError, match="H, W, C"):
        FrameStack(PointMassEnv(), 3)
    with pytest.raises(ValueError, match=">= 1"):
        FrameStack(PixelPointEnv(), 0)


@pytest.mark.parametrize("storage", ["host", "device"])
def test_uint8_rows_through_the_replay_layers(rng, storage):
    """[H, W, C] uint8 rows land and come back bitwise through the host
    and device rings, the PER buffer and the fused buffer's staging, pinned
    block and ring."""
    n = 40
    rows = TransitionBatch(
        obs=_frames(rng, n, SHAPE),
        action=rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=_frames(rng, n, SHAPE),
        done=np.zeros(n, np.float32), discount=np.full(n, 0.99, np.float32))
    for buf in (ReplayBuffer(64, SHAPE, 2, storage=storage, device="cpu"),
                PrioritizedReplayBuffer(64, SHAPE, 2, storage=storage,
                                        device="cpu", backend="numpy")):
        buf.add(rows)
        got = buf.gather(np.arange(n))
        assert np.asarray(got.obs).dtype == np.uint8
        np.testing.assert_array_equal(np.asarray(got.obs), rows.obs)
        np.testing.assert_array_equal(np.asarray(got.next_obs),
                                      rows.next_obs)
        assert np.asarray(buf.sample(4)[0].obs if isinstance(
            buf, PrioritizedReplayBuffer) else buf.sample(4).obs).shape == (
                4, *SHAPE)
    fused = FusedDeviceReplay(64, SHAPE, 2, device="cpu", block_rows=16)
    fused.add(rows)
    fused.drain()
    assert fused.storage.obs.dtype == torch.uint8
    np.testing.assert_array_equal(fused.storage.obs[:n].numpy(), rows.obs)
    floats = ReplayBuffer(8, SHAPE, 2, obs_dtype=np.float32)
    assert floats.gather(np.arange(1)).obs.dtype == np.float32


def test_pixel_lane_keeps_uint8_frames():
    """The policy client hands the encoder the frames in their own dtype
    (uint8), as the reference's ``jnp.asarray`` does; the folded rows the
    lane sends are uint8 [H, W, 9]."""
    cfg = D4PGConfig(obs_dim=16 * 16 * 9, act_dim=2, n_atoms=11,
                     hidden=(16, 16), pixels=True, obs_shape=(16, 16, 9),
                     encoder_channels=CH8)
    weights = WeightStore()
    weights.publish(init_state(cfg, 0, "cpu").actor, step=0)
    client = LocalPolicyClient(cfg, ActorConfig(), weights, seed=0)
    seen = []
    encoder = client._actor.encoder
    hook = encoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))
    pool = EnvPool([lambda i=i: FrameStack(PixelPointEnv(horizon=8, seed=i),
                                           3) for i in range(2)])

    class Sink:
        batches = []

        def add(self, batch, actor_id="local", **_):
            self.batches.append(batch)
            return True

    sink = Sink()
    lane = VectorActorLane("px", cfg, ActorConfig(n_step=2), pool, sink,
                           client, obs_dtype=np.uint8)
    lane.run(10)
    hook.remove()
    assert seen and set(seen) == {torch.uint8}
    assert client._obs(np.zeros((1, 16, 16, 9), np.uint8)).dtype == \
        torch.uint8
    rows = [b for b in sink.batches if len(b.obs)]
    assert rows and all(b.obs.dtype == np.uint8 and b.obs.shape[1:] ==
                        (16, 16, 9) for b in rows)


# --- the reference's own pixel tests, on the port ------------------------

def _px_config(**kw):
    return D4PGConfig(obs_dim=int(np.prod(SHAPE)), act_dim=2, v_min=-20.0,
                      v_max=0.0, n_atoms=11, hidden=(32, 32), pixels=True,
                      obs_shape=SHAPE, projection="einsum", **kw)


def _px_batch(rng, n=8, lead=()):
    return TransitionBatch(
        obs=torch.from_numpy(_frames(rng, int(np.prod(lead or (1,))) * n,
                                     SHAPE).reshape(*lead, n, *SHAPE)),
        action=torch.from_numpy(
            rng.uniform(-1, 1, (*lead, n, 2)).astype(np.float32)),
        reward=torch.from_numpy(
            rng.standard_normal((*lead, n)).astype(np.float32)),
        next_obs=torch.from_numpy(_frames(
            rng, int(np.prod(lead or (1,))) * n, SHAPE).reshape(
                *lead, n, *SHAPE)),
        done=torch.zeros((*lead, n)),
        discount=torch.full((*lead, n), 0.99))


def _encoders_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.encoder.parameters(),
                                                 b.encoder.parameters()))


def test_pixel_buffer_uint8_storage(rng):
    buf = ReplayBuffer(100, SHAPE, 2)
    n = 8
    batch = TransitionBatch(
        obs=_frames(rng, n, SHAPE),
        action=rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        reward=np.zeros(n, np.float32), next_obs=_frames(rng, n, SHAPE),
        done=np.zeros(n, np.float32), discount=np.full(n, 0.99, np.float32))
    buf.add(batch)
    out = buf.sample(4)
    assert out.obs.shape == (4, *SHAPE) and out.obs.dtype == np.uint8


def test_pixel_nstep_folder(rng):
    f = NStepFolder(2, 0.9, num_envs=1, obs_dim=SHAPE, act_dim=2)
    for _ in range(3):
        out = f.step(_frames(rng, 1, SHAPE),
                     rng.uniform(-1, 1, (1, 2)).astype(np.float32),
                     np.array([1.0]), _frames(rng, 1, SHAPE),
                     np.array([False]))
    assert out.obs.shape[0] == 1 and out.obs.dtype == np.uint8
    assert out.reward[0] == pytest.approx(1.0 + 0.9)


def test_pixel_learner_update(rng):
    config = _px_config()
    assert config.obs_spec == SHAPE
    state = init_state(config, 0, "cpu")
    metrics = update_step(config, state, _px_batch(rng))
    assert np.isfinite(float(metrics["critic_loss"]))
    assert state.step == 1


def test_pixel_models():
    """The reference's 84x84 pixel model shapes at full width."""
    gen = torch.Generator().manual_seed(0)
    px = torch.randint(0, 255, (2, 84, 84, 3), generator=gen,
                       dtype=torch.uint8)
    actor = tenc.PixelActor((84, 84, 3), act_dim=6, generator=gen)
    with torch.no_grad():
        a = actor(px)
        assert a.shape == (2, 6)
        critic = tenc.PixelCategoricalCritic((84, 84, 3), 6, n_atoms=51,
                                             generator=gen)
        z = critic(px, a)
    assert z.shape == (2, 51)
    np.testing.assert_allclose(z.sum(-1).numpy(), 1.0, rtol=1e-4)


def test_frame_stack_wrapper():
    """[H,W,C] -> [H,W,C*k], newest frame last, reset fills with k
    copies, uint8 preserved."""
    env = FrameStack(PixelPointEnv(horizon=10, seed=0), 3)
    assert env.observation_space.shape == (16, 16, 9)
    obs, _ = env.reset()
    assert obs.shape == (16, 16, 9) and obs.dtype == np.uint8
    np.testing.assert_array_equal(obs[..., :3], obs[..., 3:6])
    np.testing.assert_array_equal(obs[..., 3:6], obs[..., 6:9])
    prev = obs
    obs2, *_ = env.step(np.ones(2, np.float32))
    np.testing.assert_array_equal(obs2[..., :3], prev[..., 3:6])
    np.testing.assert_array_equal(obs2[..., 3:6], prev[..., 6:9])
    assert not np.array_equal(obs2[..., 6:9], prev[..., 6:9])
    env.close()


def test_frame_stack_train_smoke(tmp_path):
    """--frame_stack 3 flows through dims, replay and the encoder end to
    end on the host path."""
    from d4pg_tpu_torch.train import infer_dims, train

    cfg = ExperimentConfig(
        env="pixel-point", max_steps=10, num_envs=2, warmup=50, n_epochs=1,
        n_cycles=1, episodes_per_cycle=1, train_steps_per_cycle=2,
        eval_trials=1, batch_size=8, memory_size=500, log_dir=str(tmp_path),
        hidden=(16, 16), n_atoms=11, v_min=-5.0, v_max=0.0,
        encoder_width=8, frame_stack=3, platform="cpu")
    obs_dim, act_dim, obs_dtype = infer_dims(cfg)
    assert obs_dim == (16, 16, 9) and obs_dtype == np.uint8
    assert np.isfinite(train(cfg)["critic_loss"])


@pytest.mark.parametrize("storage", [
    dict(), dict(replay_storage="device", fused_replay="on")])
def test_pixel_train_end_to_end(tmp_path, storage):
    """The reference's host and fused pixel runs: uint8 frames through the
    ring, the gather and the conv encoder, PER from pixel TD errors."""
    from d4pg_tpu_torch.train import train

    cfg = ExperimentConfig(
        env="pixel-point", max_steps=10, num_envs=2, warmup=60, n_epochs=1,
        n_cycles=2, episodes_per_cycle=1, train_steps_per_cycle=4,
        eval_trials=1, batch_size=8, memory_size=500,
        log_dir=str(tmp_path), hidden=(16, 16), n_atoms=11,
        v_min=-20.0, v_max=0.0, n_steps=1, encoder_width=8,
        platform="cpu", **storage)
    assert np.isfinite(train(cfg)["critic_loss"])


def test_shared_encoder_tie_and_detached_policy(rng):
    """After every update the actor's encoder is bitwise the critic's
    (trained by the critic loss alone), the policy gradient never moves
    it (the actor Adam's moments for it stay exactly zero, and its step
    counter advances with the rest), and the actor MLP still trains."""
    config = _px_config(encoder_channels=CH8, share_encoder=True)
    state = init_state(config, 0, "cpu")
    enc0 = [p.clone() for p in state.critic.encoder.parameters()]
    mlp0 = [p.clone() for p in state.actor.actor.parameters()]
    batch = _px_batch(rng)
    for _ in range(2):
        metrics = update_step(config, state, batch)
    assert _encoders_equal(state.actor, state.critic)
    assert any(not torch.equal(a, b) for a, b in
               zip(enc0, state.critic.encoder.parameters()))
    assert any(not torch.equal(a, b) for a, b in
               zip(mlp0, state.actor.actor.parameters()))
    for p in state.actor.encoder.parameters():
        st = state.actor_opt.state[p]
        assert not st["exp_avg"].any() and float(st["step"]) == 2
    assert np.isfinite(float(metrics["actor_loss"]))


def test_shared_encoder_multi_update(rng):
    """K-step updates keep the tie, and the tied encoder is a copy, not an
    alias, of the critic's, online and target."""
    config = _px_config(encoder_channels=CH8, share_encoder=True)
    state = init_state(config, 0, "cpu")
    batches = _px_batch(rng, lead=(2,))
    for _ in range(2):
        metrics = multi_update_step(config, state, batches)
    assert torch.isfinite(metrics["critic_loss"]).all()
    for a, c in ((state.actor, state.critic),
                 (state.target_actor, state.target_critic)):
        assert _encoders_equal(a, c)
        assert all(x.data_ptr() != y.data_ptr() for x, y in zip(
            a.encoder.parameters(), c.encoder.parameters()))


def test_shared_encoder_tie_survives_warm_moments(rng):
    """Turning --share_encoder on over an unshared state leaves nonzero
    actor-Adam moments for the encoder; the tie is re-asserted after the
    Adam step, so online and target encoders are tied at once."""
    batch = _px_batch(rng)
    unshared = _px_config(encoder_channels=CH8)
    state = init_state(unshared, 0, "cpu")
    for _ in range(3):
        update_step(unshared, state, batch)
    assert any(state.actor_opt.state[p]["exp_avg"].any()
               for p in state.actor.encoder.parameters())
    shared = _px_config(encoder_channels=CH8, share_encoder=True)
    for _ in range(2):
        update_step(shared, state, batch)
        assert _encoders_equal(state.actor, state.critic)
        assert _encoders_equal(state.target_actor, state.target_critic)


def _five_forward_step(config, state, batch, w):
    """The shared-encoder update with every network on its own encoder:
    the target actor's and critic's on next_obs, the critic's on obs, then
    the actor's (its gradient stopped at the latent) and the stepped
    critic's on obs."""
    gen, pad = state.generator, config.augment_pad
    obs = random_shift(batch.obs, pad, gen)
    next_obs = random_shift(batch.next_obs, pad, gen)
    with torch.no_grad():
        target = state.target_critic(next_obs, state.target_actor(next_obs))
        proj = categorical_projection(config.support, target, batch.reward,
                                      batch.discount)
    td_error = cross_entropy_per_sample(proj, state.critic(obs, batch.action))
    critic_loss = weighted_mean(td_error, w)
    state.critic_opt.zero_grad(set_to_none=True)
    critic_loss.backward()
    state.critic_opt.step()
    tie_shared(state.actor, state.critic, "encoder")
    action = state.actor.actor(state.actor.encoder(obs).detach())
    actor_loss = -torch.mean(expected_q(config.support,
                                        state.critic(obs, action)))
    params = list(state.actor.parameters())
    grads = torch.autograd.grad(actor_loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    state.actor_opt.step()
    tie_shared(state.actor, state.critic, "encoder")
    soft_update(state.target_actor, state.actor, config.tau)
    soft_update(state.target_critic, state.critic, config.tau)
    tie_shared(state.target_actor, state.target_critic, "encoder")
    return {"critic_loss": critic_loss.detach(),
            "actor_loss": actor_loss.detach(), "td_error": td_error.detach()}


def test_shared_encoder_reuse_is_bitwise_five_forwards(rng):
    """With the encoders tied, ``update_step`` runs three encoder forwards
    a step (one on next_obs for both target heads, the critic's on obs,
    one on obs for the actor's head and the critic's) and counts two
    reused; every metric, all four networks and both Adam states stay
    bitwise what five forwards give."""
    config = _px_config(encoder_channels=CH8, share_encoder=True,
                        augment="shift", tau=0.05)
    reused, plain = init_state(config, 4, "cpu"), init_state(config, 4, "cpu")
    assert reused.targets_tied
    w = torch.from_numpy((0.5 + rng.random(8)).astype(np.float32))
    for _ in range(2):
        batch = _px_batch(rng)
        before = update_step.encoder_reused
        got = update_step(config, reused, batch, w)
        assert update_step.encoder_reused - before == 2
        want = _five_forward_step(config, plain, batch, w)
        for name in want:
            assert torch.equal(got[name], want[name]), name
        for net in ("actor", "critic", "target_actor", "target_critic"):
            for (name, a), b in zip(
                    getattr(reused, net).named_parameters(),
                    getattr(plain, net).parameters()):
                assert torch.equal(a, b), f"{net}.{name}"
        for opt, net in (("actor_opt", "actor"), ("critic_opt", "critic")):
            for a, b in zip(getattr(reused, net).parameters(),
                            getattr(plain, net).parameters()):
                sa = getattr(reused, opt).state[a]
                sb = getattr(plain, opt).state[b]
                assert set(sa) == set(sb)
                for key in sa:
                    assert torch.equal(sa[key], sb[key]), (opt, key)
        assert torch.equal(reused.generator.get_state(),
                           plain.generator.get_state())


def test_shared_encoder_requires_pixel_categorical():
    with pytest.raises(ValueError, match="share_encoder"):
        D4PGConfig(obs_dim=4, act_dim=2, share_encoder=True)
    with pytest.raises(ValueError, match="augment"):
        D4PGConfig(obs_dim=4, act_dim=2, augment="shift")
    with pytest.raises(ValueError, match="UNaugmented"):
        _px_config(augment="shift", augment_pad=0)
    with pytest.raises(ValueError, match="pixel encoder"):
        _px_config(critic_family="mog")


def test_shared_encoder_tied_from_init():
    config = _px_config(encoder_channels=CH8, share_encoder=True)
    state = init_state(config, 0, "cpu")
    assert _encoders_equal(state.actor, state.critic)
    assert _encoders_equal(state.target_actor, state.critic)
