"""CURL-D4PG on the port against the plain reference ``tests/plain_curl.py``.

At 20x20x3 frames cropped to 16 with 4-channel convolutions (maps of 7,
5, 3 and 1), on seeded weights moved off their initial draw (nonzero
biases, LayerNorm scales off 1): the crops, the unpadded encoder and the
actor's own trunk over tied convolutions, the InfoNCE loss and its
gradients, three whole update steps (every loss, leaf, target and the
four Adams' moments), the step's one conv map for the actor step and
the anchor against a step that runs the anchor's own forward (bitwise),
a ``FusedLoop.run`` chunk, the checkpoint, the training entry with the
CURL flags, the refusals, and wrong variants failing by more than the
tolerance.

Tolerances. ``FWD`` (rtol/atol 1e-5): the reference sums the same float32
products in its own order (its convolutions and GEMMs are the CPU
library's too, but the port's flatten and crop run other kernels), a few
ulps at these widths. ``STEP`` (rtol 1e-4, atol 1e-5) after three
steps: Adam divides each moment by the root of its second moment, so an
ulp of a small gradient moves its leaf by up to lr / 1e3 more; the
gradients themselves match at ``FWD``. The crops are uint8 gathers,
compared bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import plain_curl as plain
from d4pg_tpu_torch.config import ExperimentConfig, parse_args
from d4pg_tpu_torch.core.distribution import categorical_projection
from d4pg_tpu_torch.core.losses import (
    contrastive_loss,
    cross_entropy_per_sample,
    expected_q,
    weighted_mean,
)
from d4pg_tpu_torch.core.updates import soft_update, tie_shared
from d4pg_tpu_torch.envs.dmc import parse_dmc_id
from d4pg_tpu_torch.io.checkpoint import CheckpointManager
from d4pg_tpu_torch.io.from_jax import state_from_jax
from d4pg_tpu_torch.learner import update
from d4pg_tpu_torch.learner.fused import make_fused_chunk
from d4pg_tpu_torch.learner.mesh_replicas import MeshReplicaGroup
from d4pg_tpu_torch.learner.replica import LearnerReplica
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.learner.update import UpdateDraws, update_step
from d4pg_tpu_torch.ops.augment import center_crop, random_crop
from d4pg_tpu_torch.parallel.data_parallel import check_mesh_compatible
from d4pg_tpu_torch.parallel.model_axis import shard_state
from d4pg_tpu_torch.replay.uniform import TransitionBatch
from d4pg_tpu_torch import train as ttrain

pytestmark = pytest.mark.torchport

FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-5)
FRAME, CROP, B, ACT = (20, 20, 3), 16, 8, 2
CFG = D4PGConfig(obs_dim=int(np.prod(FRAME)), act_dim=ACT, v_min=0.0,
                 v_max=10.0, n_atoms=11, hidden=(16, 16), pixels=True,
                 obs_shape=FRAME, encoder_channels=(4, 4, 4, 4),
                 crop_size=CROP, contrastive="curl", projection="einsum",
                 tau=0.01, encoder_tau=0.05, lr_actor=1e-3, lr_critic=1e-3,
                 lr_encoder=1e-3)


def _plain_cfg(cfg: D4PGConfig) -> dict:
    keys = ("v_min", "v_max", "n_atoms", "tau", "encoder_tau", "lr_actor",
            "lr_critic", "lr_encoder", "adam_b1", "adam_b2", "crop_size")
    return {k: getattr(cfg, k) for k in keys}


@torch.no_grad()
def _state(cfg: D4PGConfig = CFG, seed: int = 0):
    """A CURL state whose every leaf is moved by N(0, 0.05), ties kept,
    targets equal to the online networks."""
    state = init_state(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 100)
    for module in (state.actor, state.critic):
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    state.curl.W.add_(0.05 * torch.randn(state.curl.W.shape, generator=g))
    for n, p in state.actor.encoder.named_parameters():
        if n.startswith("conv"):
            p.copy_(state.critic.encoder.get_parameter(n))
    state.target_actor.load_state_dict(state.actor.state_dict())
    state.target_critic.load_state_dict(state.critic.state_dict())
    return state


def _plain(state) -> plain.Learner:
    return plain.Learner(_plain_cfg(CFG), state.actor.state_dict(),
                         state.critic.state_dict(), state.curl.W.detach())


def _batch(seed: int = 1) -> TransitionBatch:
    g = torch.Generator().manual_seed(seed)
    return TransitionBatch(
        obs=torch.randint(0, 256, (B, *FRAME), generator=g,
                          dtype=torch.uint8),
        action=torch.rand(B, ACT, generator=g) * 2 - 1,
        reward=torch.rand(B, generator=g) * 3,
        next_obs=torch.randint(0, 256, (B, *FRAME), generator=g,
                               dtype=torch.uint8),
        done=torch.zeros(B),
        discount=torch.full((B,), 0.99 ** 3))


def _offsets(seed: int, steps: int = 1) -> torch.Tensor:
    """[steps, 3, B, 2] offsets of the obs, next_obs and pos crops."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, FRAME[0] - CROP + 1, (steps, 3, B, 2),
                         generator=g)


def _draws(off: torch.Tensor) -> UpdateDraws:
    return UpdateDraws(obs_crop=off[..., 0, :, :],
                       next_crop=off[..., 1, :, :],
                       pos_crop=off[..., 2, :, :])


def _close(got, want, tol, what):
    torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{what}: {m}")


def test_crops_are_bitwise_with_injected_offsets():
    frames = _batch().obs
    off = _offsets(3)[0, 0]
    assert torch.equal(random_crop(frames, CROP, offsets=off),
                       plain.random_crop(frames, CROP, off))
    assert torch.equal(center_crop(frames, CROP),
                       plain.center_crop(frames, CROP))
    assert torch.equal(center_crop(frames[0], CROP),
                       plain.center_crop(frames[0], CROP))
    g = torch.Generator().manual_seed(0)
    drawn = random_crop(frames.repeat(64, 1, 1, 1), CROP, g)
    assert drawn.dtype == torch.uint8 and drawn.shape == (64 * B, CROP,
                                                          CROP, 3)
    # every window can be drawn, and no other
    g = torch.Generator().manual_seed(0)
    off = torch.randint(0, FRAME[0] - CROP + 1, (64 * B, 2), generator=g)
    assert set(off.unique().tolist()) == set(range(FRAME[0] - CROP + 1))
    with pytest.raises(ValueError, match="does not fit"):
        random_crop(frames, FRAME[0] + 1, offsets=off[:B])


def test_unpadded_encoder_and_the_actors_trunk_over_tied_convs():
    state = _state()
    frames = _batch().obs
    crops = center_crop(frames, CROP)
    a, c = state.actor.state_dict(), state.critic.state_dict()
    # the convolutions are tied, the trunks are each network's own
    for k in a:
        if k.startswith("encoder.conv"):
            assert torch.equal(a[k], c[k]), k
        elif k.startswith("encoder."):
            assert not torch.equal(a[k], c[k]), k
    assert state.critic.encoder.conv_map(crops).shape == (B, 4)
    with torch.no_grad():
        _close(state.critic.encoder(crops), plain.encoder(c, "encoder.",
                                                          crops), FWD,
               "critic encoder")
        # the actor acts on the stored frames and center-crops them
        _close(state.actor(frames), plain.policy(a, crops), FWD, "actor")
        _close(state.actor(frames[0]), plain.policy(a, crops[:1])[0], FWD,
               "one frame")
        action = state.actor(frames)
        _close(state.critic(crops, action),
               plain.critic_probs(c, crops, action), FWD, "critic")
    # the update's actor loss reaches the actor's trunk, never the
    # convolutions: their Adam moments stay zero
    update_step(CFG, state, _batch(), draws=_draws(_offsets(4)[0]))
    for n, p in state.actor.encoder.named_parameters():
        moved = state.actor_opt.state[p]["exp_avg"].any()
        assert bool(moved) != n.startswith("conv"), n


def test_info_nce_and_its_gradients_into_w_and_the_encoder():
    state = _state()
    frames = _batch().obs
    anchor = random_crop(frames, CROP, offsets=_offsets(4)[0, 0])
    pos = random_crop(frames, CROP, offsets=_offsets(4)[0, 2])
    with torch.no_grad():
        z_pos = state.target_critic.encoder(pos)
    loss = contrastive_loss(state.curl.logits(state.critic.encoder(anchor),
                                              z_pos))
    loss.backward()
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in [("W", state.curl.W)] + [
                  ("encoder." + n, p)
                  for n, p in state.critic.encoder.named_parameters()]}
    want = plain.info_nce(plain.encoder(leaves, "encoder.", anchor),
                          plain.encoder(state.target_critic.state_dict(),
                                        "encoder.", pos), leaves["W"])
    want.backward()
    _close(loss.detach(), want.detach(), FWD, "loss")
    got = {"W": state.curl.W.grad, **{
        "encoder." + n: p.grad
        for n, p in state.critic.encoder.named_parameters()}}
    for k, v in leaves.items():
        _close(got[k], v.grad, FWD, k)


def _compare(state, ref, tol=STEP):
    nets = {"actor": state.actor, "critic": state.critic}
    for n, module in nets.items():
        for k, v in module.state_dict().items():
            _close(v, ref.p[n][k], tol, f"{n}/{k}")
        target = getattr(state, f"target_{n}").state_dict()
        for k, v in target.items():
            _close(v, ref.target[n][k], tol, f"target_{n}/{k}")
    _close(state.curl.W.detach(), ref.W["W"], tol, "W")
    opts = {"actor": (state.actor_opt, state.actor, ""),
            "critic": (state.critic_opt, state.critic, ""),
            "encoder": (state.encoder_opt, state.critic.encoder, "encoder."),
            "curl": (state.curl_opt, state.curl, "")}
    for n, (opt, module, prefix) in opts.items():
        for k, p in module.named_parameters():
            st = opt.state[p]
            _close(st["exp_avg"], ref.opt[n].m[prefix + k], tol,
                   f"{n} m {k}")
            _close(st["exp_avg_sq"], ref.opt[n].v[prefix + k], tol,
                   f"{n} v {k}")


def test_three_update_steps_match_the_reference():
    state = _state()
    ref = _plain(state)
    batch = _batch()
    off = _offsets(5, 3)
    for t in range(3):
        m = update_step(CFG, state, batch, draws=_draws(off[t]))
        losses, td = ref.step(batch.obs, batch.action, batch.reward,
                              batch.next_obs, batch.discount, off[t])
        for name, want in losses.items():
            _close(m[name], torch.tensor(want), FWD, f"step {t} {name}")
        _close(m["td_error"], td, FWD, f"step {t} td")
    assert state.step == 3
    _compare(state, ref)


def _five_forward_step(cfg, state, batch, off):
    """The CURL update with the anchor's own encoder forward in the
    contrastive step: the target conv map on next_obs, the critic's
    forward on obs, a ``no_grad`` conv map of obs for the actor step,
    then the critic's encoder on the anchor and the key's on pos."""
    obs = random_crop(batch.obs, cfg.crop_size, offsets=off[0])
    next_obs = random_crop(batch.next_obs, cfg.crop_size, offsets=off[1])
    pos = random_crop(batch.obs, cfg.crop_size, offsets=off[2])
    with torch.no_grad():
        h = state.target_critic.encoder.conv_map(next_obs)
        next_action = state.target_actor.actor(
            state.target_actor.encoder.trunk(h))
        target = state.target_critic.critic(
            state.target_critic.encoder.trunk(h), next_action)
        proj = categorical_projection(cfg.support, target, batch.reward,
                                      batch.discount)
    td_error = cross_entropy_per_sample(proj,
                                        state.critic(obs, batch.action))
    critic_loss = weighted_mean(td_error, None)
    state.critic_opt.zero_grad(set_to_none=True)
    critic_loss.backward()
    state.critic_opt.step()
    tie_shared(state.actor, state.critic, "convs")
    with torch.no_grad():
        h = state.critic.encoder.conv_map(obs)
        z = state.critic.encoder.trunk(h)
    action = state.actor.actor(state.actor.encoder.trunk(h))
    actor_loss = -torch.mean(expected_q(cfg.support,
                                        state.critic.critic(z, action)))
    params = list(state.actor.parameters())
    grads = torch.autograd.grad(actor_loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    state.actor_opt.step()
    tie_shared(state.actor, state.critic, "convs")
    soft_update(state.target_actor, state.actor, cfg.tau, cfg.encoder_tau)
    soft_update(state.target_critic, state.critic, cfg.tau, cfg.encoder_tau)
    tie_shared(state.target_actor, state.target_critic, "convs")
    z_a = state.critic.encoder(obs)
    with torch.no_grad():
        z_pos = state.target_critic.encoder(pos)
    curl_loss = contrastive_loss(state.curl.logits(z_a, z_pos))
    state.encoder_opt.zero_grad(set_to_none=True)
    state.curl_opt.zero_grad(set_to_none=True)
    curl_loss.backward()
    state.encoder_opt.step()
    state.curl_opt.step()
    tie_shared(state.actor, state.critic, "convs")
    state.step += 1
    actor_loss = actor_loss.detach()
    return {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss,
            "q_mean": -actor_loss, "td_error": td_error.detach(),
            "curl_loss": curl_loss.detach()}


def _equal_states(got, want):
    for net in ("actor", "critic", "target_actor", "target_critic"):
        a, b = getattr(got, net), getattr(want, net)
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), f"{net}.{name}"
    assert torch.equal(got.curl.W, want.curl.W)
    opts = {"actor_opt": "actor", "critic_opt": "critic",
            "encoder_opt": "critic.encoder", "curl_opt": "curl"}
    for opt, net in opts.items():
        for p, q in zip(_module(got, net).parameters(),
                        _module(want, net).parameters()):
            sa, sb = getattr(got, opt).state[p], getattr(want, opt).state[q]
            assert sa.keys() == sb.keys() and sa, opt
            for key in sa:
                assert torch.equal(sa[key], sb[key]), (opt, key)
    assert got.step == want.step


def _module(state, path):
    net, _, sub = path.partition(".")
    module = getattr(state, net)
    return module.get_submodule(sub) if sub else module


def _actor_loss_misses_the_critics_convs(state, monkeypatch):
    """Patch ``torch.autograd.grad`` so that, before the actor step's own
    call, it asserts the actor loss has no path to the critic's
    convolutions (it reads the anchor's map only detached)."""
    real = torch.autograd.grad
    convs = [p for n, p in state.critic.encoder.named_parameters()
             if n.startswith("conv")]
    calls = []

    def grad(outputs, inputs, **kw):
        reach = real(outputs, convs, retain_graph=True, allow_unused=True)
        assert all(g is None for g in reach)
        calls.append(1)
        return real(outputs, inputs, **kw)

    monkeypatch.setattr(torch.autograd, "grad", grad)
    return calls


def test_one_conv_map_serves_the_actor_step_and_the_anchor_bitwise(
        monkeypatch):
    """Four encoder forwards a step (the actor step's conv map kept with
    its graph as the anchor's) give every leaf, target, Adam moment, ``W``
    and metric of the step that runs the anchor's own forward, bitwise;
    three forwards a step are counted reused."""
    state, twin = _state(), _state()
    batch = _batch()
    off = _offsets(6, 3)
    for t in range(3):
        before = update_step.encoder_reused
        with monkeypatch.context() as m:
            calls = _actor_loss_misses_the_critics_convs(state, m)
            got = update_step(CFG, state, batch, draws=_draws(off[t]))
        assert calls == [1]
        assert update_step.encoder_reused - before == 3
        want = _five_forward_step(CFG, twin, batch, off[t])
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), (t, name)
        _equal_states(state, twin)


def test_a_write_to_the_critics_convs_before_the_anchors_backward_fails(
        monkeypatch):
    """The anchor's map keeps the critic's convolutions as they were at
    the actor step: an in-place write to them before the contrastive
    backward is refused by autograd's saved-tensor version check."""
    state = _state()
    real = update.soft_update

    def stepping(target, online, tau, encoder_tau=None):
        real(target, online, tau, encoder_tau)
        with torch.no_grad():
            state.critic.encoder.conv2.weight.mul_(1.0)

    monkeypatch.setattr(update, "soft_update", stepping)
    with pytest.raises(RuntimeError, match="inplace operation"):
        update_step(CFG, state, _batch(), draws=_draws(_offsets(6)[0]))


def test_the_state_generator_draws_the_crops_in_order():
    state, twin = _state(), _state()
    batch = _batch()
    gen = torch.Generator().manual_seed(int(state.generator.initial_seed()))
    off = torch.randint(0, FRAME[0] - CROP + 1, (3, B, 2), generator=gen)
    got = update_step(CFG, state, batch)
    want = update_step(CFG, twin, batch, draws=_draws(off))
    for name in ("critic_loss", "actor_loss", "curl_loss"):
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("variant", ["tanh_on", "key_online", "no_cpc"])
def test_a_wrong_variant_fails_by_more_than_the_tolerance(variant):
    state = _state()
    ref = _plain(state)
    if variant == "tanh_on":
        for net in (state.actor, state.critic, state.target_actor,
                    state.target_critic):
            net.encoder.tanh = True
    ref.key_online = variant == "key_online"
    if variant == "no_cpc":
        ref.contrastive_adams = ("encoder",)
    batch = _batch()
    off = _offsets(5, 3)
    for t in range(3):
        update_step(CFG, state, batch, draws=_draws(off[t]))
        ref.step(batch.obs, batch.action, batch.reward, batch.next_obs,
                 batch.discount, off[t])
    with pytest.raises(AssertionError):
        _compare(state, ref)


def test_a_fused_chunk_runs_the_reference_steps():
    state = _state()
    ref = _plain(state)
    rows = 24
    g = torch.Generator().manual_seed(7)
    storage = TransitionBatch(
        obs=torch.randint(0, 256, (rows, *FRAME), generator=g,
                          dtype=torch.uint8),
        action=torch.rand(rows, ACT, generator=g) * 2 - 1,
        reward=torch.rand(rows, generator=g),
        next_obs=torch.randint(0, 256, (rows, *FRAME), generator=g,
                               dtype=torch.uint8),
        done=torch.zeros(rows), discount=torch.full((rows,), 0.97))
    k = 3
    slots = torch.randint(0, rows, (k, B), generator=g, dtype=torch.int32)
    off = _offsets(8, k)
    chunk = make_fused_chunk(CFG, k=k, batch_size=B, prioritized=False)
    metrics = chunk(state, storage, rows, slots=slots, draws=_draws(off))
    assert set(metrics) == {"critic_loss", "actor_loss", "q_mean",
                            "td_error", "idx", "curl_loss"}
    for t in range(k):
        idx = slots[t].long()
        losses, td = ref.step(storage.obs[idx], storage.action[idx],
                              storage.reward[idx], storage.next_obs[idx],
                              storage.discount[idx], off[t])
        for name, want in losses.items():
            _close(metrics[name][t], torch.tensor(want), FWD, name)
        _close(metrics["td_error"][t], td, FWD, "td")
    _compare(state, ref)


def test_checkpoint_round_trip_keeps_w_and_the_new_adams(tmp_path):
    state = _state()
    batch = _batch()
    off = _offsets(9, 3)
    update_step(CFG, state, batch, draws=_draws(off[0]))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(state)
    restored, _ = ckpt.restore(init_state(CFG, 5, "cpu"))
    assert torch.equal(restored.curl.W, state.curl.W)
    for name in ("actor_opt", "critic_opt", "encoder_opt", "curl_opt"):
        a = getattr(state, name).state_dict()["state"]
        b = getattr(restored, name).state_dict()["state"]
        assert a.keys() == b.keys()
        for i in a:
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(a[i][key], b[i][key]), (name, i, key)
    # the curl module still holds the restored critic's encoder
    assert restored.curl.encoder is restored.critic.encoder
    # the restore clears targets_tied: the first step runs both target
    # encoders (two forwards reused, not three) on bitwise equal targets
    assert not restored.targets_tied
    for t, reused in ((1, 2), (2, 3)):
        want = update_step(CFG, state, batch, draws=_draws(off[t]))
        before = update_step.encoder_reused
        got = update_step(CFG, restored, batch, draws=_draws(off[t]))
        assert update_step.encoder_reused - before == reused
        assert restored.targets_tied
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), (t, name)
        _equal_states(restored, state)
    plain_cfg = dataclasses.replace(CFG, contrastive="none")
    with pytest.raises(ValueError, match="CURL state"):
        ckpt.restore(init_state(plain_cfg, 0, "cpu"))


CURL_ARGV = ["--env", "pixel-point", "--platform", "cpu", "--max_steps",
             "20", "--num_envs", "2", "--warmup", "64", "--n_eps", "1",
             "--n_cycles", "2", "--episodes_per_cycle", "1",
             "--train_steps_per_cycle", "4", "--updates_per_dispatch", "2",
             "--eval_trials", "1", "--bsize", "8", "--rmsize", "500",
             "--n_atoms", "11", "--v_min", "-20", "--encoder_width", "4",
             "--replay_storage", "device", "--fused_replay", "on",
             "--p_replay", "0", "--crop_size", "15", "--contrastive",
             "curl", "--encoder_tau", "0.05", "--lr_encoder", "2e-4"]


def test_train_entry_runs_curl_on_the_fake_pixel_env(tmp_path):
    cfg = parse_args(CURL_ARGV + ["--log_dir", str(tmp_path)])
    assert (cfg.contrastive, cfg.crop_size) == ("curl", 15)
    metrics = ttrain.train(cfg)
    for name in ("critic_loss", "actor_loss", "curl_loss"):
        assert np.isfinite(metrics[name]), name
    assert metrics["grad_steps_per_sec"] > 0
    lc = cfg.learner_config((16, 16, 3), ACT, device="cpu")
    assert lc.encoder_shape == (15, 15, 3) and lc.lr_encoder == 2e-4


# CURL's cheetah-run row on the normal entry, as the README gives it
CHEETAH_ARGV = ["--env", "cheetah-run-pixels", "--contrastive", "curl",
                "--pixel_size", "100", "--frame_stack", "3", "--crop_size",
                "84", "--encoder_tau", "0.05", "--tau", "0.01",
                "--lr_actor", "2e-4", "--lr_critic", "2e-4", "--lr_encoder",
                "2e-4", "--bsize", "512", "--rmsize", "100000",
                "--p_replay", "0", "--hidden", "1024", "1024"]


def test_curls_cheetah_run_flags_give_its_widths():
    cfg = parse_args(CHEETAH_ARGV).resolve()
    assert (cfg.contrastive, cfg.crop_size, cfg.encoder_tau, cfg.tau,
            cfg.lr_actor, cfg.lr_critic, cfg.lr_encoder, cfg.batch_size,
            cfg.memory_size, cfg.prioritized_replay, tuple(cfg.hidden),
            cfg.v_min, cfg.v_max) == ("curl", 84, 0.05, 0.01, 2e-4, 2e-4,
                                      2e-4, 512, 100_000, False,
                                      (1024, 1024), 0.0, 1000.0)
    lc = cfg.learner_config((100, 100, 9), 6, device="cpu")
    state = init_state(lc, 0, "cpu")
    enc = state.critic.encoder
    # unpadded maps of 41, 39, 37, 35 and no tanh, in actor and critic
    assert enc.proj.in_features == 35 * 35 * 32 and not enc.tanh
    assert not state.actor.encoder.tanh
    assert state.actor.encoder.proj is not enc.proj
    assert torch.equal(state.actor.encoder.conv1.weight, enc.conv1.weight)
    assert lc.obs_spec == (100, 100, 9) and lc.encoder_shape == (84, 84, 9)
    # the DrQ path keeps its SAME-padded encoder with tanh
    drq = dataclasses.replace(lc, contrastive="none")
    enc = drq.build_critic(torch.Generator().manual_seed(0)).encoder
    assert enc.proj.in_features == 50 * 50 * 32 and enc.tanh


@pytest.mark.parametrize("kw, match", [
    (dict(critic_family="mog"), "mog"),
    (dict(augment="shift"), "drop --augment"),
    (dict(pixels=False), "pixel"),
    (dict(share_encoder=True), "share_encoder"),
    (dict(crop_size=21), "does not fit"),
])
def test_the_config_refuses_what_curl_cannot_run(kw, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(CFG, **kw)


class _Mesh:
    model_parallel = 2


def test_one_learner_only_the_mesh_replicas_and_the_model_axis_refuse():
    with pytest.raises(ValueError, match="data-parallel"):
        check_mesh_compatible(CFG)
    with pytest.raises(ValueError, match="replica group"):
        MeshReplicaGroup(CFG, [], k=1, batch_size=B)
    with pytest.raises(ValueError, match="learner replica"):
        LearnerReplica(0, CFG, None, _state(), k=1, batch_size=B)
    with pytest.raises(ValueError, match="model axis"):
        shard_state(_state(), _Mesh())
    with pytest.raises(ValueError, match="JAX package"):
        state_from_jax(CFG, None, "cpu")
    for extra in (["--learners", "2"], ["--data_parallel", "2"]):
        with pytest.raises(ValueError, match="one learner"):
            ttrain.train(parse_args(CURL_ARGV + extra))
