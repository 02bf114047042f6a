"""Port vs reference: the training driver (``d4pg_tpu_torch.train``).

The config surface (same flags, fields and run names as the JAX
parser), tiny end-to-end runs on ``--platform cpu --replay_storage device
--fused_replay on`` (PER and uniform with async actors), bitwise
determinism of two same-seed runs, checkpoint round trip and exact
resume, one cycle for each flag value the host replay path, the obs
plane and the model families (bfloat16, the pixel path, the MoG critic)
made trainable (and the default flags on the CPU, which take the host
path), a resume of each family to the state its first run ended with,
the reference's errors for those flags' misuse, the HER recipe
(``fake-goal --her 1``, with and without ``--normalize_obs 1``: two
cycles and a resume with the statistics restored; the reference's two
resume refusals), ``--serve 1`` with a remote actor on a thread,
``--actor_procs`` (marked ``slow``, as the reference's
``tests/test_actor_procs.py``), ``--serve_policy 1`` with an actor acting
through ``--policy_port`` on a thread, ``--sample_on_ingest 1`` under
each ``--sampler`` arm and ``--learners 2`` (each training and
publishing monotone versions through the aggregator), the refusal of
every flag value that still selects an unported path, and whole-slice
parity on both paths: with the same
initial weights carried across and exploration off, the rows both
drivers hold in replay when the first grad step starts match within atol
1e-5 (and on the host path the first chunk's slots and IS weights are
bitwise equal). Small sizes throughout: hidden (16, 16), 11 atoms,
batch 16, K <= 8, the ``point`` env.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu import config as jconfig
from d4pg_tpu.learner import loop as jloop
from d4pg_tpu.learner import state as jstate
from d4pg_tpu_torch import train as ttrain
from d4pg_tpu_torch.config import ExperimentConfig, build_parser, parse_args
from d4pg_tpu_torch.io.checkpoint import CheckpointManager
from d4pg_tpu_torch.io.from_jax import state_from_jax
from d4pg_tpu_torch.learner import loop as tloop
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(env="point", max_steps=20, num_envs=2, warmup=100, n_epochs=1,
            n_cycles=2, episodes_per_cycle=1, train_steps_per_cycle=6,
            updates_per_dispatch=4, eval_trials=1, batch_size=16,
            memory_size=2000, hidden=(16, 16), n_atoms=11, v_min=-5.0,
            v_max=0.0)
FUSED = dict(platform="cpu", replay_storage="device", fused_replay="on")
TINY_ARGV = ["--env", "point", "--max_steps", "20", "--num_envs", "2",
             "--warmup", "100", "--n_eps", "1", "--n_cycles", "2",
             "--episodes_per_cycle", "1", "--train_steps_per_cycle", "6",
             "--updates_per_dispatch", "4", "--eval_trials", "1",
             "--bsize", "16", "--rmsize", "2000", "--n_atoms", "11",
             "--v_min", "-5", "--v_max", "0", "--platform", "cpu",
             "--replay_storage", "device", "--fused_replay", "on"]


def _cfg(tmp_path, **kw):
    return ExperimentConfig(**{**TINY, **FUSED, "log_dir": str(tmp_path),
                               **kw})


def _csv(cfg):
    return Path(cfg.log_dir, cfg.run_name(), "returns.csv").read_text()


@pytest.mark.parametrize("argv", [
    [],
    ["--env", "point", "--bsize", "16", "--rmsize", "2000", "--n_eps", "2"],
    ["--p_replay", "0", "--her", "1", "--n_steps", "5", "--n_workers", "3"],
    ["--strict_reference", "1", "--projection", "pallas_ce"],
    ["--env", "HalfCheetah-v4", "--platform", "cpu", "--replay_storage",
     "device", "--fused_replay", "on", "--actor_device", "default"],
    ["--noise", "ou", "--random_eps", "0.2", "--async_actors", "1",
     "--concurrent_eval", "0", "--resume", "1", "--seed", "9"],
])
def test_parse_args_matches_reference(argv):
    port, ref = parse_args(argv), jconfig.parse_args(argv)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.run_name() == ref.run_name()
    assert (dataclasses.asdict(port.resolve())
            == dataclasses.asdict(ref.resolve()))


def test_parser_has_the_reference_flags():
    def flags(parser):
        return {(a.dest, tuple(a.option_strings), a.default,
                 tuple(a.choices) if a.choices else None)
                for a in parser._actions if a.dest != "help"}

    assert flags(build_parser()) == flags(jconfig.build_parser())
    with pytest.raises(SystemExit):
        parse_args(["--batch_size", "8"])  # the reference's spelling only


def test_learner_config_resolves_auto_to_the_plain_arm_on_cpu():
    cfg = ExperimentConfig(**TINY)
    lc = cfg.learner_config(4, 2, device="cpu")
    assert lc == D4PGConfig(obs_dim=4, act_dim=2, v_min=-5.0, v_max=0.0,
                            n_atoms=11, hidden=(16, 16), projection="einsum")
    jlc = jconfig.ExperimentConfig(**TINY).learner_config(4, 2)
    for field in ("v_min", "v_max", "n_atoms", "hidden", "projection",
                  "lr_actor", "lr_critic", "tau", "gamma", "adam_b2"):
        assert getattr(lc, field) == getattr(jlc, field), field


@pytest.mark.parametrize("kw", [
    dict(),
    dict(prioritized_replay=False, async_actors=True,
         train_steps_per_cycle=18, projection="pallas_ce"),
])
def test_train_end_to_end(tmp_path, kw):
    cfg = _cfg(tmp_path, **kw)
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    assert "avg_test_reward" in metrics
    assert metrics["grad_steps_per_sec"] > 0
    run_dir = Path(tmp_path, cfg.run_name())
    rows = [r.split(",") for r in _csv(cfg).splitlines()]
    steps = cfg.train_steps_per_cycle
    assert [int(r[0]) for r in rows][:2] == [steps, 2 * steps]
    assert CheckpointManager(str(run_dir / "ckpt")).latest_step == 2 * steps


def test_same_seed_runs_write_the_same_returns(tmp_path):
    def run(tag):
        cfg = _cfg(tmp_path / tag, seed=123, concurrent_eval=False,
                   episodes_per_cycle=2, train_steps_per_cycle=8,
                   eval_trials=2)
        ttrain.train(cfg)
        return _csv(cfg)

    a = run("a")
    assert a == run("b")
    assert len(a.splitlines()) == 2


def test_main_runs_writes_a_checkpoint_and_resumes(tmp_path):
    """``python -m d4pg_tpu_torch.train`` on the CPU, then ``--resume 1``
    for one more cycle: the run goes on from the saved step."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    argv = [sys.executable, "-m", "d4pg_tpu_torch.train", *TINY_ARGV,
            "--log_dir", str(tmp_path)]
    first = subprocess.run(argv, env=env, capture_output=True, text=True,
                           timeout=300, cwd=tmp_path)
    assert first.returncode == 0, first.stderr[-2000:]
    cfg = _cfg(tmp_path)
    ckpt = CheckpointManager(str(Path(tmp_path, cfg.run_name(), "ckpt")))
    assert ckpt.latest_step == 12
    resumed = subprocess.run(argv + ["--n_cycles", "1", "--resume", "1"],
                             env=env, capture_output=True, text=True,
                             timeout=300, cwd=tmp_path)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "resumed from step 12" in resumed.stdout
    # a row per cycle, and one more for the final background eval
    steps = [int(r.split(",")[0]) for r in _csv(cfg).splitlines()]
    assert steps == [6, 12, 12, 18, 18]
    assert ckpt.latest_step == 18
    assert "gymnasium" not in first.stdout


def _filled(rng, n=60):
    buf = FusedDeviceReplay(64, 4, 2, device="cpu", block_rows=16)
    done = (rng.random(n) < 0.2).astype(np.float32)
    buf.add(TransitionBatch(
        obs=rng.standard_normal((n, 4)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, 4)).astype(np.float32),
        done=done, discount=(0.99 * (1 - done)).astype(np.float32)))
    buf.drain()
    return buf


def test_checkpoint_round_trip_and_exact_resume(tmp_path, rng):
    """Save after a chunk, go on for another; restore into a fresh state
    and generator, run the same chunk: bitwise the same."""
    cfg = D4PGConfig(obs_dim=4, act_dim=2, v_min=-5.0, v_max=0.0,
                     n_atoms=11, hidden=(16, 16), projection="pallas_ce")
    buf = _filled(rng)
    state, gen = init_state(cfg, 1, "cpu"), torch.Generator().manual_seed(3)
    loop = FusedLoop(cfg, buf, k=3, batch_size=8, generator=gen)
    loop.run(state, 3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(init_state(cfg, 0, "cpu"))
    mgr.save(state, extra={"env_steps": 42}, generator=gen)
    trees = type(buf.trees)(*[t.clone() for t in buf.trees])
    going_on = loop.run(state, 3)

    restored, fresh_gen = init_state(cfg, 99, "cpu"), torch.Generator()
    restored, extra = mgr.restore(restored, generator=fresh_gen)
    assert extra == {"env_steps": 42} and restored.step == 3
    buf.trees = trees
    again = FusedLoop(cfg, buf, k=3, batch_size=8,
                      generator=fresh_gen).run(restored, 3)
    for name in going_on:
        assert torch.equal(going_on[name], again[name]), name
    for a, b in ((state.actor, restored.actor),
                 (state.target_critic, restored.target_critic)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
    assert torch.equal(
        state.critic_opt.state_dict()["state"][0]["exp_avg_sq"],
        restored.critic_opt.state_dict()["state"][0]["exp_avg_sq"])
    # retention: the newest max_to_keep checkpoints stay
    for _ in range(3):
        loop.run(state, 1)
        mgr.save(state)
    assert mgr.steps() == [8, 9] and mgr.latest_step == 9
    mgr.wait(), mgr.close()


# flag values that raised until the host replay path and the obs plane
# were ported: (config overrides, resolved storage, fused)
RETIRED = [
    (dict(fused_replay="off"), "device", False),
    (dict(replay_storage="host", fused_replay="auto"), "host", False),
    (dict(replay_storage="auto", fused_replay="auto"), "host", False),
    (dict(trace_sample=0.5), "device", True),
    (dict(profile_dir="prof"), "device", True),
]


@pytest.mark.parametrize("kw,storage,fused", RETIRED,
                         ids=[",".join(k) + "=" + str(list(k.values())[0])
                              for k, _, _ in RETIRED])
def test_retired_flag_values_train(tmp_path, monkeypatch, kw, storage,
                                   fused):
    """One cycle with each value on the CPU, through the path it
    resolves to."""
    paths = []

    class Pipeline(ttrain.ChunkPipeline):
        def run(self, *args, **kwargs):
            paths.append("pipeline")
            return super().run(*args, **kwargs)

    class Loop(ttrain.FusedLoop):
        def run(self, *args, **kwargs):
            paths.append("fused")
            return super().run(*args, **kwargs)

    monkeypatch.setattr(ttrain, "ChunkPipeline", Pipeline)
    monkeypatch.setattr(ttrain, "FusedLoop", Loop)
    if "profile_dir" in kw:
        kw = dict(kw, profile_dir=str(tmp_path / kw["profile_dir"]))
    cfg = _cfg(tmp_path, n_cycles=1, train_steps_per_cycle=8, **kw)
    assert ttrain.resolve_storage(cfg, 4, 2, torch.device("cpu")) == (
        storage, fused)
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    assert paths == ["fused" if fused else "pipeline"]
    assert CheckpointManager(str(Path(
        tmp_path, cfg.run_name(), "ckpt"))).latest_step == 8
    if "profile_dir" in kw:
        assert len(list(Path(kw["profile_dir"]).glob("trace_*.json"))) == 1
    if "trace_sample" in kw:
        assert "wire_to_grad_p95_ms" not in metrics


def test_default_flags_on_cpu_train_on_the_host_path(tmp_path, capsys):
    """``--platform cpu`` with the default storage flags: ``auto`` storage
    resolves to host RAM, PER over the native trees, and it trains."""
    result = ttrain.main(TINY_ARGV[:-4] + ["--log_dir", str(tmp_path),
                                           "--debug", "1"])
    assert np.isfinite(result["critic_loss"])
    assert "replay storage: host (fused=False) on cpu" in capsys.readouterr(
        ).out


def test_fused_on_with_host_storage_raises(tmp_path):
    with pytest.raises(ValueError, match="requires device replay storage"):
        ttrain.train(_cfg(tmp_path, replay_storage="host"))


UNPORTED = [
    (dict(agg_transport="collective"), "item 15"),
    (dict(learners=2, data_parallel=2), "item 15"),
]


@pytest.mark.parametrize("kw,item", UNPORTED,
                         ids=[",".join(k) + "=" + str(list(k.values())[0])
                              for k, _ in UNPORTED])
def test_unported_flag_values_raise(tmp_path, kw, item):
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        ttrain.train(_cfg(tmp_path, **kw))
    assert item in str(err.value)
    assert not list(Path(tmp_path).rglob("*.pt"))


def test_actor_main_parses_the_serving_flags():
    from d4pg_tpu_torch import actor_main

    ns = actor_main.build_parser().parse_args(
        ["--learner_host", "h", "--transitions_port", "1", "--weights_port",
         "2", "--policy_port", "3", "--policy_timeout", "0.25"])
    assert (ns.policy_port, ns.policy_timeout) == (3, 0.25)


@pytest.mark.parametrize("platform", ["auto", "accel"])
def test_platform_without_a_card_raises(tmp_path, monkeypatch, platform):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.train(_cfg(tmp_path, platform=platform))
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(TINY_ARGV[:-6] + ["--platform", platform,
                                       "--log_dir", str(tmp_path)])


def test_gymnasium_envs_build_through_make_env_fn():
    """A gymnasium id builds; an id gymnasium does not know is looked up
    in gymnasium_robotics (registered on import, the MuJoCo-3 shim
    installed) and, unknown there too, raises gymnasium's error as the
    reference's does."""
    import gymnasium as gym

    cfg = ExperimentConfig(env="Pendulum-v1").resolve()
    assert ttrain.infer_dims(cfg) == (3, 1, np.float32)
    with pytest.raises(gym.error.NameNotFound):
        ttrain.make_env_fn(ExperimentConfig(env="NoSuchEnv-v0"), 0)()


class _FakeDMC:
    """Stands in for ``envs.dmc.DMControlEnv`` where the test must not
    depend on dm_control: the fake pixel env for pixel tasks, the point
    mass for state tasks."""

    def __init__(self, domain, task, pixels, seed, height, width):
        from d4pg_tpu_torch.envs.fake import PixelPointEnv, PointMassEnv

        self._env = (PixelPointEnv(seed=seed, horizon=20) if pixels
                     else PointMassEnv(seed=seed, horizon=20))
        self.observation_space = self._env.observation_space
        self.action_space = self._env.action_space

    def __getattr__(self, name):
        return getattr(self._env, name)


PIXEL_TINY = dict(encoder_width=8, v_min=-20.0)
# flag values that raised until the model families were ported
# (bfloat16, the pixel path, the MoG critic): each trains one cycle on the
# fused path
RETIRED_FAMILIES = [
    dict(env="pixel-point", **PIXEL_TINY),
    dict(env="dmc:cheetah-run"),
    dict(env="cheetah-run-pixels", pixel_size=16, **PIXEL_TINY),
    dict(env="pixel-point", frame_stack=3, **PIXEL_TINY),
    dict(env="pixel-point", augment="shift", **PIXEL_TINY),
    dict(env="pixel-point", share_encoder=True, **PIXEL_TINY),
    dict(critic_family="mog"),
    dict(compute_dtype="bfloat16"),
]


@pytest.mark.parametrize("kw", RETIRED_FAMILIES,
                         ids=[",".join(f"{k}={v}" for k, v in kw.items()
                                       if k not in PIXEL_TINY)
                              for kw in RETIRED_FAMILIES])
def test_retired_family_flag_values_train(tmp_path, monkeypatch, kw):
    monkeypatch.setattr(ttrain, "DMControlEnv", _FakeDMC)
    cfg = _cfg(tmp_path, n_cycles=1, train_steps_per_cycle=4, **kw)
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    assert CheckpointManager(str(Path(
        tmp_path, cfg.run_name(), "ckpt"))).latest_step == 4


def _states_equal(a, b):
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for (n, p), (_, q) in zip(getattr(a, name).named_parameters(),
                                  getattr(b, name).named_parameters()):
            assert torch.equal(p, q), f"{name}.{n}"
    for name in ("actor_opt", "critic_opt"):
        sa = getattr(a, name).state_dict()["state"]
        sb = getattr(b, name).state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), f"{name} {i} {k}"
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


FAMILY_RUNS = {
    "pixel_fused": dict(env="pixel-point", frame_stack=3, augment="shift",
                        share_encoder=True, **PIXEL_TINY),
    "pixel_host": dict(env="pixel-point", frame_stack=3, augment="shift",
                       share_encoder=True, replay_storage="auto",
                       fused_replay="auto", **PIXEL_TINY),
    "mog": dict(critic_family="mog"),
    "bfloat16": dict(compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", list(FAMILY_RUNS))
def test_family_runs_resume_to_the_same_state(tmp_path, monkeypatch, name):
    """Two cycles, then ``--resume 1``: the restored state (weights, Adam
    moments, step and the state's generator, which draws the DrQ offsets
    and MoG samples) is the one the first run ended with. The pixel runs
    store uint8 [16, 16, 9] rows."""
    states, buffers = [], []
    init = ttrain.init_state

    def recording_init(config, seed, device):
        states.append(init(config, seed, device))
        return states[-1]

    class Service(ttrain.ReplayService):
        def __init__(self, buffer, *args, **kwargs):
            buffers.append(buffer)
            super().__init__(buffer, *args, **kwargs)

    monkeypatch.setattr(ttrain, "init_state", recording_init)
    monkeypatch.setattr(ttrain, "ReplayService", Service)
    cfg = _cfg(tmp_path, concurrent_eval=False, **FAMILY_RUNS[name])
    assert np.isfinite(ttrain.train(cfg)["critic_loss"])
    assert states[0].step == 2 * cfg.train_steps_per_cycle
    ttrain.train(dataclasses.replace(cfg, resume=True, n_cycles=0))
    _states_equal(states[0], states[1])
    if name.startswith("pixel"):
        assert states[0].actor.detach_encoder
        rows = buffers[0].gather(np.arange(4)) if name == "pixel_host" \
            else buffers[0].storage
        assert rows.obs.dtype in (np.uint8, torch.uint8)
        assert tuple(rows.obs.shape[1:]) == (16, 16, 9)


@pytest.mark.parametrize("kw,match", [
    (dict(frame_stack=3), "requires a pixel env"),
    (dict(augment="shift"), "requires the pixel"),
    (dict(share_encoder=True), "share_encoder"),
    (dict(env="pixel-point", critic_family="mog"), "pixel encoder"),
])
def test_family_flag_misuse_raises_as_in_the_reference(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        ttrain.train(_cfg(tmp_path, **kw))
    assert not list(Path(tmp_path).rglob("*.pt"))


@pytest.mark.parametrize("kw,item", [
    (dict(agg_transport="collective", env="Pendulum-v1"), "item 15"),
    (dict(learners=2, data_parallel=2, env="pixel-point"), "item 15")],
    ids=["agg_transport-Pendulum", "learners-mesh-pixels"])
def test_unported_flags_raise_before_the_env_is_built(tmp_path, monkeypatch,
                                                      kw, item):
    """An unported flag names its ROADMAP item before ``make_env_fn``
    builds an env: where gymnasium is missing, an unported flag with
    ``--env Pendulum-v1`` must not end in gymnasium's ImportError."""
    def no_env(*args, **kwargs):
        raise AssertionError("an env was built before check_ported")

    monkeypatch.setattr(ttrain, "make_env_fn", no_env)
    with pytest.raises(NotImplementedError, match=item):
        ttrain.train(_cfg(tmp_path, **kw))


def test_normalize_obs_with_pixels_is_a_config_error(tmp_path):
    """The reference's check on the obs shape: pixels are normalized by
    the encoder, so ``--normalize_obs`` is refused for them before any
    run directory is written."""
    with pytest.raises(ValueError, match="vector observations"):
        ttrain.train(_cfg(tmp_path, env="pixel-point", normalize_obs=True))
    assert not list(Path(tmp_path).rglob("*.pt"))


def test_pixel_storage_reckons_the_obs_itemsize():
    """``auto`` storage reckons the ring at the obs dtype's itemsize: a
    50,000-row ring of 84x84x9 uint8 frames (6.35 GB) stays on the card,
    a 1,000,000-row one goes to host RAM, and the same ring in float32
    would not fit."""
    card = torch.device("cuda")
    frames = (84, 84, 9)
    for rows, want in ((50_000, ("device", True)),
                       (1_000_000, ("host", False))):
        cfg = ExperimentConfig(env="pixel-point", memory_size=rows)
        assert ttrain.resolve_storage(cfg, frames, 6, card, np.uint8) == want
    cfg = ExperimentConfig(env="pixel-point", memory_size=50_000)
    assert ttrain.resolve_storage(cfg, frames, 6, card, np.float32) == (
        "host", False)


def _capture_first_replay(monkeypatch, module, sink):
    """Wrap ``FusedLoop.run`` to keep the replay rows (after the
    cycle-boundary flush) the first time a grad step is about to run."""
    original = module.FusedLoop.run

    def run(self, state, n, *args, **kwargs):
        if not sink and n > 0:
            self.ingest.flush()
            buf = self._buffer
            sink.append([np.array(np.asarray(f)[:buf.size])
                         for f in buf.storage])
        return original(self, state, n, *args, **kwargs)

    monkeypatch.setattr(module.FusedLoop, "run", run)


def test_whole_slice_replay_rows_match_reference(tmp_path, monkeypatch):
    """Both drivers from the same initial weights (the port's
    ``init_state`` patched to carry the JAX one across), exploration off:
    the rows each holds in replay when its first grad step starts."""
    from d4pg_tpu.train import train as jax_train

    kw = dict(TINY, epsilon_0=0.0, min_epsilon=0.0, concurrent_eval=False,
              n_cycles=1, train_steps_per_cycle=4, seed=5, **FUSED)
    jcfg = jconfig.ExperimentConfig(**kw, log_dir=str(tmp_path / "jax"))
    js = jstate.init_state(jcfg.learner_config(4, 2), jax.random.key(5))
    carried = jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key)))
    monkeypatch.setattr(
        ttrain, "init_state",
        lambda config, seed, device: state_from_jax(config, carried, device))
    jrows, trows = [], []
    _capture_first_replay(monkeypatch, jloop, jrows)
    _capture_first_replay(monkeypatch, tloop, trows)
    jax_train(jcfg)
    ttrain.train(ExperimentConfig(**kw, log_dir=str(tmp_path / "port")))
    assert jrows and trows
    for name, t, j in zip(TransitionBatch._fields, trows[0], jrows[0]):
        assert t.shape == j.shape and t.shape[0] > 100, name
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0, err_msg=name)


def test_host_path_replay_rows_and_first_chunk_match_reference(
        tmp_path, monkeypatch):
    """Both drivers on the CPU with the default storage flags (the
    host-sampled path) from the same initial weights, exploration off:
    the rows in replay when the first chunk is sampled match within atol
    1e-5, and the chunk's slots and IS weights are bitwise equal."""
    from d4pg_tpu.distributed import replay_service as jservice
    from d4pg_tpu.train import train as jax_train
    from d4pg_tpu_torch.distributed import replay_service as tservice

    kw = dict(TINY, epsilon_0=0.0, min_epsilon=0.0, concurrent_eval=False,
              n_cycles=1, train_steps_per_cycle=8, seed=5, platform="cpu")
    jcfg = jconfig.ExperimentConfig(**kw, log_dir=str(tmp_path / "jax"))
    js = jstate.init_state(jcfg.learner_config(4, 2), jax.random.key(5))
    carried = jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key)))
    monkeypatch.setattr(
        ttrain, "init_state",
        lambda config, seed, device: state_from_jax(config, carried, device))
    seen = {}

    def capture(module, side):
        original = module.ReplayService.sample_chunk

        def sample_chunk(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            if side not in seen:
                buf = self.buffer
                rows = buf.gather(np.arange(len(buf)))
                seen[side] = ([np.asarray(f) for f in rows], out[1], out[2])
            return out

        monkeypatch.setattr(module.ReplayService, "sample_chunk",
                            sample_chunk)

    capture(jservice, "jax")
    capture(tservice, "port")
    jax_train(jcfg)
    ttrain.train(ExperimentConfig(**kw, log_dir=str(tmp_path / "port")))
    (trows, tw, tidx), (jrows, jw, jidx) = seen["port"], seen["jax"]
    for name, t, j in zip(TransitionBatch._fields, trows, jrows):
        assert t.shape == j.shape and t.shape[0] > 100, name
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tw, jw)


# -- the HER recipe and the remote planes ------------------------------------

HER = dict(env="fake-goal", her=True, n_steps=1, max_steps=20,
           episodes_per_cycle=2, v_min=-20.0, v_max=0.0)


class _RecordingRMS(ttrain.RunningMeanStd):
    """Records the state each driver normalizer was restored to."""

    restored: list = []

    def load_state_dict(self, d):
        super().load_state_dict(d)
        _RecordingRMS.restored.append(self.state_dict())


@pytest.mark.parametrize("normalize", [False, True])
def test_her_trains_and_resumes_with_the_statistics(tmp_path, monkeypatch,
                                                    normalize):
    """``--env fake-goal --her 1`` (with and without ``--normalize_obs
    1``) trains two cycles on the CPU, then resumes for one: the
    normalizer comes back with the count, mean and M2 it was saved with,
    and the run goes on from the saved step."""
    monkeypatch.setattr(ttrain, "RunningMeanStd", _RecordingRMS)
    _RecordingRMS.restored = []
    cfg = _cfg(tmp_path, **HER, normalize_obs=normalize)
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    assert 0.0 <= metrics["success_rate"] <= 1.0
    ckpt = CheckpointManager(str(Path(tmp_path, cfg.run_name(), "ckpt")))
    assert ckpt.latest_step == 12
    saved = torch.load(Path(ckpt._path(12)), weights_only=True)["extra"]
    assert ("obs_norm" in saved) == normalize
    ttrain.train(dataclasses.replace(cfg, n_cycles=1, resume=True))
    assert ckpt.latest_step == 18
    if not normalize:
        assert _RecordingRMS.restored == []
        return
    (restored,) = _RecordingRMS.restored
    want = saved["obs_norm"]
    assert restored["count"] == want["count"] > 0
    np.testing.assert_array_equal(restored["mean"], want["mean"].numpy())
    np.testing.assert_array_equal(restored["m2"], want["m2"].numpy())


def test_normalize_obs_resume_refusals(tmp_path):
    """The reference's two refusals: a normalized checkpoint resumed
    without the flag, and a raw one resumed with it."""
    raw = _cfg(tmp_path / "raw", **HER, n_cycles=1)
    ttrain.train(raw)
    with pytest.raises(ValueError, match="without obs_norm"):
        ttrain.train(dataclasses.replace(raw, resume=True,
                                         normalize_obs=True))
    normed = _cfg(tmp_path / "norm", **HER, n_cycles=1, normalize_obs=True)
    ttrain.train(normed)
    with pytest.raises(ValueError, match="resume with the flag"):
        ttrain.train(dataclasses.replace(normed, resume=True,
                                         normalize_obs=False))


def test_serve_trains_with_a_remote_actor_thread(tmp_path, monkeypatch):
    """``--serve 1``: the receiver and the weight server come up with
    their ports printed, a remote ``run_actor`` on a thread streams into
    the learner's service and pulls its weights, and two cycles train."""
    from d4pg_tpu_torch import actor_main

    seen = {}

    class Planes(ttrain.RemotePlanes):
        def __init__(self, cfg, service, weights):
            super().__init__(cfg, service, weights)
            seen["before"] = len(service)
            remote = dataclasses.replace(cfg, num_envs=1, seed=99)
            t = threading.Thread(target=lambda: seen.update(
                steps=actor_main.run_actor(
                    remote, "127.0.0.1", self.receiver.port,
                    self.weight_server.port, actor_id="remote-0",
                    max_ticks=40, send_timeout=10.0)), daemon=True)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
            # 40 ticks of one env, n-step folded: at least 35 rows
            assert service.wait_until(seen["before"] + 35, timeout=10.0)
            seen["service"] = service
            seen["server"] = self.weight_server

    monkeypatch.setattr(ttrain, "RemotePlanes", Planes)
    cfg = _cfg(tmp_path, serve=True)
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    assert seen["steps"] == 40
    assert "remote-0" in seen["service"]._heartbeats
    assert metrics["env_steps"] >= seen["before"] + 35
    assert seen["server"].pulls_served >= 1
    assert "dead_actors" in metrics


@pytest.mark.parametrize("path", ["fused", "host"])
def test_sharded_serve_with_a_v2_weight_puller_trains_and_resumes(
        tmp_path, monkeypatch, path):
    """``--serve 1 --ingest_shards 2``: two receiver listeners on one port
    hand raw frames undecoded to the service's two shard workers (on the
    fused path they stage into two rings), a remote ``run_actor`` on a
    thread pulls ``--weight_codec bf16`` frames from the weight plane and
    stamps traces; two cycles train, then a resume trains one more."""
    from d4pg_tpu_torch import actor_main
    from d4pg_tpu_torch.obs.trace import RECORDER

    seen = {}

    class Planes(ttrain.RemotePlanes):
        def __init__(self, cfg, service, weights):
            super().__init__(cfg, service, weights)
            before = len(service)
            remote = dataclasses.replace(cfg, num_envs=1, seed=77)
            t = threading.Thread(target=lambda: seen.update(
                steps=actor_main.run_actor(
                    remote, "127.0.0.1", self.receiver.port,
                    self.weight_server.port, actor_id="remote-v2",
                    max_ticks=40, send_timeout=10.0, codec="raw",
                    trace_sample=1.0, weight_codec="bf16")), daemon=True)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
            assert service.wait_until(before + 35, timeout=10.0)
            seen.setdefault("reuseport", []).append(self.receiver.reuseport)
            seen["service"] = service
            seen["server"] = self.weight_server

    monkeypatch.setattr(ttrain, "RemotePlanes", Planes)
    storage = (dict(FUSED) if path == "fused" else
               dict(platform="cpu", replay_storage="host",
                    fused_replay="off"))
    cfg = _cfg(tmp_path, serve=True, ingest_shards=2, trace_sample=1.0,
               **storage)
    try:
        metrics = ttrain.train(cfg)
        assert np.isfinite(metrics["critic_loss"]) and seen["steps"] == 40
        stats = seen["service"].ingest_stats()
        assert stats["num_ingest_shards"] == 2
        assert stats["sheds"] == stats["admit_fails"] == 0
        assert stats["decode_errors"] == stats["order_breaks"] == 0
        assert seen["service"].rows_by_actor()["remote-v2"] >= 35
        staged = sum(p["staged_rows"] for p in stats["per_shard"])
        assert (staged > 0) == (path == "fused")
        weights = seen["server"].weight_stats()
        assert weights["frames_full"] >= 1
        assert weights["oracle_quant_failures"] == 0
        assert metrics["wire_to_grad_p95_ms"] >= 0
        assert RECORDER.orphans() == []
        resumed = ttrain.train(dataclasses.replace(cfg, resume=True,
                                                   n_cycles=1))
        assert np.isfinite(resumed["critic_loss"])
        assert resumed["env_steps"] > metrics["env_steps"]
        assert seen["reuseport"] == [True, True]
    finally:
        RECORDER.disable()
        RECORDER.reset()


@pytest.mark.parametrize("fail_at", ["weight_server", "loop"])
def test_remote_planes_closed_when_a_run_fails(tmp_path, monkeypatch,
                                               fail_at):
    """What ``--serve 1`` started does not outlive a failed run: a start
    that fails after the receiver is up closes the receiver, and a run
    that fails in its cycle loop closes the planes on the way out."""
    import socket

    from d4pg_tpu_torch.distributed import weight_plane

    seen = {}

    class Planes(ttrain.RemotePlanes):
        def close(self):
            seen["port"] = self.receiver.port
            seen["closed"] = seen.get("closed", 0) + 1
            super().close()

    class Broken:
        def __init__(self, *args, **kwargs):
            raise RuntimeError("the start failed")

    monkeypatch.setattr(ttrain, "RemotePlanes", Planes)
    if fail_at == "weight_server":
        monkeypatch.setattr(weight_plane, "WeightPlaneServer", Broken)
    else:
        monkeypatch.setattr(ttrain, "StepTimer", Broken)
    with pytest.raises(RuntimeError, match="the start failed"):
        ttrain.train(_cfg(tmp_path, serve=True))
    assert seen["closed"] == 1
    with socket.socket() as probe:  # nothing listens on the port now
        probe.settimeout(5.0)
        assert probe.connect_ex(("127.0.0.1", seen["port"])) != 0


@pytest.mark.slow
def test_train_with_spawned_actor_processes(tmp_path):
    """``--actor_procs 1 --n_workers 0``: every row arrives over TCP from
    a spawned ``actor_main`` process."""
    cfg = _cfg(tmp_path, n_workers=0, actor_procs=1, async_actors=True,
               train_steps_per_cycle=8)
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    assert metrics["env_steps"] >= 100


@pytest.mark.slow
def test_spawned_actor_process_respawned_on_death(tmp_path, capfd):
    """A killed ``--actor_procs`` child is respawned by the once-per-cycle
    supervisor, and liveness reaches the metrics as ``dead_actors``."""
    import multiprocessing as mp

    cfg = _cfg(tmp_path, n_cycles=10, n_workers=0, actor_procs=1,
               async_actors=True, train_steps_per_cycle=8)
    result: dict = {}
    t = threading.Thread(target=lambda: result.update(ttrain.train(cfg)),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 300
    csv = Path(tmp_path, cfg.run_name(), "returns.csv")
    while time.monotonic() < deadline:
        if csv.exists() and csv.stat().st_size > 0 and mp.active_children():
            break
        time.sleep(0.2)
    kids = mp.active_children()
    assert kids, "spawned actor process not found"
    kids[0].terminate()
    t.join(timeout=600)
    assert not t.is_alive()
    assert "supervisor: restarting actor process 0" in capfd.readouterr().out
    assert "dead_actors" in result
    assert np.isfinite(result["critic_loss"])


# --- the serving plane and the learner plane --------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_serve_policy_trains_with_a_policy_port_actor(tmp_path, monkeypatch):
    """``--serve 1 --serve_policy 1 --n_workers 0``: the learner waits for
    a remote actor that acts through the policy server (``run_actor``
    with ``policy_port``) to fill the warm-up, then trains; the actor's
    client was served every request (no fallback, no timeout, no tear)."""
    from d4pg_tpu_torch import actor_main
    from d4pg_tpu_torch.serving import server as tserver

    servers, clients, seen = [], [], {}

    class Server(tserver.PolicyInferenceServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

        def close(self):
            # the actor's last request is served before the server goes
            seen["thread"].join(timeout=120)
            super().close()

    class Client(actor_main.RemotePolicyClient):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            clients.append(self)

    class Planes(ttrain.RemotePlanes):
        def __init__(self, cfg, service, weights):
            super().__init__(cfg, service, weights)
            remote = dataclasses.replace(cfg, num_envs=1, seed=99)

            def act():
                deadline = time.monotonic() + 60.0
                while not (servers and servers[0].serving_stats()["version"]):
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                seen["steps"] = actor_main.run_actor(
                    remote, "127.0.0.1", self.receiver.port,
                    self.weight_server.port, actor_id="policy-0",
                    max_ticks=150, send_timeout=10.0,
                    policy_port=servers[0].port, policy_timeout=5.0)

            seen["thread"] = threading.Thread(target=act, daemon=True)
            seen["thread"].start()

    monkeypatch.setattr(tserver, "PolicyInferenceServer", Server)
    monkeypatch.setattr(actor_main, "RemotePolicyClient", Client)
    monkeypatch.setattr(ttrain, "RemotePlanes", Planes)
    cfg = _cfg(tmp_path, serve=True, serve_policy=True, n_workers=0,
               serve_policy_port=_free_port())
    metrics = ttrain.train(cfg)
    assert not seen["thread"].is_alive() and seen["steps"] == 150
    assert np.isfinite(metrics["critic_loss"])
    (client,) = clients
    st = client.stats()
    assert st["served"] == st["requests"] > 0
    assert st["fallbacks"] == st["timeouts"] == st["torn_rejected"] == 0
    assert st["warmup_fallbacks"] == 0
    stats = servers[0].serving_stats()
    assert stats["adoptions"] >= 1 and stats["responses_ok"] == st["served"]


def _capture_plane(monkeypatch):
    seen = {}
    plane = ttrain.learner_plane

    def capture(*args, **kwargs):
        seen["replicas"], seen["aggregator"] = plane(*args, **kwargs)
        return seen["replicas"], seen["aggregator"]

    monkeypatch.setattr(ttrain, "learner_plane", capture)
    return seen


@pytest.mark.parametrize("sampler", ["scan", "pallas", "host"])
def test_sample_on_ingest_trains_under_each_sampler(tmp_path, monkeypatch,
                                                    sampler):
    from d4pg_tpu_torch.replay.device_sampler import DeviceSampleDealer
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    seen = _capture_plane(monkeypatch)
    cfg = _cfg(tmp_path, platform="cpu", fused_replay="off",
               sample_on_ingest=True, sampler=sampler, n_cycles=3)
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    (rep,) = seen["replicas"]
    agg = seen["aggregator"]
    assert rep.mode == "dealt" and rep.steps_done >= 3 * 6
    service = rep._service
    dealer = service._dealer
    assert isinstance(dealer, DeviceSampleDealer) == (sampler != "host")
    assert isinstance(service.buffer, FusedDeviceReplay) == (
        sampler != "host")
    if sampler != "host":
        assert dealer.arm == sampler
    assert dealer.dealt_blocks >= 5 and dealer.writeback_dropped_stale >= 0
    versions = [v for _g, v in agg.ledger()]
    assert versions == list(range(2, 2 + len(versions)))  # 1 was init
    assert agg.ledger_monotone() and len(versions) == 3


def test_learners_two_train_and_resume(tmp_path, monkeypatch):
    seen = _capture_plane(monkeypatch)
    cfg = _cfg(tmp_path, platform="cpu", replay_storage="host",
               fused_replay="off", learners=2, agg_mode="async")
    metrics = ttrain.train(cfg)
    assert np.isfinite(metrics["critic_loss"])
    reps, agg = seen["replicas"], seen["aggregator"]
    assert [r.mode for r in reps] == ["host", "host"]
    assert all(r.steps_done == 2 * 3 for r in reps)
    assert agg.counters()["applied"] == 4 and agg.ledger_monotone()
    resumed = ttrain.train(dataclasses.replace(cfg, resume=True, n_cycles=1))
    assert np.isfinite(resumed["critic_loss"])
    assert all(r.state.step == 2 * 3 + 3 for r in seen["replicas"])


def test_learner_plane_misuse_raises_as_in_the_reference(tmp_path):
    with pytest.raises(ValueError, match="host-sampled"):
        ttrain.train(_cfg(tmp_path, learners=2))
    with pytest.raises(ValueError, match="p_replay"):
        ttrain.train(_cfg(tmp_path, platform="cpu", fused_replay="off",
                          sample_on_ingest=True, prioritized_replay=False))
    with pytest.raises(ValueError, match="ingest_shards 1"):
        ttrain.train(_cfg(tmp_path, platform="cpu", fused_replay="off",
                          sample_on_ingest=True, sampler="scan",
                          ingest_shards=2))
    with pytest.raises(ValueError, match="fused_replay on"):
        ttrain.train(_cfg(tmp_path, sample_on_ingest=True,
                          sampler="pallas"))
