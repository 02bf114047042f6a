"""Port vs reference: the training driver (``d4pg_tpu_torch.train``).

The config surface (same flags, fields and run names as the JAX
parser), tiny end-to-end runs on ``--platform cpu --replay_storage device
--fused_replay on`` (PER and uniform with async actors), bitwise
determinism of two same-seed runs, checkpoint round trip and exact
resume, one cycle for each flag value the host replay path and the obs
plane made trainable (and the default flags on the CPU, which take the
host path), the refusal of every flag value that still selects an
unported path, and whole-slice parity on both paths: with the same
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
    (dict(her=True), "item 11"),
    (dict(env="fake-goal"), "item 11"),
    (dict(normalize_obs=True), "item 11"),
    (dict(env="pixel-point"), "item 9"),
    (dict(env="dmc:cheetah-run"), "item 9"),
    (dict(env="cheetah-run-pixels"), "item 9"),
    (dict(frame_stack=3), "item 9"),
    (dict(augment="shift"), "item 9"),
    (dict(share_encoder=True), "item 9"),
    (dict(critic_family="mog"), "item 10"),
    (dict(compute_dtype="bfloat16"), "item 3"),
    (dict(learners=2), "item 15"),
    (dict(sample_on_ingest=True), "item 14"),
    (dict(data_parallel=2), "item 16"),
    (dict(coordinator="localhost:9999"), "item 16"),
    (dict(num_processes=2), "item 16"),
    (dict(serve=True), "item 12"),
    (dict(serve_policy=True), "item 13"),
    (dict(actor_procs=1), "item 12"),
    (dict(autoscale=True), "item 17"),
    (dict(ingest_shards=2), "item 12"),
    (dict(checkpoint_replay=True), "item 17"),
]


@pytest.mark.parametrize("kw,item", UNPORTED,
                         ids=[",".join(k) + "=" + str(list(k.values())[0])
                              for k, _ in UNPORTED])
def test_unported_flag_values_raise(tmp_path, kw, item):
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        ttrain.train(_cfg(tmp_path, **kw))
    assert item in str(err.value)
    assert not list(Path(tmp_path).rglob("*.pt"))


@pytest.mark.parametrize("platform", ["auto", "accel"])
def test_platform_without_a_card_raises(tmp_path, monkeypatch, platform):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.train(_cfg(tmp_path, platform=platform))
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(TINY_ARGV[:-6] + ["--platform", platform,
                                       "--log_dir", str(tmp_path)])


def test_gymnasium_envs_build_through_make_env_fn():
    cfg = ExperimentConfig(env="Pendulum-v1").resolve()
    assert ttrain.infer_dims(cfg) == (3, 1)
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.make_env_fn(ExperimentConfig(env="NoSuchEnv-v0"), 0)()


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
