"""Port vs reference: ranks in separate processes form one rank mesh.

The reference's five ``tests/test_multihost.py`` cases on the port, with
two gloo CPU ranks started as real processes (``--coordinator
127.0.0.1:P --num_processes 2 --process_id i``): the scripted check with
and without the fused replay plane (tier 1), and the driver's full runs
and resumes (``slow``, as the reference's are: each launches two driver
processes twice). Besides: ``--data_parallel 2`` through the driver's
CLI on the CPU (the counterpart of the reference's tier-1
``test_train_sharded_fused_end_to_end``), ``SyncedRunningMeanStd`` over
two ranks against one estimator and against the reference's synced
estimator, and the global batch of each path (the host-sampled path's
W * B rows against the sharded fused chunk's B).

Every process is joined with a timeout: a hang fails its test.
"""

import os
import re
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks
from d4pg_tpu.envs import normalizer as jnorm
from d4pg_tpu_torch import train as ttrain
from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.envs.normalizer import (RunningMeanStd,
                                            SyncedRunningMeanStd)
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.learner.update import multi_update_step
from d4pg_tpu_torch.parallel import RankMesh, spawn_local
from d4pg_tpu_torch.parallel.multihost import free_port

pytestmark = pytest.mark.torchport

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
TRAIN_TIMEOUT_S = 300


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _launch(module: str, args: list[str], timeout: float = TIMEOUT_S):
    """Both ranks of ``python -m module args --process_id i``; returns
    their outputs, failing on a non-zero exit or a hang."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args,
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(i)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _oks(outs):
    return [line for out in outs for line in out.splitlines()
            if line.startswith("multihost_check OK")]


def test_two_processes_form_one_mesh():
    outs = _launch("d4pg_tpu_torch.parallel.multihost_check",
                   ["--device", "cpu"])
    oks = _oks(outs)
    assert len(oks) == 2
    assert "mesh 2 shards" in oks[0] and "backend gloo" in oks[0]
    # replicas agree: both ranks report identical losses
    assert oks[0].split("losses")[1] == oks[1].split("losses")[1]


def test_two_processes_fused_replay_plane():
    """Each rank fills its own shard, both run the sharded fused chunk,
    and the shard-set round-trips; losses equal, replicas bitwise (the
    check all-reduces their parameter CRC's max and min)."""
    outs = _launch("d4pg_tpu_torch.parallel.multihost_check",
                   ["--device", "cpu", "--fused", "1"])
    oks = _oks(outs)
    assert len(oks) == 2
    assert oks[0].split("losses")[1] == oks[1].split("losses")[1]
    crcs = {re.search(r'"crc": (\d+)', out).group(1) for out in outs}
    assert len(crcs) == 1


BASE = ["--env", "point", "--max_steps", "20", "--num_envs", "2",
        "--warmup", "100", "--n_eps", "1", "--n_cycles", "2",
        "--episodes_per_cycle", "1", "--eval_trials", "1",
        "--bsize", "16", "--rmsize", "2000", "--n_atoms", "11",
        "--v_min", "-5.0", "--v_max", "0.0", "--platform", "cpu"]


@pytest.mark.slow
def test_two_process_full_train(tmp_path):
    """The driver across two processes on the host-sampled path (PER
    chunks through ``ChunkPipeline`` with each rank's block of the
    global chunk, the single-step remainder, per-cycle checkpoints): rank
    0 alone owns io and eval."""
    outs = _launch("d4pg_tpu_torch.train", BASE + [
        "--train_steps_per_cycle", "18", "--updates_per_dispatch", "8",
        "--log_dir", str(tmp_path)], TRAIN_TIMEOUT_S)
    assert all("final:" in out for out in outs)
    assert "avg_test_reward" in outs[0]
    assert "avg_test_reward" not in outs[1]


def _final_loss(out: str) -> str:
    return out.rsplit("final:", 1)[1].split("critic_loss': ")[1].split(
        ",")[0]


@pytest.mark.slow
def test_two_process_fused_full_train_and_resume(tmp_path):
    """The driver with fused replay across two processes, per-cycle
    checkpoints with per-rank sidecars, then a resume where both ranks
    restore their own shard-set."""
    base = BASE + ["--train_steps_per_cycle", "18",
                   "--updates_per_dispatch", "8", "--replay_storage",
                   "device", "--fused_replay", "on", "--checkpoint_replay",
                   "1", "--checkpoint_replay_every", "1", "--log_dir",
                   str(tmp_path)]
    outs = _launch("d4pg_tpu_torch.train", base, TRAIN_TIMEOUT_S)
    assert _final_loss(outs[0]) == _final_loss(outs[1])
    run = [d for d in os.listdir(tmp_path) if d.startswith("exp_")]
    assert len(run) == 1
    for r in range(2):
        assert (tmp_path / run[0] / f"replay_p{r}.pkl").exists()
    outs = _launch("d4pg_tpu_torch.train", base + ["--resume", "1"],
                   TRAIN_TIMEOUT_S)
    for i, out in enumerate(outs):
        assert f"[p{i}] resumed from step 36" in out, out[-3000:]
    rows = [int(re.search(r"(\d+) replay rows", out).group(1))
            for out in outs]
    assert all(r > 0 for r in rows), rows


@pytest.mark.slow
def test_two_process_resume_with_normalize(tmp_path):
    """Synced observation normalization and per-cycle sidecars; the
    resume restores the broadcast state, each rank's own replay and the
    shared statistics."""
    base = BASE + ["--train_steps_per_cycle", "8", "--updates_per_dispatch",
                   "4", "--normalize_obs", "1", "--checkpoint_replay", "1",
                   "--checkpoint_replay_every", "1", "--log_dir",
                   str(tmp_path)]
    _launch("d4pg_tpu_torch.train", base, TRAIN_TIMEOUT_S)
    run = [d for d in os.listdir(tmp_path) if d.startswith("exp_")]
    assert (tmp_path / run[0] / "replay_p1.pkl").exists()
    outs = _launch("d4pg_tpu_torch.train", base + ["--resume", "1"],
                   TRAIN_TIMEOUT_S)
    for i, out in enumerate(outs):
        assert f"[p{i}] resumed from step 16" in out, out[-3000:]
    rows = [int(re.search(r"(\d+) replay rows", out).group(1))
            for out in outs]
    assert all(r > 0 for r in rows), rows


def test_data_parallel_two_trains_the_sharded_fused_path(tmp_path, capfd):
    """``python -m d4pg_tpu_torch.train --platform cpu --data_parallel 2
    --fused_replay on``: two spawned ranks, each with its shard of the
    fused plane, the backend named in each rank's banner."""
    result = ttrain.main(BASE + [
        "--train_steps_per_cycle", "12", "--updates_per_dispatch", "8",
        "--replay_storage", "device", "--fused_replay", "on",
        "--data_parallel", "2", "--log_dir", str(tmp_path), "--debug", "1"])
    assert np.isfinite(result["critic_loss"])
    out = capfd.readouterr().out
    for r in range(2):
        assert f"data-parallel plane: rank {r}/2 on cpu, shards [{r}, " \
               f"{r + 1}) of 2, backend gloo" in out
    assert out.count("replay storage: device (fused=True) on cpu") == 2


def test_data_parallel_refusals(tmp_path):
    """Device storage without the fused path, and the device-dealt
    samplers, are refused on a mesh, as in the reference."""
    cfg = ExperimentConfig(env="point", data_parallel=2, platform="cpu",
                           log_dir=str(tmp_path))
    cpu, mesh = torch.device("cpu"), RankMesh.local("cpu", 2)
    with pytest.raises(ValueError, match="requires the fused path"):
        ttrain.resolve_storage(replace(cfg, replay_storage="device",
                                       fused_replay="off"), 2, 1, cpu,
                               mesh=mesh)
    with pytest.raises(ValueError, match="mesh/multi-host"):
        ttrain.resolve_dealt_arm(replace(cfg, sample_on_ingest=True,
                                         sampler="scan"), 4, cpu, mesh)
    with pytest.raises(ValueError, match="--coordinator"):
        ttrain.train(replace(cfg, data_parallel=1, num_processes=2))


def test_synced_normalizer_over_two_ranks():
    """Each rank folds its own stream; after ``sync`` both hold bitwise
    the same statistics: those of one estimator merging each rank's
    stream in rank order, and (to float64 rounding) those of one
    estimator fed every batch in rank order."""
    rng = np.random.default_rng(0)
    streams = [[rng.standard_normal((n, 5)) * (r + 1) + r for n in (16, 9)]
               for r in range(2)]
    outs = spawn_local(torch_ranks.synced_normalizer, 2, args=(streams,))
    assert outs[0]["before"]["count"] == 0.0  # nothing global before sync
    merged = RunningMeanStd(5)
    direct = RunningMeanStd(5)
    for stream in streams:
        delta = RunningMeanStd(5)
        for batch in stream:
            delta.update(batch)
            direct.update(batch)
        d = delta.state_dict()
        merged.merge(d["count"], d["mean"], d["m2"])
    for out in outs:
        for key in ("count", "mean", "m2"):
            np.testing.assert_array_equal(out["after"][key],
                                          outs[0]["after"][key])
            np.testing.assert_array_equal(out["after"][key],
                                          merged.state_dict()[key])
            np.testing.assert_allclose(out["after"][key],
                                       direct.state_dict()[key], rtol=1e-12)


def test_synced_normalizer_one_rank_matches_reference(rng):
    """A world of one rank against the reference's one-process synced
    estimator (its ``tests/test_normalizer.py`` case): bitwise, the delta
    empty after ``sync``, a second ``sync`` a no-op."""
    a, b = rng.standard_normal((64, 5)) * 3 + 1, rng.standard_normal((32, 5))
    synced = SyncedRunningMeanStd(5, RankMesh.local("cpu"))
    ref = jnorm.SyncedRunningMeanStd(5)
    for chunk in (a, b):
        synced.update(chunk)
        ref.update(chunk)
    assert synced.stats()[0].max() == 0
    for _ in range(2):
        synced.sync()
        ref.sync()
        for x, y in zip(synced.stats(), ref.stats()):
            np.testing.assert_array_equal(x, y)
    assert synced._delta._count == 0


def test_global_batch_of_each_path():
    """The host-sampled path: every rank samples its own B rows and the
    driver's sharded multi update takes them as they are, so the global
    chunk is W * B: each rank's update sees [K, B] and writes back its
    own [K, B] td rows, and the replicas end where one process ends
    after the same updates on both ranks' rows joined ([K, 2B]), at the
    reference's parameter bars. The sharded fused path: the global batch
    is B, B / W rows a rank."""
    rng = np.random.default_rng(1)
    k, b = 2, 8

    def fields():
        done = np.zeros((k, b), np.float32)
        return dict(
            obs=rng.standard_normal((k, b, 4)).astype(np.float32),
            action=rng.uniform(-1, 1, (k, b, 2)).astype(np.float32),
            reward=rng.standard_normal((k, b)).astype(np.float32),
            next_obs=rng.standard_normal((k, b, 4)).astype(np.float32),
            done=done, discount=(0.99 * (1 - done)).astype(np.float32))

    per_rank = [fields(), fields()]
    config = D4PGConfig(obs_dim=4, act_dim=2, v_min=-5.0, v_max=5.0,
                        n_atoms=11, hidden=(8, 8), projection="einsum")
    outs = spawn_local(torch_ranks.global_batches, 2,
                       args=(config, per_rank, b))
    one = init_state(config, 0, "cpu")
    joined = torch_ranks.batch_of({f: np.concatenate(
        [r[f] for r in per_rank], axis=1) for f in per_rank[0]})
    for _ in range(2):
        multi_update_step(config, one, joined, torch.ones(k, 2 * b))
    want = torch_ranks.params(one)
    for out in outs:
        assert out["pipeline"] == [((k, b, 4), (k, b))] * 2
        assert out["written"] == [(k, b)] * 2
        assert out["fused_td"] == (2, b // 2)
        for m, named in want.items():
            for n, x in named.items():
                np.testing.assert_allclose(out["params"][m][n], x,
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{m}.{n}")
