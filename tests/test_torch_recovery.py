"""Port vs reference: crash recovery (``d4pg_tpu_torch/io/checkpoint.py``
sidecars, ``ReplayService.snapshot``/``restore``/``kill`` and the
generation fence, ``FusedDeviceReplay.state_dict``/``load_state_dict``,
the dealer's ``clear_rings``, the driver's ``--checkpoint_replay``).

The cases of ``tests/test_recovery.py`` (its service chaos smoke aside,
which needs the fleet harness) re-asserted on the port: the bitwise
snapshot round trip, a snapshot without a buffer refused, a generation
that never rewinds, the TCP fence end to end with current-generation
frames still committing, a legacy sender untouched by the greeting, the
sidecar round trip and its missing, corrupt and bare-pickle cases, and
the learner-only fallback of the driver's loader. Then what only the port
has to show: the fused buffer's snapshot bitwise across a restore (rows,
both trees, generations) and its first chunk after it; sidecars of either
package loading into the other's service with rows, leaves and
``max_priority`` bitwise; a dealt service's restore clearing the rings
before the dealer's resync; ``kill``; and the driver on the CPU writing a
sidecar, resuming from it and holding its rows.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from d4pg_tpu.distributed.replay_service import ReplayService as JaxService
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxFused
from d4pg_tpu.replay.prioritized import PrioritizedReplayBuffer as JaxPER
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.transport import (
    TransitionReceiver,
    TransitionSender,
)
from d4pg_tpu_torch.io.checkpoint import (
    SnapshotCorruptError,
    load_replay_sidecar,
    replay_sidecar_path,
    save_replay_sidecar,
)
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch

pytestmark = pytest.mark.torchport


def _batch(n=8, obs_dim=6, act_dim=2, seed=0):
    rng = np.random.default_rng(seed)
    return TransitionBatch(
        obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        action=rng.standard_normal((n, act_dim)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32),
    )


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _bitwise(x, y) -> bool:
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(_bitwise(x[k], y[k]) for k in x))
    if isinstance(x, (list, tuple)):
        return (isinstance(y, (list, tuple)) and len(x) == len(y)
                and all(_bitwise(a, b) for a, b in zip(x, y)))
    xa, ya = np.asarray(x), np.asarray(y)
    return xa.dtype == ya.dtype and bool(np.array_equal(xa, ya))


def _no_tensor(node) -> bool:
    if isinstance(node, torch.Tensor):
        return False
    if isinstance(node, dict):
        return all(_no_tensor(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return all(_no_tensor(v) for v in node)
    return True


# ------------------------------------------------ snapshot / restore ----

def test_snapshot_restore_roundtrip_bitwise():
    a = ReplayService(ReplayBuffer(1024, 6, 2))
    try:
        for i in range(5):
            a.add(_batch(seed=i), actor_id="rt")
        a.flush()
        snap = a.snapshot()
        a_state = a.replay_state()
        a_steps = a.env_steps
    finally:
        a.close()
    assert snap["env_steps"] == a_steps and a_steps == 40
    assert _no_tensor(snap)

    b = ReplayService(ReplayBuffer(1024, 6, 2))
    try:
        b.restore(snap)
        assert _bitwise(b.replay_state(), a_state)
        assert b.env_steps == a_steps
        assert b.generation > int(snap["generation"])
        b.add(_batch(seed=99), actor_id="rt")
        b.flush()
        assert b.env_steps == a_steps + 8
    finally:
        b.close()


def test_restore_rejects_snapshot_without_buffer():
    svc = ReplayService(ReplayBuffer(256, 6, 2))
    try:
        with pytest.raises(ValueError):
            svc.restore({"schema": 1, "env_steps": 0})
    finally:
        svc.close()


def test_restore_never_rewinds_generation():
    a = ReplayService(ReplayBuffer(256, 6, 2))
    try:
        a.add(_batch(seed=1), actor_id="g")
        a.flush()
        snap = a.snapshot()  # generation 0
    finally:
        a.close()
    b = ReplayService(ReplayBuffer(256, 6, 2), generation=7)
    try:
        b.restore(snap)
        assert b.generation == 7  # max(floor, snap + 1), not 1
    finally:
        b.close()


def _fused_with_priorities(rng, cap=96, gen_tracked=False):
    """A port fused buffer on the CPU with 3 wrapped blocks of rows and
    leaves that differ from the entry priority."""
    buf = FusedDeviceReplay(cap, 6, 2, device="cpu", block_rows=32,
                            gen_tracked=gen_tracked)
    for i in range(4):
        buf.add(_batch(n=30, seed=i))
        buf.drain()
    idx = torch.as_tensor(rng.choice(buf.size, 20, replace=False))
    pri = torch.as_tensor(rng.uniform(0.1, 3.0, 20).astype(np.float32))
    buf.apply_priorities(idx, pri)
    if gen_tracked:
        buf.max_priority = 3.5
    return buf


@pytest.mark.parametrize("gen_tracked", [False, True])
def test_fused_snapshot_restores_rows_trees_and_generations_bitwise(
        rng, gen_tracked):
    a = ReplayService(_fused_with_priorities(rng, gen_tracked=gen_tracked))
    try:
        snap = a.snapshot()
    finally:
        a.close()
    assert _no_tensor(snap)
    src = a.buffer
    b = ReplayService(FusedDeviceReplay(96, 6, 2, device="cpu",
                                        block_rows=32,
                                        gen_tracked=gen_tracked))
    try:
        b.restore(snap)
        dst = b.buffer
        assert (dst.head, dst.size) == (src.head, src.size) == (24, 96)
        for x, y in zip(src.storage, dst.storage):
            assert torch.equal(x[:src.size], y[:src.size])
        for x, y in zip(src.trees[:2], dst.trees[:2]):
            assert torch.equal(x, y)  # every node, not only the leaves
        assert float(dst.trees.max_priority) == float(
            src.max_priority if gen_tracked else src.trees.max_priority)
        if gen_tracked:
            assert dst.max_priority == 3.5
            np.testing.assert_array_equal(dst.generation, 1)
            np.testing.assert_array_equal(dst.gen.numpy(), 1)
            assert dst._next_slot == dst.head
        assert b.generation == 1
    finally:
        b.close()


def test_fused_chunk_after_a_restore_matches_the_continuing_buffer(rng):
    """One fused chunk from the restored buffer and from the buffer it was
    cut from, with the same params and injected uniforms: the same slots,
    metrics and write-back trees, bitwise."""
    from d4pg_tpu_torch.learner.fused import fused_chunk_step
    from d4pg_tpu_torch.learner.state import D4PGConfig, init_state

    src = _fused_with_priorities(rng)
    dst = FusedDeviceReplay(96, 6, 2, device="cpu", block_rows=32)
    dst.restore(src.snapshot())
    config = D4PGConfig(obs_dim=6, act_dim=2, hidden=(16, 16), n_atoms=11,
                        v_min=-5.0, v_max=5.0)
    u = torch.as_tensor(rng.random((3, 8)).astype(np.float32))
    out = []
    for buf in (src, dst):
        state = init_state(config, 0, "cpu")
        trees, metrics = fused_chunk_step(
            config, state, buf.trees, buf.storage, buf.size, k=3,
            batch_size=8, u=u, alpha=buf.alpha)
        out.append((trees, metrics, state))
    (t0, m0, s0), (t1, m1, s1) = out
    for x, y in zip(t0, t1):
        assert torch.equal(x, y)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for p, q in zip(s0.actor.parameters(), s1.actor.parameters()):
        assert torch.equal(p, q)


# ------------------------------------------------- generation fence ----

def test_generation_fence_end_to_end_tcp():
    svc = ReplayService(ReplayBuffer(1024, 6, 2), generation=1)
    recv = TransitionReceiver(
        lambda b, aid, c: None, host="127.0.0.1",
        on_payload=lambda p, shard, codec: svc.add_payload(p, shard, codec),
        generation=0)  # the dead incarnation's greeting
    sender = TransitionSender("127.0.0.1", recv.port, actor_id="stale",
                              codec="raw", expect_generation=True,
                              retry_timeout=5.0)
    try:
        assert sender.send(_batch(seed=3)) is True
        assert sender.generation == 0
        assert _wait_for(
            lambda: svc.ingest_stats()["fenced_frames"] == 1)
        svc.flush()
        stats = svc.ingest_stats()
        assert stats["fenced_frames"] == 1
        assert stats["fenced_rows"] == 8
        assert svc.env_steps == 0
    finally:
        sender.close()
        recv.close()
        svc.close()


def test_current_generation_frames_commit():
    svc = ReplayService(ReplayBuffer(1024, 6, 2), generation=2)
    recv = TransitionReceiver(
        lambda b, aid, c: None, host="127.0.0.1",
        on_payload=lambda p, shard, codec: svc.add_payload(p, shard, codec),
        generation=(lambda: svc.generation))
    sender = TransitionSender("127.0.0.1", recv.port, actor_id="live",
                              codec="raw", expect_generation=True,
                              retry_timeout=5.0)
    try:
        assert sender.send(_batch(seed=4)) is True
        assert sender.generation == 2
        assert _wait_for(lambda: svc.env_steps == 8)
        assert svc.ingest_stats()["fenced_frames"] == 0
    finally:
        sender.close()
        recv.close()
        svc.close()


def test_legacy_sender_unaffected_by_greeting():
    svc = ReplayService(ReplayBuffer(1024, 6, 2), generation=5)
    recv = TransitionReceiver(
        lambda b, aid, c: None, host="127.0.0.1",
        on_payload=lambda p, shard, codec: svc.add_payload(p, shard, codec),
        generation=(lambda: svc.generation))
    sender = TransitionSender("127.0.0.1", recv.port, actor_id="legacy",
                              codec="raw", retry_timeout=5.0)
    try:
        assert sender.send(_batch(seed=5)) is True
        assert _wait_for(lambda: svc.env_steps == 8)
        assert svc.ingest_stats()["fenced_frames"] == 0
    finally:
        sender.close()
        recv.close()
        svc.close()


def test_restored_service_fences_frames_of_the_dead_one():
    """A sender greeted by the service before its crash keeps that
    generation; the service restored from the crashed one's snapshot (one
    generation later) fences its frames, and a sender greeted after the
    restore commits."""
    a = ReplayService(ReplayBuffer(1024, 6, 2))
    a.add(_batch(seed=1), actor_id="x")
    a.flush()
    snap = a.snapshot()
    a.kill()
    b = ReplayService(ReplayBuffer(1024, 6, 2))
    b.restore(snap)
    greeting = [int(snap["generation"])]  # what the dead service said
    recv = TransitionReceiver(
        lambda b_, aid, c: None, host="127.0.0.1",
        on_payload=lambda p, shard, codec: b.add_payload(p, shard, codec),
        generation=lambda: greeting[0])
    old = TransitionSender("127.0.0.1", recv.port, actor_id="old",
                           codec="raw", expect_generation=True,
                           retry_timeout=5.0)
    new = None
    try:
        assert old.send(_batch(seed=2)) is True
        assert old.generation == 0
        assert _wait_for(lambda: b.ingest_stats()["fenced_frames"] == 1)
        greeting[0] = b.generation
        new = TransitionSender("127.0.0.1", recv.port, actor_id="new",
                               codec="raw", expect_generation=True,
                               retry_timeout=5.0)
        assert new.send(_batch(seed=3)) is True
        assert new.generation == 1
        assert _wait_for(lambda: b.env_steps == 16)
        assert b.ingest_stats()["fenced_rows"] == 8
    finally:
        old.close()
        if new is not None:
            new.close()
        recv.close()
        b.close()


# ------------------------------------------------ checkpoint sidecar ----

def _snap_fixture():
    return {"schema": 1, "env_steps": 17,
            "buffer": {"obs": np.arange(12, dtype=np.float32)}}


def test_sidecar_roundtrip(tmp_path):
    run_dir = str(tmp_path)
    save_replay_sidecar(run_dir, 0, 42, _snap_fixture())
    loaded = load_replay_sidecar(run_dir, 0)
    assert loaded is not None
    snap, step = loaded
    assert step == 42
    assert _bitwise(snap, _snap_fixture())


def test_sidecar_missing_returns_none(tmp_path):
    assert load_replay_sidecar(str(tmp_path), 3) is None


def test_sidecar_corrupt_rejected(tmp_path):
    run_dir = str(tmp_path)
    path = save_replay_sidecar(run_dir, 0, 7, _snap_fixture())
    blob = bytearray(open(path, "rb").read())

    torn = bytearray(blob)
    torn[-1] ^= 0xFF
    open(path, "wb").write(bytes(torn))
    with pytest.raises(SnapshotCorruptError):
        load_replay_sidecar(run_dir, 0)

    open(path, "wb").write(bytes(blob[:6]))  # torn mid-header
    with pytest.raises(SnapshotCorruptError):
        load_replay_sidecar(run_dir, 0)

    versioned = bytearray(blob)
    versioned[4] = 250  # unknown format version
    open(path, "wb").write(bytes(versioned))
    with pytest.raises(SnapshotCorruptError):
        load_replay_sidecar(run_dir, 0)


def test_sidecar_legacy_bare_pickle_loads(tmp_path):
    run_dir = str(tmp_path)
    with open(replay_sidecar_path(run_dir, 0), "wb") as f:
        pickle.dump({"step": 9, "snap": _snap_fixture()}, f)
    loaded = load_replay_sidecar(run_dir, 0)
    assert loaded is not None
    snap, step = loaded
    assert step == 9 and _bitwise(snap, _snap_fixture())


def test_sidecar_refuses_torch_tensors(tmp_path):
    with pytest.raises(TypeError, match="torch tensor"):
        save_replay_sidecar(str(tmp_path), 0, 1,
                            {"buffer": {"obs": torch.zeros(3)}})
    assert load_replay_sidecar(str(tmp_path), 0) is None


def test_sidecar_bytes_equal_the_reference_writer(tmp_path):
    from d4pg_tpu.io import checkpoint as jckpt

    for d in ("t", "j"):
        os.makedirs(tmp_path / d)
    a = save_replay_sidecar(str(tmp_path / "t"), 0, 5, _snap_fixture())
    b = jckpt.save_replay_sidecar(str(tmp_path / "j"), 0, 5,
                                  _snap_fixture())
    assert open(a, "rb").read() == open(b, "rb").read()


def test_train_loader_degrades_to_learner_only(tmp_path, capsys):
    from d4pg_tpu_torch.train import _load_host_replay

    run_dir = str(tmp_path)
    path = save_replay_sidecar(run_dir, 0, 7, _snap_fixture())
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    snap, step = _load_host_replay(run_dir, 0, 7)
    assert snap is None and step == -1
    out = capsys.readouterr().out
    assert "corrupt" in out and "learner-only" in out

    save_replay_sidecar(run_dir, 0, 100, _snap_fixture())
    snap, step = _load_host_replay(run_dir, 0, 7)
    assert snap is None and step == -1
    assert "AHEAD" in capsys.readouterr().out

    save_replay_sidecar(run_dir, 0, 5, _snap_fixture())
    snap, step = _load_host_replay(run_dir, 0, 7)
    assert snap is not None and step == 5
    assert "behind the restored state" in capsys.readouterr().out


# ------------------------------------ sidecars across the two packages ----

def _per_pair(rng):
    """The same adds and write-backs into a port and a reference host PER
    buffer (the reference's numpy tree backend)."""
    t = PrioritizedReplayBuffer(128, 6, 2, alpha=0.6, seed=0,
                                backend="numpy")
    j = JaxPER(128, 6, 2, alpha=0.6, seed=0, backend="numpy")
    for i in range(20):
        b = _batch(n=9, seed=i)
        t.add(b)
        j.add(b)
    idx = rng.choice(128, 40, replace=False)
    pri = rng.uniform(0.05, 4.0, 40)
    t.update_priorities(idx, pri)
    j.update_priorities(idx, pri)
    return t, j


def _fused_pair(rng):
    t = FusedDeviceReplay(160, 6, 2, device="cpu", block_rows=64)
    j = JaxFused(160, 6, 2, block_rows=64)
    for i in range(6):
        b = _batch(n=37, seed=i)
        for buf in (t, j):
            buf.add(b)
            buf.drain()
    idx = rng.choice(160, 30, replace=False)
    p = rng.uniform(0.2, 2.0, 30).astype(np.float32)
    t.apply_priorities(torch.as_tensor(idx), torch.as_tensor(p))
    import jax.numpy as jnp

    j.apply_priorities(jnp.asarray(idx, jnp.int32), jnp.asarray(p))
    return t, j


def _same_replay(t_state: dict, j_state: dict) -> None:
    assert (t_state["head"], t_state["size"], t_state["capacity"]) == (
        j_state["head"], j_state["size"], j_state["capacity"])
    for f in TransitionBatch._fields:
        a, b = np.asarray(t_state["rows"][f]), np.asarray(j_state["rows"][f])
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    a = np.asarray(t_state["leaf_priorities"])
    b = np.asarray(j_state["leaf_priorities"])
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert t_state["max_priority"] == j_state["max_priority"]


@pytest.mark.parametrize("kind", ["host", "fused"])
def test_reference_sidecar_loads_into_the_port_and_back(tmp_path, rng, kind):
    """A sidecar the reference's service wrote restores into the port's
    service, and one the port's wrote into the reference's: rows, leaves
    and ``max_priority`` bitwise, the generation one past the cut's."""
    from d4pg_tpu.io import checkpoint as jckpt

    t_buf, j_buf = (_per_pair if kind == "host" else _fused_pair)(rng)
    make_t = (lambda: PrioritizedReplayBuffer(128, 6, 2, backend="numpy")
              if kind == "host" else
              FusedDeviceReplay(160, 6, 2, device="cpu", block_rows=64))
    make_j = (lambda: JaxPER(128, 6, 2, backend="numpy") if kind == "host"
              else JaxFused(160, 6, 2, block_rows=64))
    for d in ("t", "j"):
        os.makedirs(tmp_path / d)
    t_svc, j_svc = ReplayService(t_buf), JaxService(j_buf)
    try:
        _same_replay(t_svc.replay_state(), j_svc.replay_state())
        jckpt.save_replay_sidecar(str(tmp_path / "j"), 0, 40,
                                  j_svc.snapshot())
        save_replay_sidecar(str(tmp_path / "t"), 0, 40, t_svc.snapshot())
        want = t_svc.replay_state()
    finally:
        t_svc.close()
        j_svc.close()

    snap, step = load_replay_sidecar(str(tmp_path / "j"), 0)
    assert step == 40
    port = ReplayService(make_t())
    try:
        port.restore(snap)
        _same_replay(port.replay_state(), want)
        assert port.generation == 1
    finally:
        port.close()

    snap, step = jckpt.load_replay_sidecar(str(tmp_path / "t"), 0)
    assert step == 40
    ref = JaxService(make_j())
    try:
        ref.restore(snap)
        _same_replay(want, ref.replay_state())
        assert ref.generation == 1
    finally:
        ref.close()


# ----------------------------------------- the dealt plane on restore ----

def test_dealt_restore_clears_rings_before_resync(rng):
    """A restore of a service with a device dealer attached drops the
    blocks dealt before it and only then re-derives the dealer's state
    from the restored buffer; the dealer then deals against the new
    generation epoch."""
    from d4pg_tpu_torch.replay.device_sampler import DeviceSampleDealer
    from d4pg_tpu_torch.replay.staging import DealtBlockRing

    ring = DealtBlockRing(4)
    dealer = DeviceSampleDealer(256, [ring], k=2, batch_size=8, seed=0,
                                arm="scan")
    buf = FusedDeviceReplay(256, 6, 2, device="cpu", block_rows=64,
                            gen_tracked=True)
    svc = ReplayService(buf)
    svc.attach_dealer(dealer)
    calls = []
    clear, resync = dealer.clear_rings, dealer.resync
    try:
        for i in range(4):
            svc.add(_batch(n=16, seed=i), actor_id="d")
        svc.flush()
        assert _wait_for(lambda: ring.depth() > 0), "nothing was dealt"
        dealer.pause_dealing()
        snap = svc.snapshot()
        depth = ring.depth()
        dealer.clear_rings = lambda: calls.append("clear") or clear()
        dealer.resync = lambda b: calls.append("resync") or resync(b)
        svc.restore(snap)
        assert depth > 0
        assert calls == ["clear", "resync"]
        assert ring.depth() == 0
        np.testing.assert_array_equal(dealer._gen[:buf.size], 1)
        assert svc.generation == 1
        dealer.resume_dealing()
        assert _wait_for(lambda: ring.depth() > 0)
        blk = ring.pop(timeout=5.0)
        assert (blk.gen.numpy() == 1).all()  # the new epoch's generations
    finally:
        svc.close()


def test_host_dealer_restore_clears_rings(rng):
    from d4pg_tpu_torch.replay.sampler import SampleDealer
    from d4pg_tpu_torch.replay.staging import DealtBlockRing

    ring = DealtBlockRing(4)
    dealer = SampleDealer(256, [ring], n_shards=1, k=2, batch_size=8,
                          seed=0)
    svc = ReplayService(PrioritizedReplayBuffer(256, 6, 2, backend="numpy"))
    svc.attach_dealer(dealer)
    try:
        for i in range(4):
            svc.add(_batch(n=16, seed=i), actor_id="d")
        svc.flush()
        assert _wait_for(lambda: ring.depth() > 0)
        dealer.pause_dealing()
        snap = svc.snapshot()
        svc.restore(snap)
        assert ring.depth() == 0
        assert dealer.sampler_stats()["size"] == 64
    finally:
        svc.close()


def test_kill_stops_without_a_flush_and_wakes_a_blocked_pop():
    from d4pg_tpu_torch.replay.sampler import SampleDealer
    from d4pg_tpu_torch.replay.staging import DealtBlockRing

    ring = DealtBlockRing(4)
    dealer = SampleDealer(64, [ring], n_shards=1, k=1, batch_size=4,
                          min_size=10_000, seed=0)
    svc = ReplayService(PrioritizedReplayBuffer(64, 6, 2, backend="numpy"))
    svc.attach_dealer(dealer)
    got = []
    t = threading.Thread(target=lambda: got.append(ring.pop()))
    t.start()
    svc.kill()
    t.join(timeout=5.0)
    assert not t.is_alive() and got == [None]
    assert not svc._commit_thread.is_alive()
    svc.kill()  # twice is safe


# ------------------------------------------------------ the driver ----

def test_checkpoint_replay_trains_resumes_and_holds_the_sidecar_rows(
        tmp_path, monkeypatch):
    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig

    argv = ["--platform", "cpu", "--env", "point", "--n_eps", "1",
            "--log_dir", str(tmp_path), "--replay_storage", "device",
            "--fused_replay", "on", "--rmsize", "8192",
            "--checkpoint_replay", "1", "--checkpoint_replay_every", "1",
            "--max_steps", "50", "--train_steps_per_cycle", "8",
            "--updates_per_dispatch", "4", "--bsize", "16",
            "--warmup", "200", "--eval_trials", "1"]
    driver.main(argv + ["--n_cycles", "2"])
    run_dir = tmp_path / ExperimentConfig(env="point").run_name()
    snap, step = load_replay_sidecar(str(run_dir), 0)
    assert step == 16 and snap["buffer"]["size"] > 0
    assert _no_tensor(snap)

    held = {}
    restore = driver._restore_replay

    def restoring(service, snap_, env_steps):
        restore(service, snap_, env_steps)
        held["state"] = service.replay_state()
        held["generation"] = service.generation

    monkeypatch.setattr(driver, "_restore_replay", restoring)
    result = driver.main(argv + ["--n_cycles", "1", "--resume", "1"])
    assert np.isfinite(result["critic_loss"])
    assert held["generation"] == snap["generation"] + 1 == 1
    _same_replay(held["state"], snap["buffer"])

    # one byte flipped: the learner resumes alone, and says so
    path = replay_sidecar_path(str(run_dir), 0)
    blob = bytearray(open(path, "rb").read())
    blob[-5] ^= 0x01
    open(path, "wb").write(bytes(blob))
    held.clear()
    driver.main(argv + ["--n_cycles", "1", "--resume", "1"])
    assert held == {}
