"""Port vs reference: the learner update plane
(``d4pg_tpu_torch/distributed/update_plane.py``) and the learner chaos
drill (``d4pg_tpu_torch/fleet/learner_chaos.py``).

Frames byte-equal to the reference's for the same numpy tree under each
codec (the header's clock pinned and the zip members' clock patched);
the cases of ``tests/test_learner_plane.py`` on the wire re-asserted on
the port (the header-only meta, the quantized codecs, a torn payload
detected, the TCP round trip with the zero-decode fence); each package's
``UpdateClient`` against the other's ``AggregatorServer``; replicas
submitting through an ``UpdateClient`` bitwise the same replicas
submitting to the in-process ``Aggregator`` (N = 1, and N = 2 in turns,
where the stale-update blend runs); and the chaos drill's four oracles.
"""

import threading
from unittest import mock

import numpy as np
import pytest
import torch

from d4pg_tpu.distributed import update_plane as jplane
from d4pg_tpu.distributed.weights import WeightStore as JaxStore
from d4pg_tpu.learner.aggregator import Aggregator as JaxAggregator
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.transport import ProtocolError
from d4pg_tpu_torch.distributed.update_plane import (
    AggregatorServer,
    UpdateClient,
    decode_update,
    encode_update,
    update_frame_meta,
)
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.learner.aggregator import Aggregator
from d4pg_tpu_torch.learner.replica import (
    PARAM_FIELDS,
    LearnerReplica,
    replica_state,
)
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
from d4pg_tpu_torch.replay.uniform import TransitionBatch
from torch_lock_modes import debug_mode  # noqa: F401  (a fixture)

pytestmark = pytest.mark.torchport


def _params(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((4, 3))).astype(np.float32),
            "b": (scale * rng.standard_normal(3)).astype(np.float32)}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _nested(rng):
    """A four-field tree of the aggregator's shape, nested two deep."""
    return {f: {"params": {"fc1": {"bias": rng.standard_normal(5).astype(
        np.float32), "kernel": rng.standard_normal((3, 5)).astype(
            np.float32)}, "head": {"bias": rng.standard_normal(2).astype(
                np.float32)}}} for f in PARAM_FIELDS}


# ------------------------------------------------------- frames --------

@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_update_frames_byte_equal_to_the_reference(rng, codec):
    tree = _nested(rng)
    kw = dict(replica_id=3, epoch=2, generation=1, basis_version=17,
              step=40, codec=codec, trace_id=99, birth_ts=1234.5)
    with mock.patch("time.time", lambda: 1.7e9):
        ours = encode_update(tree, **kw)
        theirs = jplane.encode_update(tree, **kw)
        # torch leaves encode as their arrays do
        assert encode_update(_t(tree), **kw) == theirs
    assert ours == theirs
    assert update_frame_meta(ours) == jplane.update_frame_meta(theirs)
    meta, ours_tree = decode_update(theirs)
    _jmeta, theirs_tree = jplane.decode_update(ours)
    for f in PARAM_FIELDS:
        for layer, leaves in tree[f]["params"].items():
            for name in leaves:
                a = ours_tree[f]["params"][layer][name]
                b = np.asarray(theirs_tree[f]["params"][layer][name])
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_update_frame_roundtrip_and_header_only_meta(rng):
    params = _params(rng)
    frame = encode_update(params, replica_id=3, epoch=2, generation=1,
                          basis_version=17, step=40, trace_id=99)
    meta = update_frame_meta(frame)
    assert (meta["replica_id"], meta["epoch"], meta["generation"]) == (3, 2, 1)
    assert (meta["basis_version"], meta["step"]) == (17, 40)
    assert meta["trace_id"] == 99 and meta["codec"] == "f32"
    meta2, decoded = decode_update(frame)
    assert meta2["crc"] == meta["crc"]
    for k in params:
        np.testing.assert_array_equal(decoded[k], params[k])


def test_update_frame_quantized_codecs(rng):
    params = _params(rng)
    for codec, atol in (("bf16", 0.05), ("int8", 0.05)):
        frame = encode_update(params, replica_id=0, epoch=1, generation=0,
                              basis_version=0, codec=codec)
        _meta, decoded = decode_update(frame)
        for k in params:
            assert decoded[k].dtype == np.float32
            np.testing.assert_allclose(decoded[k], params[k], atol=atol)


def test_torn_payload_detected_never_merged(rng):
    frame = bytearray(encode_update(_params(rng), replica_id=0, epoch=1,
                                    generation=0, basis_version=0))
    frame[-1] ^= 0xFF
    with pytest.raises(ProtocolError):
        decode_update(bytes(frame))
    update_frame_meta(bytes(frame))  # the header path does not look


def test_update_plane_tcp_e2e_and_zero_decode_fence(rng):
    agg = Aggregator(WeightStore())
    server = AggregatorServer(agg)
    client = UpdateClient("127.0.0.1", server.port)
    try:
        epoch = agg.register(0, params=_t(_params(rng)))
        sub = _params(rng)
        res = client.submit(0, epoch, sub, agg.basis(0)[0],
                            generation=agg.generation)
        assert res["status"] == "applied" and res["version"] == 1
        assert res["lag"] == 0 and res["weight"] == pytest.approx(1.0)
        _v, cur = agg.current()
        for k in sub:  # adopted whole, as CPU tensors
            assert isinstance(cur[k], torch.Tensor)
            assert np.array_equal(cur[k].numpy(), sub[k])
        torn = bytearray(client.last_frame)
        torn[-1] ^= 0xFF
        assert client.submit_frame(bytes(torn))["status"] == "torn"
        agg.fence_replica(0)
        version_before = agg.version
        replay = client.submit_frame(client.last_frame)
        assert replay["status"] == "fenced"
        assert agg.version == version_before
        stats = server.stats()
        assert stats["fenced_header"] == 1 and stats["torn"] == 1
        assert stats["applied"] == 1
    finally:
        client.close()
        server.close()
        agg.close()


# ------------------------------------------- across the two packages ---

@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_port_client_against_the_reference_server(rng, codec):
    agg = JaxAggregator(JaxStore())
    server = jplane.AggregatorServer(agg)
    client = UpdateClient("127.0.0.1", server.port, codec=codec)
    try:
        epoch = agg.register(0, params=_params(rng))
        sub = _params(rng)
        res = client.submit(0, epoch, _t(sub), agg.basis(0)[0],
                            generation=agg._store.generation)
        assert res["status"] == "applied" and res["version"] == 1
        _meta, want = jplane.decode_update(client.last_frame)
        _v, cur = agg.current()
        for k in sub:
            assert np.array_equal(np.asarray(cur[k]), want[k])
        agg.fence_replica(0)
        assert client.submit_frame(client.last_frame)["status"] == "fenced"
        assert server.stats()["fenced_header"] == 1
    finally:
        client.close()
        server.close()
        agg.close()


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_reference_client_against_the_port_server(rng, codec):
    agg = Aggregator(WeightStore())
    server = AggregatorServer(agg)
    client = jplane.UpdateClient("127.0.0.1", server.port, codec=codec)
    try:
        epoch = agg.register(0, params=_t(_params(rng)))
        res = client.submit(0, epoch, _params(rng), agg.basis(0)[0],
                            generation=agg.generation)
        assert res["status"] == "applied" and res["version"] == 1
        _meta, want = decode_update(client.last_frame)
        _v, cur = agg.current()
        for k in want:
            assert np.array_equal(cur[k].numpy(), want[k])
        # a stale second submission is blended, as in process
        res = client.submit(0, epoch, _params(rng), 0,
                            generation=agg.generation)
        assert res["status"] == "applied" and res["lag"] == 1
        assert res["weight"] == pytest.approx(0.5)
    finally:
        client.close()
        server.close()
        agg.close()


# --------------------------------- replicas: the wire against in process

OBS, ACT = 5, 2
CONFIG = D4PGConfig(obs_dim=OBS, act_dim=ACT, v_min=-10, v_max=10,
                    n_atoms=11, hidden=(16, 16))


def _rows(rng, n):
    return TransitionBatch(
        obs=rng.standard_normal((n, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, OBS)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32))


def _assert_states_equal(a, b):
    for m in ("actor", "critic", "target_actor", "target_critic"):
        for (ka, ta), (kb, tb) in zip(getattr(a, m).state_dict().items(),
                                      getattr(b, m).state_dict().items()):
            assert ka == kb
            assert torch.equal(ta, tb), (m, ka)
    assert a.step == b.step


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_replicas_through_update_client_bitwise_the_in_process_aggregator(
        rng, n_replicas):
    """The same replicas over twin services, one set submitting to the
    in-process aggregator and one through ``UpdateClient``s (f32) to a
    server in front of a second aggregator, rounds in turns: states,
    verdicts and aggregates bitwise (with two replicas each submission
    after the first is one version stale, so the blend runs)."""
    rows = _rows(rng, 160)
    state = init_state(CONFIG, 0, "cpu")
    sides = []
    for wire in (False, True):
        svc = ReplayService(PrioritizedReplayBuffer(256, OBS, ACT, seed=4))
        svc.add(rows)
        svc.flush(timeout=10.0)
        agg = Aggregator(WeightStore())
        server = AggregatorServer(agg) if wire else None
        clients = [UpdateClient("127.0.0.1", server.port) if wire else None
                   for _ in range(n_replicas)]
        sched = SharedBetaSchedule(0.4, 1000)
        reps = [LearnerReplica(i, CONFIG, agg, replica_state(state, i, 0),
                               k=2, batch_size=8, service=svc,
                               beta_schedule=sched, updates=clients[i])
                for i in range(n_replicas)]
        sides.append((svc, agg, server, clients, reps))
    try:
        for _ in range(3):
            for i in range(n_replicas):
                got = [side[4][i].run_round(4) for side in sides]
                assert got[0] == got[1]
                assert got[0]["status"] == "applied"
        for i in range(n_replicas):
            _assert_states_equal(sides[0][4][i].state, sides[1][4][i].state)
        (v0, cur0), (v1, cur1) = (side[1].current() for side in sides)
        assert v0 == v1 == 3 * n_replicas
        for f in PARAM_FIELDS:
            for k, t in cur0[f].items():
                assert torch.equal(t, cur1[f][k]), (f, k)
        assert sides[1][2].stats()["applied"] == 3 * n_replicas
    finally:
        for svc, agg, server, clients, reps in sides:
            for r in reps:
                r.close()
            for c in clients:
                if c is not None:
                    c.close()
            if server is not None:
                server.close()
            agg.close()
            svc.close()


def test_replica_killed_mid_update_is_fenced_over_the_wire(rng):
    svc = ReplayService(PrioritizedReplayBuffer(128, OBS, ACT, seed=0))
    agg = Aggregator(WeightStore())
    server = AggregatorServer(agg)
    client = UpdateClient("127.0.0.1", server.port)
    try:
        svc.add(_rows(rng, 64))
        svc.flush(timeout=10.0)
        rep = LearnerReplica(0, CONFIG, agg, init_state(CONFIG, 0, "cpu"),
                             k=2, batch_size=8, service=svc, updates=client)
        assert rep.run_round(2)["status"] == "applied"
        rep.respawn()  # the dead epoch fenced, a new one registered
        before = agg.version
        probe = UpdateClient("127.0.0.1", server.port)
        assert probe.submit_frame(client.last_frame)["status"] == "fenced"
        probe.close()
        assert agg.version == before
        assert server.stats()["fenced_header"] == 1
        assert rep.run_round(2)["status"] == "applied"
        rep.close()
    finally:
        client.close()
        server.close()
        agg.close()
        svc.close()


# ------------------------------------------------- the chaos drill -----

def test_learner_chaos_smoke():
    from d4pg_tpu_torch.fleet.learner_chaos import (
        LearnerChaosConfig,
        run_learner_chaos,
    )
    from d4pg_tpu_torch.obs.registry import REGISTRY

    crashes0 = REGISTRY.counter("threads.contained_crashes").value
    rep = run_learner_chaos(LearnerChaosConfig(
        n_replicas=2, duration_s=1.5, replica_kills=1, seed=3))
    assert rep["replica_kills"] == 1
    assert REGISTRY.counter("threads.contained_crashes").value == crashes0
    assert rep["replayed_fenced"] == rep["replayed_inflight"] == 1
    assert rep["updates_applied"] > 0 and rep["updates_per_sec"] > 0
    assert rep["torn"]["detected"] == rep["torn"]["injected"]
    assert rep["ledger"]["monotone"] is True
    assert rep["hierarchy_violations"] == 0
    assert rep["trace"]["orphans"] == 0
    assert rep["lane_errors"] == 0


def test_chaos_kill_schedule_matches_the_reference():
    from d4pg_tpu.fleet.learner_chaos import LearnerChaosConfig as JaxCfg
    from d4pg_tpu_torch.fleet.learner_chaos import LearnerChaosConfig

    for seed in (0, 3):
        for kills in (0, 1, 4):
            assert (LearnerChaosConfig(seed=seed).kill_schedule(kills, 1)
                    == JaxCfg(seed=seed).kill_schedule(kills, 1))


def test_violation_counter_counts_an_inversion(debug_mode):
    from d4pg_tpu_torch.core import locking

    before = locking.violation_count()
    low, high = locking.TieredLock("ring"), locking.TieredLock("service")
    errors = []

    def invert():
        with low:
            try:
                with high:
                    pass
            except locking.LockHierarchyError as e:
                errors.append(e)

    t = threading.Thread(target=invert)
    t.start()
    t.join()
    assert len(errors) == 1
    assert locking.violation_count() == before + 1
