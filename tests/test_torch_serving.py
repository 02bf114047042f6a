"""Port vs reference: the serving plane (``d4pg_tpu_torch/serving``).

The frames of both packages byte for byte (requests with and without the
trace extension, responses of every status), each package decoding the
other's; torn (CRC) and bad-magic frames refused; the port's
``PolicyInferenceServer`` batching concurrent lanes into padded buckets
with answers equal to a direct ``act_deterministic`` (atol 1e-6); fenced
(generation, version) adoption; the degradation ladder's rungs, each
counted (no params, a dead server, torn responses); and the packages
across the wire both ways: the reference's ``RemotePolicyClient`` against
the port's server and the port's client against the reference's server,
greedy actions equal to the other package's forward of the same weights
(atol 1e-5), and the two clients acting identically on the same served
actions (the noise comes from the same numpy streams). Every server is
closed in a ``finally``; every thread is joined with a timeout.
"""

import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.distributed.weights import WeightStore as JaxStore
from d4pg_tpu.learner import state as jstate
from d4pg_tpu.learner.update import act_deterministic as j_greedy
from d4pg_tpu.serving import ActorConfig as JaxActorConfig
from d4pg_tpu.serving import PolicyInferenceServer as JaxServer
from d4pg_tpu.serving import RemotePolicyClient as JaxClient
from d4pg_tpu.serving import protocol as jproto
from d4pg_tpu_torch.distributed.transport import _recv_exact
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.io.from_jax import state_from_jax
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.learner.update import act_deterministic
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.serving import (
    ActorConfig,
    PolicyInferenceServer,
    RemotePolicyClient,
    ServingChaos,
)
from d4pg_tpu_torch.serving import protocol

pytestmark = pytest.mark.torchport

NET = dict(obs_dim=4, act_dim=2, v_min=-50.0, v_max=0.0, n_atoms=11,
           hidden=(32, 32))
CFG = tstate.D4PGConfig(**NET)
JCFG = jstate.D4PGConfig(**NET)


def _states(seed: int = 0):
    js = jstate.init_state(JCFG, jax.random.key(seed))
    ts = state_from_jax(CFG, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    return js, ts


def _published_store(seed: int = 0) -> tuple[WeightStore, object]:
    _, ts = _states(seed)
    store = WeightStore()
    store.publish(ts.actor, step=1)
    return store, ts


def _wait_adopted(server, timeout=5.0):
    deadline = time.monotonic() + timeout
    while server.serving_stats()["version"] == 0:
        assert time.monotonic() < deadline, "refresher never adopted"
        time.sleep(0.01)


def _wait_counted(server, responses, timeout=10.0):
    """Wait until the batcher has counted ``responses`` served responses:
    it writes a batch's responses before it counts the batch, so a client
    can hold its answer while the stats still lack it."""
    deadline = time.monotonic() + timeout
    while server.serving_stats()["responses_ok"] < responses:
        assert time.monotonic() < deadline, "the batcher never counted"
        time.sleep(0.01)


def _greedy(ts, obs):
    return act_deterministic(ts.actor, torch.from_numpy(obs)).numpy()


# ------------------------------------------------------ wire protocol --


@pytest.mark.parametrize("trace", [None, (0xABCDEF0123, 12.5)])
def test_request_frames_byte_equal_and_cross_decode(rng, trace):
    obs = rng.standard_normal((5, 4)).astype(np.float32)
    frame = protocol.encode_request(0x123456, obs, trace=trace)
    assert frame == jproto.encode_request(0x123456, obs, trace=trace)
    body = frame[protocol.HEADER.size:]
    for dec in (protocol.decode_request, jproto.decode_request):
        req = dec(body)
        assert req["req_id"] == 0x123456 and req["trace"] == trace
        np.testing.assert_array_equal(req["obs"], obs)


@pytest.mark.parametrize("status", [
    protocol.STATUS_OK, protocol.STATUS_NO_PARAMS,
    protocol.STATUS_BAD_REQUEST, protocol.STATUS_OVERLOAD])
def test_response_frames_byte_equal_and_cross_decode(rng, status):
    acts = (rng.standard_normal((3, 2)).astype(np.float32)
            if status == protocol.STATUS_OK else None)
    frame = protocol.encode_response(7, status, 2, 9, acts)
    assert frame == jproto.encode_response(7, status, 2, 9, acts)
    body = frame[protocol.HEADER.size:]
    for dec in (protocol.decode_response, jproto.decode_response):
        rsp = dec(body)
        assert (rsp["req_id"], rsp["status"], rsp["generation"],
                rsp["version"]) == (7, status, 2, 9)
        if acts is None:
            assert rsp["actions"] is None
        else:
            np.testing.assert_array_equal(rsp["actions"], acts)


def test_torn_and_bad_magic_frames_refused(rng):
    obs = rng.standard_normal((2, 4)).astype(np.float32)
    body = bytearray(protocol.encode_request(3, obs)[protocol.HEADER.size:])
    body[-1] ^= 0xFF
    with pytest.raises(protocol.TornFrameError) as err:
        protocol.decode_request(bytes(body))
    assert err.value.meta == {"req_id": 3}
    rsp = bytearray(protocol.encode_response(
        4, protocol.STATUS_OK, 0, 1, obs[:, :2])[protocol.HEADER.size:])
    rsp[-2] ^= 0x01
    with pytest.raises(protocol.TornFrameError):
        protocol.decode_response(bytes(rsp))
    with pytest.raises(protocol.ProtocolError, match="too short"):
        protocol.decode_request(b"\x00" * 3)
    with pytest.raises(protocol.ProtocolError, match="payload"):
        protocol.decode_request(bytes(body[:-4]))
    for frame, match in (
            (protocol.encode_response(1, protocol.STATUS_NO_PARAMS, 0, 0,
                                      None), "bad serving magic"),
            (protocol.HEADER.pack(protocol.MAGIC_REQUEST,
                                  protocol.MAX_BODY + 1), "exceeds")):
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            with pytest.raises(protocol.ProtocolError, match=match):
                protocol.read_frame(b, protocol.MAGIC_REQUEST, _recv_exact)
        finally:
            a.close()
            b.close()


# --------------------------------------------------- batching server ---


def test_server_batches_match_direct_forward():
    """Four lanes released together: fewer forwards than requests, padded
    buckets, each lane's rows equal to a direct ``act_deterministic``. The
    row budget is the four requests' 18 rows and the window 3 s, so the
    batch closes the moment the fourth request arrives, however the host
    schedules the lanes (a 250 ms window split them on a loaded host), and
    the stats are read once the batcher has counted the batch (it counts
    after it writes the responses)."""
    store, ts = _published_store()
    server = PolicyInferenceServer(CFG, store, batch_window_s=3.0,
                                   max_batch_rows=18)
    clients = [RemotePolicyClient(CFG, ActorConfig(), "127.0.0.1",
                                  server.port, lane_id=i, seed=i,
                                  timeout=5.0)
               for i in range(4)]
    try:
        _wait_adopted(server)
        rng = np.random.default_rng(0)
        obs = [rng.standard_normal((3 + i, 4)).astype(np.float32)
               for i in range(4)]
        got = [None] * 4
        for c in clients:  # connect first: the handshake is not timed
            assert c._ensure_conn() is not None
        release = threading.Barrier(4)

        def lane(i):
            release.wait(timeout=10.0)
            got[i] = clients[i].greedy_actions(obs[i])

        threads = [threading.Thread(target=lane, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
        for i in range(4):
            np.testing.assert_allclose(got[i], _greedy(ts, obs[i]),
                                       rtol=0, atol=1e-6)
        _wait_counted(server, 4)
        stats = server.serving_stats()
        assert stats["rows"] == sum(o.shape[0] for o in obs)
        assert stats["batches"] < stats["requests"]
        assert stats["padded_rows"] > 0  # 18 rows ride a 32-row bucket
        assert 0 < stats["batch_occupancy"]["p50"] <= 1.0
        assert all(c.stats()["served"] == 1 for c in clients)
        assert all(c.stats()["fallbacks"] == 0 for c in clients)
        assert REGISTRY.export()["serving"]["requests"] == 4
    finally:
        for c in clients:
            c.close()
        server.close()
    assert "serving" not in REGISTRY.export()


class _ScriptedStore:
    """``snapshot_ex`` driven by hand (the refresher's fence)."""

    def __init__(self):
        self.snap = {"params": None, "version": 0, "step": 0,
                     "generation": 0, "published_ts": time.monotonic(),
                     "norm_stats": None}

    def set(self, generation, version, params):
        self.snap.update(generation=generation, version=version,
                         params=params)

    def snapshot_ex(self):
        return dict(self.snap)


def test_fenced_adoption_rejects_version_rewind():
    store = _ScriptedStore()
    server = PolicyInferenceServer(CFG, store, refresh_interval_s=3600.0)
    params = _states()[1].actor.state_dict()
    try:
        assert server.refresh_once() is False  # nothing published yet
        store.set(0, 5, params)
        assert server.refresh_once() is True
        store.set(0, 3, params)  # a rewind without a generation bump
        assert server.refresh_once() is False
        s = server.serving_stats()
        assert s["version"] == 5 and s["fenced_rejected"] == 1
        store.set(1, 1, params)  # a generation bump legitimizes it
        assert server.refresh_once() is True
        s = server.serving_stats()
        assert (s["generation"], s["version"]) == (1, 1)
        assert s["adoptions"] == 2
    finally:
        server.close()


def test_row_budget_pops_fifo_and_serves_oversized_alone():
    """The batcher pops pending requests in arrival order up to
    ``max_batch_rows``; a request larger than the budget rides alone."""
    server = PolicyInferenceServer(CFG, WeightStore(), max_batch_rows=8)
    try:
        s = server.serving_stats()
        assert (s["batch_window_s"], s["max_batch_rows"]) == (0.002, 8)
        with server._pserve_cond:
            for i, n in enumerate((3, 4, 5, 20, 1)):
                server._pending.append(
                    (None, {"req_id": i, "obs": np.zeros((n, 4), np.float32),
                            "trace": None}, 0.0))
            popped = [[r[1]["req_id"] for r in server._pop_batch_locked()]
                      for _ in range(4)]
            assert not server._pending
        assert popped == [[0, 1], [2], [3], [4]]
    finally:
        server.close()


# ----------------------------------------------- degradation ladder ----


def test_no_params_server_yields_counted_warmup():
    server = PolicyInferenceServer(CFG, WeightStore(), batch_window_s=0.001)
    client = RemotePolicyClient(CFG, ActorConfig(), "127.0.0.1",
                                server.port, timeout=5.0)
    try:
        acts = client.actions(np.zeros((3, 4), np.float32))
        assert acts.shape == (3, 2) and (np.abs(acts) <= 1.0).all()
        st = client.stats()
        assert st["no_params"] == 1 and st["warmup_fallbacks"] == 1
        assert st["served"] == 0
    finally:
        client.close()
        server.close()


def test_dead_server_falls_back_to_cached_params():
    store, ts = _published_store()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    client = RemotePolicyClient(CFG, ActorConfig(), "127.0.0.1", dead_port,
                                timeout=0.2, connect_timeout=0.2,
                                weights=store)
    try:
        obs = np.ones((2, 4), np.float32)
        t0 = time.monotonic()
        acts = client.actions(obs)
        assert time.monotonic() - t0 < 2.0  # bounded, not a stall
        st = client.stats()
        assert st["fallbacks"] == 1 and st["served"] == 0
        assert (np.abs(acts) <= 1.0).all()
        np.testing.assert_allclose(client.greedy_actions(obs),
                                   _greedy(ts, obs), rtol=0, atol=1e-6)
        assert client.stats()["fallbacks"] == 2
        assert client.version == 1
    finally:
        client.close()


def test_torn_responses_rejected_then_fallback():
    store, _ = _published_store()
    chaos = ServingChaos(torn_response_rate=1.0, seed=2)
    server = PolicyInferenceServer(CFG, store, batch_window_s=0.001,
                                   chaos=chaos)
    client = RemotePolicyClient(CFG, ActorConfig(), "127.0.0.1",
                                server.port, timeout=5.0, weights=store,
                                record_ledger=True)
    try:
        _wait_adopted(server)
        acts = client.actions(np.zeros((2, 4), np.float32))
        assert acts.shape == (2, 2)
        st = client.stats()
        assert st["torn_rejected"] == 1 and st["served"] == 0
        assert st["fallbacks"] == 1
        assert chaos.torn_injected == 1 and len(chaos.torn_req_ids) == 1
        assert client.accepted_req_ids == set()  # nothing torn acted on
        assert server.serving_stats()["torn_injected"] == 1
    finally:
        client.close()
        server.close()


def test_bad_request_fails_the_request_and_keeps_the_connection(rng):
    store, ts = _published_store()
    server = PolicyInferenceServer(CFG, store, batch_window_s=0.001)
    try:
        _wait_adopted(server)
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=5.0) as sock:
            wrong = rng.standard_normal((2, 3)).astype(np.float32)
            sock.sendall(protocol.encode_request(11, wrong))
            rsp = protocol.decode_response(protocol.read_frame(
                sock, protocol.MAGIC_RESPONSE, _recv_exact))
            assert (rsp["req_id"], rsp["status"]) == (
                11, protocol.STATUS_BAD_REQUEST)
            obs = rng.standard_normal((2, 4)).astype(np.float32)
            sock.sendall(protocol.encode_request(12, obs))
            rsp = protocol.decode_response(protocol.read_frame(
                sock, protocol.MAGIC_RESPONSE, _recv_exact))
            assert rsp["status"] == protocol.STATUS_OK
            np.testing.assert_allclose(rsp["actions"], _greedy(ts, obs),
                                       rtol=0, atol=1e-6)
        assert server.serving_stats()["bad_requests"] == 1
    finally:
        server.close()


# ------------------------------------------- across the two packages ----


def test_reference_client_against_port_server(rng):
    """The reference's client acts through the port's server: greedy
    actions equal the reference's forward of the same weights, and the
    reference's and the port's clients with one seed act identically on
    the served actions (the same numpy noise streams)."""
    js, ts = _states(3)
    store = WeightStore()
    store.publish(ts.actor, step=1)
    server = PolicyInferenceServer(CFG, store, batch_window_s=0.001)
    jclient = JaxClient(JCFG, JaxActorConfig(), "127.0.0.1", server.port,
                        seed=5, timeout=5.0)
    tclient = RemotePolicyClient(CFG, ActorConfig(), "127.0.0.1",
                                 server.port, seed=5, timeout=5.0)
    try:
        _wait_adopted(server)
        obs = rng.standard_normal((6, 4)).astype(np.float32)
        want = np.asarray(j_greedy(JCFG, js.actor_params, obs))
        np.testing.assert_allclose(jclient.greedy_actions(obs), want,
                                   rtol=0, atol=1e-5)
        for _ in range(3):
            np.testing.assert_array_equal(jclient.actions(obs),
                                          tclient.actions(obs))
        assert jclient.stats()["served"] == tclient.stats()["served"] + 1
        assert jclient.stats()["fallbacks"] == 0
        assert tclient.stats()["fallbacks"] == 0
        assert (jclient.version, jclient.generation) == (1, 0)
    finally:
        jclient.close()
        tclient.close()
        server.close()


def test_port_client_against_reference_server(rng):
    js, ts = _states(4)
    store = JaxStore()
    store.publish(js.actor_params, step=1, to_host=False)
    server = JaxServer(JCFG, store, batch_window_s=0.001)
    client = RemotePolicyClient(CFG, ActorConfig(), "127.0.0.1",
                                server.port, timeout=5.0)
    try:
        deadline = time.monotonic() + 5.0
        while server.serving_stats()["version"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        obs = rng.standard_normal((5, 4)).astype(np.float32)
        np.testing.assert_allclose(client.greedy_actions(obs),
                                   _greedy(ts, obs), rtol=0, atol=1e-5)
        acts = client.actions(obs)
        assert acts.shape == (5, 2) and (np.abs(acts) <= 1.0).all()
        st = client.stats()
        assert st["served"] == 2 and st["fallbacks"] == 0
        assert st["torn_rejected"] == st["timeouts"] == 0
    finally:
        client.close()
        server.close()
