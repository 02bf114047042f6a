"""Port vs reference: the wire (``core/wire``, ``distributed/transport``,
``distributed/weight_server``'s v1 frames).

The same batch encoded by both packages gives the same bytes: raw v2
frames with and without the count flag, the trace extension and the
generation extension, and npz frames. ``np.savez`` stamps each member
with the wall clock (zip's two-second DOS time), so npz frames are
byte-stable only within one clock reading: those comparisons fix the
clock. Each side decodes the other's frames. The handshake with and
without a secret, and the receiver's refusal of a wrong secret and of an
oversized frame, as in the reference's
``test_transport_rejects_wrong_secret_and_oversized_frames``. The v1
weight frame of a torch actor carried from a JAX state: the keys, their
order, shapes, dtypes and arrays are the reference's, and so are the
frame's bytes with the normalizer statistics in it.
"""

import socket
import struct
import time
from unittest import mock

import jax
import numpy as np
import pytest

from d4pg_tpu.core import wire as jwire
from d4pg_tpu.distributed import transport as jt
from d4pg_tpu.distributed import weight_server as jws
from d4pg_tpu.distributed.weights import WeightStore as JaxStore
from d4pg_tpu.learner import state as jstate
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.core import wire
from d4pg_tpu_torch.distributed import transport as tt
from d4pg_tpu_torch.distributed import weight_server as tws
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.io.from_jax import flax_layout, state_from_jax
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch

pytestmark = pytest.mark.torchport

FIXED_CLOCK = 1.7e9


def _fields(n=8, obs_dim=4, act_dim=2, seed=0):
    rng = np.random.default_rng(seed)
    done = (rng.random(n) < 0.3).astype(np.float32)
    return dict(
        obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        done=done, discount=(0.99 * (1 - done)).astype(np.float32))


def _assert_same(batch, fields):
    for name in TransitionBatch._fields:
        got = np.asarray(getattr(batch, name))
        assert got.dtype == fields[name].dtype, name
        np.testing.assert_array_equal(got, fields[name], err_msg=name)


def test_registry_matches_the_reference():
    for name in dir(jwire):
        if not name.isupper():
            continue
        ours, ref = getattr(wire, name), getattr(jwire, name)
        if isinstance(ref, struct.Struct):
            assert ours.format == ref.format, name
        elif name == "REGISTRY":
            assert {k: vars(v) for k, v in ours.items()} == {
                k: vars(v) for k, v in ref.items()}
        else:
            assert ours == ref, name
    assert wire.ingest_v2_layout(7, 5) == jwire.ingest_v2_layout(7, 5)


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("trace", [None, (0x1234_5678_9ABC, 12.5)])
@pytest.mark.parametrize("generation", [None, 3])
def test_raw_frames_byte_equal_and_cross_decode(count, trace, generation):
    f = _fields(n=7)
    ours = tt.encode_raw("proc-0", TransitionBatch(**f), count, trace=trace,
                         generation=generation)
    ref = jt.encode_raw("proc-0", JaxBatch(**f), count, trace=trace,
                        generation=generation)
    assert ours == ref
    payload = ours[wire.FRAME_HEADER.size:]
    magic, length = wire.FRAME_HEADER.unpack(ours[:wire.FRAME_HEADER.size])
    assert magic == wire.MAGIC_INGEST_V2 and length == len(payload)
    for decode in (tt.decode_raw, jt.decode_raw):
        aid, batch, got_count = decode(payload)
        assert (aid, got_count) == ("proc-0", count)
        _assert_same(batch, f)
    want_meta = jt.raw_frame_meta_ex(payload)
    assert tt.raw_frame_meta_ex(payload) == want_meta
    assert tt.raw_frame_meta(payload) == ("proc-0", 7, count)
    assert want_meta[3] == (None if trace is None else trace)
    assert want_meta[4] == generation
    assert tt.decode_frame(payload, "raw")[0] == "proc-0"


@pytest.mark.parametrize("count", [True, False])
def test_npz_frames_byte_equal_under_one_clock_and_cross_decode(count):
    f = _fields(n=5, obs_dim=6)
    with mock.patch("time.time", lambda: FIXED_CLOCK):
        ours = tt._encode("actor-1", TransitionBatch(**f), count)
        ref = jt._encode("actor-1", JaxBatch(**f), count)
    assert ours == ref
    payload = ours[wire.FRAME_HEADER.size:]
    for decode in (tt._decode, jt._decode):
        aid, batch, got_count = decode(payload)
        assert (aid, got_count) == ("actor-1", count)
        _assert_same(batch, f)
    # a frame without the count member (an older encoder) counts
    assert tt.decode_frame(payload, "npz")[2] == count


def test_raw_decode_refuses_malformed_frames():
    f = _fields(n=3)
    frame = tt.encode_raw("a", TransitionBatch(**f))
    payload = frame[wire.FRAME_HEADER.size:]
    with pytest.raises(tt.ProtocolError, match="truncated"):
        tt.decode_raw(payload[:-4])
    with pytest.raises(ValueError, match="255"):
        tt.encode_raw("x" * 256, TransitionBatch(**f))


def _service():
    return ReplayService(ReplayBuffer(1000, 4, 2, device="cpu"))


def _wait_rows(svc, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while len(svc) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return len(svc)


@pytest.mark.parametrize("secret", [None, "sesame"])
@pytest.mark.parametrize("Sender", [tt.TransitionSender, jt.TransitionSender])
def test_handshake_and_greeting_from_either_sender(secret, Sender):
    """Either package's sender, with and without a secret and the
    generation greeting, lands its frames (npz and raw) in the port's
    receiver; the count flag keeps relabels out of env_steps."""
    svc = _service()
    recv = tt.TransitionReceiver(
        lambda b, aid, count: svc.add(b, actor_id=aid, count_env_steps=count),
        secret=secret, generation=lambda: svc.generation)
    senders = []
    try:
        for codec in ("npz", "raw"):
            s = Sender("127.0.0.1", recv.port, actor_id=f"{codec}-a",
                       secret=secret, codec=codec, expect_generation=True,
                       connect_timeout=5.0, retry_timeout=5.0)
            senders.append(s)
            assert s.generation == 0
            Batch = TransitionBatch if Sender is tt.TransitionSender \
                else JaxBatch
            assert s.send(Batch(**_fields(n=4)))
            assert s.send(Batch(**_fields(n=3, seed=1)),
                          count_env_steps=False)
        assert _wait_rows(svc, 14) == 14
        svc.flush()
        assert svc.env_steps == 8
        assert sorted(svc._heartbeats) == ["npz-a", "raw-a"]
        _assert_same(svc.buffer.gather(np.arange(4)), _fields(n=4))
    finally:
        for s in senders:
            s.close()
        recv.close()
        svc.close()


def test_receiver_refuses_wrong_secret_and_oversized_frames():
    svc = _service()
    recv = tt.TransitionReceiver(
        lambda b, aid, count: svc.add(b, actor_id=aid, count_env_steps=count),
        secret="sesame", max_payload=1 << 20)
    try:
        good = tt.TransitionSender("127.0.0.1", recv.port, actor_id="ok",
                                   secret="sesame", connect_timeout=5.0)
        good.send(TransitionBatch(**_fields(n=4)))
        assert _wait_rows(svc, 4) == 4
        good.close()
        bad = tt.TransitionSender("127.0.0.1", recv.port, actor_id="evil",
                                  secret="wrong", connect_timeout=5.0,
                                  retry_timeout=1.0, max_retries=0)
        try:
            for _ in range(50):
                bad.send(TransitionBatch(**_fields(n=4)))
                time.sleep(0.005)
        except OSError:
            pass  # broken pipe once the server hangs up
        finally:
            bad.close()
        assert len(svc) == 4
        sock = socket.create_connection(("127.0.0.1", recv.port), timeout=5)
        try:
            tt.client_handshake(sock, "sesame")
            sock.sendall(struct.pack("!II", wire.MAGIC_INGEST_V1, 1 << 30))
            time.sleep(0.2)
        finally:
            sock.close()
        assert len(svc) == 4
        deadline = time.monotonic() + 5.0
        while recv.frames_rejected < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert recv.frames_rejected == 1
    finally:
        recv.close()
        svc.close()


def test_sharded_receiver_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 12"):
        tt.TransitionReceiver(lambda *a: None, num_shards=2)
    with pytest.raises(NotImplementedError, match="item 12"):
        tt.TransitionReceiver(lambda *a: None, on_payload=lambda *a: None)


DIMS = dict(obs_dim=4, act_dim=2, v_min=-10.0, v_max=0.0, n_atoms=11,
            hidden=(16, 16))


def carried_actor(seed=0):
    """A JAX learner state and the port's state carried from it."""
    js = jstate.init_state(jstate.D4PGConfig(**DIMS), jax.random.key(seed))
    ts = state_from_jax(tstate.D4PGConfig(**DIMS), jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    return js, ts


def test_v1_weight_flat_keys_are_the_references():
    js, ts = carried_actor()
    ref = jws._flatten(jax.tree_util.tree_map(np.asarray, js.actor_params))
    ours = tws._flatten(ts.actor.state_dict())
    assert list(ours) == list(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    assert list(flax_layout(ts.actor.state_dict())["params"]) == list(
        jax.tree_util.tree_map(np.asarray, js.actor_params)["params"])
    back = tws._unflatten(ours)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jws._unflatten(ref))


@pytest.mark.parametrize("with_norm", [False, True])
def test_v1_weight_frame_bytes_and_norm_round_trip(with_norm):
    js, ts = carried_actor(seed=1)
    norm = None
    if with_norm:
        norm = (np.linspace(-1, 1, 4), np.linspace(0.5, 2, 4), 3.5)
    jstore, store = JaxStore(), WeightStore()
    for _ in range(2):  # version 2
        jstore.publish(js.actor_params, step=40, norm_stats=norm)
        store.publish(ts.actor, step=40, norm_stats=norm)
    jserver, server = jws.WeightServer(jstore), tws.WeightServer(store)
    clients = []
    try:
        with mock.patch("time.time", lambda: FIXED_CLOCK):
            ours, ref = server._legacy_frame(0), jserver._legacy_frame(0)
        assert ours == ref
        assert server._legacy_frame(2) is None
        for srv in (server, jserver):
            client = tws.WeightClient("127.0.0.1", srv.port,
                                      connect_timeout=5.0)
            clients.append(client)
            version, params = client.get_if_newer(0)
            assert version == 2 and client.step == 40
            assert client.get_if_newer(2) is None
            for name, t in ts.actor.state_dict().items():
                np.testing.assert_array_equal(params[name].numpy(),
                                              t.numpy())
            if with_norm:
                mean, std, clip = client.norm_stats
                np.testing.assert_array_equal(mean, norm[0])
                np.testing.assert_array_equal(std, norm[1])
                assert clip == 3.5 and isinstance(clip, float)
            else:
                assert client.norm_stats is None
        # the reference's client adopts the port's frame as its own tree
        jclient = jws.WeightClient("127.0.0.1", server.port,
                                   connect_timeout=5.0)
        clients.append(jclient)
        version, tree = jclient.get_if_newer(0)
        assert version == 2
        for a, b in zip(jax.tree_util.tree_leaves(js.actor_params),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), b)
        if with_norm:
            assert jclient.norm_stats[2] == 3.5
    finally:
        for c in clients:
            c.close()
        server.close()
        jserver.close()


def test_weight_client_refuses_a_wrong_secret():
    store = WeightStore()
    _, ts = carried_actor()
    store.publish(ts.actor, step=1)
    server = tws.WeightServer(store, secret="sesame")
    try:
        good = tws.WeightClient("127.0.0.1", server.port, secret="sesame",
                                connect_timeout=5.0)
        assert good.get_if_newer(0)[0] == 1
        good.close()
        bad = tws.WeightClient("127.0.0.1", server.port, secret="nope",
                               connect_timeout=5.0)
        with pytest.raises(ConnectionError):
            bad.get_if_newer(0)
        bad.close()
    finally:
        server.close()
