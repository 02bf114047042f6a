"""Hostile-frame fuzz across the port's wire planes
(``d4pg_tpu_torch``): the cases of ``tests/test_wire_fuzz.py`` with the
port's modules in place of the reference's. Every decoder that faces a
socket gets seeded torn, truncated or bit-flipped frames and must keep
the same contract: no serving thread dies, every rejection is counted,
and a rejected traced frame sheds its span (0 orphans). Plus the pin of
the declared ``ingest_v2_layout`` offsets against the full decode.

Left out: the reference's case that publishes a bare ``{"w": ...}`` tree
through the v1 weight server. The port's v1 client maps a frame's Flax
tree onto the actor's torch names (``io/from_jax.torch_layout``), and a
bare leaf names no layer; the driver only ever publishes an actor.
"""

import contextlib
import io
import socket
import threading
import time
import types
import zlib

import numpy as np
import pytest

from d4pg_tpu_torch.core import locking, wire
from d4pg_tpu_torch.distributed.transport import (
    ProtocolError,
    TransitionReceiver,
    TransitionSender,
    _recv_exact,
    decode_raw,
    encode_raw,
    raw_frame_meta_ex,
)
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = [pytest.mark.wire, pytest.mark.torchport]


def _batch(n=4, obs_dim=3, act_dim=2, seed=0):
    rng = np.random.default_rng(seed)
    return TransitionBatch(
        obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        action=rng.standard_normal((n, act_dim)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.ones(n, np.float32),
    )


@contextlib.contextmanager
def _crash_trap():
    """Capture unhandled thread exceptions: a dead serve thread is a
    test failure even when the socket side looks fine. The lock plane
    runs in record mode meanwhile; ``violations`` is the count of
    hierarchy violations the body made."""
    trap = types.SimpleNamespace(crashes=[], violations=0)
    orig = threading.excepthook
    threading.excepthook = trap.crashes.append
    try:
        with locking.record_mode():
            before = locking.violation_count()
            try:
                yield trap
            finally:
                trap.violations = locking.violation_count() - before
    finally:
        threading.excepthook = orig


def _fake_server(handler):
    """One-connection TCP server running ``handler(conn)`` on a thread."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen()

    def run():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        with conn:
            try:
                handler(conn)
            except OSError:
                pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv, srv.getsockname()[1], t


# ------------------------------------------------------ ingest plane ----

def test_ingest_receiver_counts_hostile_frames_and_survives():
    """Bad magic, oversize length, and a hostile-but-well-framed body
    are each a COUNTED rejection; a truncated frame (peer death) is a
    clean uncounted drop; the receiver keeps serving afterwards."""
    from d4pg_tpu_torch.obs.registry import REGISTRY

    crashes0 = REGISTRY.counter("threads.contained_crashes").value
    with _crash_trap() as trap:
        received = []
        recv = TransitionReceiver(lambda b, aid, c: received.append(b),
                                  host="127.0.0.1")
        try:
            hostile = [
                # wrong magic, plausible length
                wire.FRAME_HEADER.pack(0xDEAD, 16) + b"\x00" * 16,
                # declared magic, oversize length
                wire.FRAME_HEADER.pack(wire.MAGIC_INGEST_V2,
                                       wire.MAX_PAYLOAD + 1),
                # well-framed v2 body that detonates inside decode_raw
                # (flags=0xFF, aid_len=0xFF -> UnicodeDecodeError)
                wire.FRAME_HEADER.pack(wire.MAGIC_INGEST_V2, 64)
                + b"\xff" * 64,
            ]
            for frame in hostile:
                c = socket.create_connection(("127.0.0.1", recv.port))
                c.sendall(frame)
                c.settimeout(5.0)
                try:
                    assert c.recv(1) == b""  # graceful drop (FIN)
                except ConnectionResetError:
                    pass  # abortive drop (RST on unread bytes): same verdict
                c.close()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and recv.frames_rejected < 3:
                time.sleep(0.02)
            assert recv.frames_rejected == 3

            # truncated mid-frame: peer death, dropped but NOT counted
            c = socket.create_connection(("127.0.0.1", recv.port))
            c.sendall(wire.FRAME_HEADER.pack(wire.MAGIC_INGEST_V2, 100)
                      + b"\x00" * 10)
            c.close()

            # seeded bit-flip storm over a valid frame: whatever the
            # mutation does, no serve thread may die
            rng = np.random.default_rng(1337)
            good = encode_raw("actor-0", _batch())
            for _ in range(16):
                mut = bytearray(good)
                for _ in range(int(rng.integers(1, 6))):
                    mut[int(rng.integers(wire.FRAME_HEADER.size,
                                         len(mut)))] ^= 1 << int(
                        rng.integers(8))
                c = socket.create_connection(("127.0.0.1", recv.port))
                c.sendall(bytes(mut))
                c.close()

            # the plane still serves a fresh, honest sender
            sender = TransitionSender("127.0.0.1", recv.port,
                                      actor_id="ok")
            assert sender.send(_batch()) is True
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not received:
                time.sleep(0.02)
            assert received
            sender.close()
        finally:
            recv.close()
    assert not trap.crashes, trap.crashes
    assert trap.violations == 0
    # hostile frames ride the narrow protocol-error paths; the broad
    # top-frame containment (which would hide a crash from the trap
    # above) must not have fired either
    assert REGISTRY.counter("threads.contained_crashes").value == crashes0


# ------------------------------------------------- weights v1 plane ----

def test_weights_v1_client_rejects_garbage_npz_as_protocol_error():
    """A well-framed response whose body is not an npz must surface as
    ProtocolError with the socket dropped — never an uncontained
    ValueError/BadZipFile through the acting thread."""
    from d4pg_tpu_torch.distributed.weight_server import WeightClient

    def handler(conn):
        if _recv_exact(conn, wire.WEIGHTS_V1_REQ.size) is None:
            return
        garbage = b"\x9f" * 64
        conn.sendall(wire.WEIGHTS_V1_RESP.pack(
            wire.MAGIC_WEIGHTS_V1, len(garbage)) + garbage)
        time.sleep(0.5)

    srv, port, _t = _fake_server(handler)
    try:
        client = WeightClient("127.0.0.1", port, connect_timeout=5.0)
        with pytest.raises(ProtocolError):
            client.get_if_newer(0)
        assert client._sock is None  # socket dropped, not left desynced
        client.close()
    finally:
        srv.close()


# ------------------------------------------------- weights v2 plane ----

def test_weights_v2_crc_valid_garbage_counted_torn_not_crash():
    """crc32 passes (the sender checksummed garbage) but the body is not
    an npz: counted as torn_rejected, get_if_newer degrades to None."""
    from d4pg_tpu_torch.distributed.weight_plane import WeightPlaneClient

    def handler(conn):
        if _recv_exact(conn, wire.WEIGHTS_V2_REQ.size) is None:
            return
        garbage = b"\x9f" * 64
        conn.sendall(wire.WEIGHTS_V2_RESP.pack(
            wire.MAGIC_WEIGHTS_V2, 1, zlib.crc32(garbage), len(garbage))
            + garbage)
        time.sleep(0.5)

    srv, port, _t = _fake_server(handler)
    try:
        client = WeightPlaneClient("127.0.0.1", port, connect_timeout=5.0)
        assert client.get_if_newer() is None  # stale degradation
        assert client.counters["torn_rejected"] == 1
        assert client.counters["accepts"] == 0
        client.close()
    finally:
        srv.close()


def test_weights_v2_torn_crc_counted(tmp_path):
    """The existing crc tear (body does not match header crc) stays a
    counted rejection on the same code path the fuzz exercises."""
    from d4pg_tpu_torch.distributed.weight_plane import WeightPlaneClient

    def handler(conn):
        if _recv_exact(conn, wire.WEIGHTS_V2_REQ.size) is None:
            return
        garbage = b"\x9f" * 64
        conn.sendall(wire.WEIGHTS_V2_RESP.pack(
            wire.MAGIC_WEIGHTS_V2, 1, zlib.crc32(garbage) ^ 0xFFFF,
            len(garbage)) + garbage)
        time.sleep(0.5)

    srv, port, _t = _fake_server(handler)
    try:
        client = WeightPlaneClient("127.0.0.1", port, connect_timeout=5.0)
        assert client.get_if_newer() is None
        assert client.counters["torn_rejected"] == 1
        client.close()
    finally:
        srv.close()


# ---------------------------------------------------- update plane ----

def test_update_server_torn_garbage_acked_counted_conn_alive():
    """A crc-VALID update frame whose payload is not an npz must come
    back as a counted torn ack on a connection that stays usable, with
    the frame's trace span shed (0 orphans)."""
    from d4pg_tpu_torch.distributed.update_plane import (
        AggregatorServer, STATUS_TORN, UpdateClient)
    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.learner.aggregator import Aggregator
    from d4pg_tpu_torch.obs.trace import RECORDER as TRACE

    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((3, 2)).astype(np.float32)}
    agg = Aggregator(WeightStore())
    server = AggregatorServer(agg)
    client = UpdateClient("127.0.0.1", server.port)
    TRACE.enable(sample_rate=1.0)
    try:
        epoch = agg.register(0, params=params)
        payload = b"\x13" * 48  # not an npz; crc below is VALID
        tid = 0xF00D
        frame = wire.UPDATE_HEADER.pack(
            wire.MAGIC_UPDATE, 0, epoch, 0, 0, 0, tid, time.time(), 0,
            zlib.crc32(payload), len(payload)) + payload
        res = client.submit_frame(frame)
        assert res["status"] == "torn"
        assert server.stats()["torn"] == 1
        assert TRACE.orphans() == []  # torn frame shed its span
        # the SAME connection still applies an honest update
        res2 = client.submit(0, epoch, params, agg.basis(0)[0],
                             generation=agg.generation)
        assert res2["status"] == "applied"
        assert server.stats()["applied"] == 1
        assert STATUS_TORN == 2  # wire status id is part of the protocol
    finally:
        TRACE.disable()
        TRACE.reset()
        client.close()
        server.close()
        agg.close()


def test_update_server_hostile_header_drops_conn_without_thread_death():
    from d4pg_tpu_torch.distributed.update_plane import AggregatorServer
    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.learner.aggregator import Aggregator
    from d4pg_tpu_torch.obs.registry import REGISTRY

    crashes0 = REGISTRY.counter("threads.contained_crashes").value
    with _crash_trap() as trap:
        agg = Aggregator(WeightStore())
        server = AggregatorServer(agg)
        try:
            rng = np.random.default_rng(99)
            for _ in range(8):
                c = socket.create_connection(("127.0.0.1", server.port))
                c.sendall(rng.bytes(wire.UPDATE_HEADER.size))
                c.settimeout(5.0)
                assert c.recv(1) == b""  # dropped, not wedged
                c.close()
        finally:
            server.close()
            agg.close()
    assert not trap.crashes, trap.crashes
    assert trap.violations == 0
    # same bar as the ingest fuzz: the broad containment (invisible to
    # the excepthook trap) must not have absorbed a crash either
    assert REGISTRY.counter("threads.contained_crashes").value == crashes0


# --------------------------------------------------- serving plane ----

def test_serving_codec_mutation_fuzz_raises_only_protocol_errors():
    """Seeded byte-flips and truncations over valid request/response
    bodies: every mutation either decodes or raises the serving plane's
    ProtocolError family — nothing else escapes to the caller."""
    from d4pg_tpu_torch.serving import protocol

    rng = np.random.default_rng(0x5EED)
    obs = rng.standard_normal((4, 8)).astype(np.float32)
    req = protocol.encode_request(7, obs, trace=(99, 1.5))
    actions = rng.standard_normal((4, 2)).astype(np.float32)
    rsp = protocol.encode_response(7, protocol.STATUS_OK, 3, 11, actions)
    cases = [(req[protocol.HEADER.size:], protocol.decode_request),
             (rsp[protocol.HEADER.size:], protocol.decode_response)]
    torn = 0
    for body, decode in cases:
        for _ in range(200):
            mut = bytearray(body)
            for _ in range(int(rng.integers(1, 4))):
                mut[int(rng.integers(len(mut)))] ^= 1 << int(
                    rng.integers(8))
            if rng.random() < 0.3:
                mut = mut[:int(rng.integers(len(mut)))]
            try:
                decode(bytes(mut))
            except protocol.TornFrameError:
                torn += 1
            except protocol.ProtocolError:
                pass
    assert torn > 0  # the crc actually caught payload tears


def test_serving_outer_frame_bad_magic_is_protocol_error():
    from d4pg_tpu_torch.serving import protocol

    def handler(conn):
        conn.sendall(wire.FRAME_HEADER.pack(0xBEEF, 4) + b"\x00" * 4)
        time.sleep(0.5)

    srv, port, _t = _fake_server(handler)
    try:
        sock = socket.create_connection(("127.0.0.1", port))
        with pytest.raises(protocol.ProtocolError):
            protocol.read_frame(sock, protocol.MAGIC_RESPONSE, _recv_exact)
        sock.close()
    finally:
        srv.close()


# -------------------------------------------------- recovery plane ----

def test_sidecar_bitflip_rejected(tmp_path):
    from d4pg_tpu_torch.io.checkpoint import (
        SnapshotCorruptError, load_replay_sidecar, save_replay_sidecar)

    path = save_replay_sidecar(str(tmp_path), 0, step=5,
                               snap={"rows": [1, 2, 3]})
    blob = bytearray(open(path, "rb").read())
    blob[wire.SIDECAR_HEAD.size + 3] ^= 0x01  # one bit, payload region
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(SnapshotCorruptError):
        load_replay_sidecar(str(tmp_path), 0)


# -------------------------------------------- registry layout pin ----

@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("trace", [None, (0xABCDEF, 123.25)])
@pytest.mark.parametrize("generation", [None, 42])
def test_header_only_meta_matches_full_decode(count, trace, generation):
    """``raw_frame_meta_ex`` reads the registry-declared offsets; across
    every flag combination it must agree with the full ``decode_raw`` —
    the equality pin that keeps the header-only readers honest."""
    batch = _batch(n=6, seed=3)
    frame = encode_raw("actor-xyz", batch, count, trace=trace,
                       generation=generation)
    payload = frame[wire.FRAME_HEADER.size:]
    aid, n, got_count, got_trace, got_gen = raw_frame_meta_ex(payload)
    full_aid, full_batch, full_count = decode_raw(payload)
    assert aid == full_aid == "actor-xyz"
    assert n == len(full_batch.obs) == 6
    assert got_count == full_count == count
    assert got_trace == trace
    assert got_gen == generation
    for a, b in zip(full_batch, batch):
        assert np.array_equal(a, b)


def test_ingest_v2_layout_matches_running_offsets():
    """The declared layout function IS the running-offset arithmetic the
    original parser hand-rolled — pinned for every flag combination."""
    for flags in range(8):
        for aid_len in (0, 1, 7, 255):
            layout = wire.ingest_v2_layout(flags, aid_len)
            off = wire.RAW_PRE.size
            assert layout["aid"] == off
            off += aid_len
            if flags & wire.F_TRACE:
                assert layout["trace"] == off
                off += wire.RAW_TRACE.size
            else:
                assert layout["trace"] == -1
            if flags & wire.F_GEN:
                assert layout["generation"] == off
                off += wire.RAW_GEN.size
            else:
                assert layout["generation"] == -1
            assert layout["fields"] == off
