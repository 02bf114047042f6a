"""Replica -> aggregator update transport: the multi-learner wire plane.

Counterpart of ``d4pg_tpu/distributed/update_plane.py``, in its frames
(``core/wire.py``'s ``update-req`` and ``update-ack`` rows). A learner
replica ships its post-round params, stamped with the basis version it
computed against, its epoch and the store generation it believes live,
to the process that owns the ``learner/aggregator.Aggregator``, and gets
the merge verdict back.

Request (client -> server):

  [u32 0xD4AB][u32 replica][u32 epoch][u32 generation]
  [i64 basis_version][i64 step][i64 trace_id][f64 birth_ts]
  [u8 codec][u32 crc32][u32 len][payload]

payload = ``np.savez`` of the param tree flattened to ``'/'``-joined keys
(nested dicts in their insertion order, as the reference's
``flatten_dict`` walks them) through the weight plane's codecs
(``weight_plane.encode_flat``: raw f32, bf16 or int8). For the same numpy
tree, codec, header fields and clock the frame is the reference's, byte
for byte. Tree leaves may be numpy arrays or torch tensors (a CPU
tensor's array is read without a copy); the server hands the aggregator
CPU tensors, the leaf type of the port's aggregator. The crc32 covers
the payload: a torn frame is counted and shed, never merged.

Fencing reads the header only (``update_frame_meta``): a frame of a
fenced epoch bounces before its payload is checked or decoded, which is
what a replayed in-flight frame of a killed replica meets.

Ack (server -> client):

  [u32 0xD4AB][u8 status][i64 version][i64 lag][f64 weight][u8 clipped]

status: 0 applied, 1 fenced, 2 torn (crc or format), 3 barrier timeout.

Tracing: a sampled submit carries a trace id and its birth in the header;
the server records ``admission`` on receipt and ``decode`` after the
payload, then ends the span: ``commit`` when the merge applies, ``shed``
when fenced or torn, never an orphan.
"""

from __future__ import annotations

import io
import socket
import threading
import time
import zipfile
import zlib

import numpy as np
import torch

from d4pg_tpu_torch.core.wire import (
    MAGIC_UPDATE as _UPD_MAGIC,
    UPDATE_ACK as _UPD_ACK,
    UPDATE_HEADER as _UPD_HDR,
)
from d4pg_tpu_torch.distributed.transport import (
    MAX_PAYLOAD,
    ConnRegistry,
    ProtocolError,
    ReconnectingClient,
    _recv_exact,
    server_handshake,
)
from d4pg_tpu_torch.distributed.weight_plane import decode_flat, encode_flat
from d4pg_tpu_torch.distributed.weight_server import _unflatten
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.trace import RECORDER as TRACE, new_trace_id

STATUS_APPLIED = 0
STATUS_FENCED = 1
STATUS_TORN = 2
STATUS_TIMEOUT = 3
_STATUS_NAMES = {STATUS_APPLIED: "applied", STATUS_FENCED: "fenced",
                 STATUS_TORN: "torn", STATUS_TIMEOUT: "barrier_timeout"}
_STATUS_IDS = {v: k for k, v in _STATUS_NAMES.items()}
CODECS = ("f32", "bf16", "int8")


# ------------------------------------------------------------- codec ----

def _flatten_tree(params: dict) -> dict[str, np.ndarray]:
    """``{'a/b/c': array}`` of a nested dict, in insertion order; torch
    leaves as numpy (a CPU tensor without a copy)."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix: str, node: dict) -> None:
        for key, value in node.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, dict):
                walk(name, value)
            elif isinstance(value, torch.Tensor):
                flat[name] = value.detach().cpu().numpy()
            else:
                flat[name] = np.asarray(value)

    walk("", params)
    return flat


def encode_update(params, *, replica_id: int, epoch: int, generation: int,
                  basis_version: int, step: int = 0, codec: str = "f32",
                  trace_id: int = 0, birth_ts: float | None = None) -> bytes:
    """One wire frame for a replica submission (see the module
    docstring)."""
    flat = encode_flat(_flatten_tree(params), codec)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    payload = buf.getvalue()
    if len(payload) > MAX_PAYLOAD:
        raise ProtocolError(
            f"update payload {len(payload)}B exceeds MAX_PAYLOAD")
    header = _UPD_HDR.pack(
        _UPD_MAGIC, int(replica_id), int(epoch), int(generation),
        int(basis_version), int(step), int(trace_id),
        time.time() if birth_ts is None else float(birth_ts),
        CODECS.index(codec), zlib.crc32(payload), len(payload))
    return header + payload


def update_frame_meta(frame: bytes) -> dict:
    """The header alone: magic, length bound and codec id are checked,
    the crc is not (that would read the whole payload)."""
    if len(frame) < _UPD_HDR.size:
        raise ProtocolError(f"update frame truncated at {len(frame)}B")
    (magic, replica_id, epoch, generation, basis_version, step, trace_id,
     birth_ts, codec_id, crc, length) = _UPD_HDR.unpack_from(frame)
    if magic != _UPD_MAGIC:
        raise ProtocolError(f"bad update magic {magic:#x}")
    if length > MAX_PAYLOAD:
        raise ProtocolError(f"update payload {length}B exceeds MAX_PAYLOAD")
    if codec_id >= len(CODECS):
        raise ProtocolError(f"unknown update codec id {codec_id}")
    return {"replica_id": replica_id, "epoch": epoch,
            "generation": generation, "basis_version": basis_version,
            "step": step, "trace_id": trace_id, "birth_ts": birth_ts,
            "codec": CODECS[codec_id], "crc": crc, "len": length}


def decode_update(frame: bytes) -> tuple[dict, dict]:
    """``(meta, params)``, the params a nested dict of numpy arrays; raises
    ``ProtocolError`` on a torn or corrupt payload."""
    meta = update_frame_meta(frame)
    payload = frame[_UPD_HDR.size:]
    if len(payload) != meta["len"]:
        raise ProtocolError(
            f"update payload torn: {len(payload)}B of {meta['len']}B")
    if zlib.crc32(payload) != meta["crc"]:
        raise ProtocolError("update payload crc mismatch")
    with np.load(io.BytesIO(payload)) as z:
        flat = {k: z[k] for k in z.files}
    return meta, _unflatten(decode_flat(flat))


def _to_tensors(tree):
    """A decoded tree with CPU-tensor leaves (the aggregator's type)."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


# ------------------------------------------------------------- server ----

class AggregatorServer(ConnRegistry):
    """Accepts replica connections and feeds their frames to an
    ``Aggregator``, one thread per connection; each submit is a strict
    request/ack round trip, so a replica cannot run ahead of its own
    unmerged update."""

    def __init__(self, agg, host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None):
        super().__init__()
        self._agg = agg
        self._secret = secret
        self.frames = 0
        self.applied = 0
        self.fenced_header = 0  # fenced on the header, payload unread
        self.fenced_submit = 0  # fenced by the aggregator
        self.barrier_timeouts = 0
        self.torn = 0
        self.bytes_in = 0
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen()
        self.port = self._server.getsockname()[1]
        self._stop = threading.Event()
        self._conn_threads: list[threading.Thread] = []
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    self._server.settimeout(0.2)
                    conn, _ = self._server.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                self._register_conn(conn)
                self._conn_threads = [t for t in self._conn_threads
                                      if t.is_alive()]
                t = threading.Thread(target=self._serve, args=(conn,),
                                     daemon=True)
                self._conn_threads.append(t)
                t.start()
        except Exception as e:  # noqa: BLE001 — counted: the accept loop's top
            contained_crash("updates.accept", e)

    def _handle_frame(self, frame: bytes) -> tuple[int, dict]:
        """``(status id, result)`` for one complete frame (the socket path
        and tests that drive raw bytes)."""
        self.frames += 1
        self.bytes_in += len(frame)
        tid = 0
        try:
            meta = update_frame_meta(frame)
            tid = meta["trace_id"]
            if tid:
                TRACE.begin(tid, meta["birth_ts"])
                TRACE.record_span(tid, "admission")
            live = self._agg.live_epoch(meta["replica_id"])
            if live != meta["epoch"]:
                # a dead epoch bounces off the header, payload unread
                self.fenced_header += 1
                if tid:
                    TRACE.terminal_shed(tid)
                record_event("update_header_fenced",
                             replica=meta["replica_id"],
                             epoch=meta["epoch"], live_epoch=live)
                return STATUS_FENCED, {"version": self._agg.version}
            try:
                meta, params = decode_update(frame)
            except (ProtocolError, ValueError, KeyError, TypeError, OSError,
                    zipfile.BadZipFile):
                # a length or crc tear, or a crc-valid body np.load or the
                # codec cannot read: torn, counted, acked, conn kept
                self.torn += 1
                if tid:
                    TRACE.terminal_shed(tid)
                record_event("update_torn", replica=meta["replica_id"])
                return STATUS_TORN, {"version": self._agg.version}
            if tid:
                TRACE.record_span(tid, "decode")
            result = self._agg.submit(
                meta["replica_id"], meta["epoch"], _to_tensors(params),
                meta["basis_version"], step=meta["step"],
                generation=meta["generation"])
            status = _STATUS_IDS.get(result["status"], STATUS_FENCED)
            if status == STATUS_APPLIED:
                self.applied += 1
                if tid:
                    TRACE.mark_committed([tid])
            elif status == STATUS_TIMEOUT:
                self.barrier_timeouts += 1
                if tid:
                    TRACE.terminal_shed(tid)
            else:
                self.fenced_submit += 1
                if tid:
                    TRACE.terminal_shed(tid)
            return status, result
        except Exception as e:
            # the span opened above ends before the raise escapes
            if tid:
                TRACE.terminal_shed(tid)
            record_event("update_frame_error", error=type(e).__name__)
            raise

    def _serve(self, conn: socket.socket) -> None:
        try:
            self._serve_conn(conn)
        except Exception as e:  # noqa: BLE001 — counted: a conn thread's top
            contained_crash("updates.serve", e)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                if not server_handshake(conn, self._secret):
                    return
                while not self._stop.is_set():
                    head = _recv_exact(conn, _UPD_HDR.size)
                    if head is None:
                        return
                    meta = update_frame_meta(head)
                    payload = _recv_exact(conn, meta["len"])
                    if payload is None:
                        return  # the peer died mid-frame
                    status, result = self._handle_frame(head + payload)
                    lag = result.get("lag")
                    conn.sendall(_UPD_ACK.pack(
                        _UPD_MAGIC, status, int(result.get("version", 0)),
                        -1 if lag is None else int(lag),
                        float(result.get("weight", 0.0)),
                        int(bool(result.get("clipped", False)))))
        except (OSError, ProtocolError):
            return  # a connection fault: drop it, the replica retries
        finally:
            self._unregister_conn(conn)

    def stats(self) -> dict:
        return {"frames": self.frames, "applied": self.applied,
                "fenced_header": self.fenced_header,
                "fenced_submit": self.fenced_submit,
                "barrier_timeouts": self.barrier_timeouts,
                "torn": self.torn, "bytes_in": self.bytes_in}

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        self._shutdown_conns()
        for t in self._conn_threads:
            t.join(timeout=2.0)
        self._conn_threads.clear()


# ------------------------------------------------------------- client ----

class UpdateClient(ReconnectingClient):
    """A replica's submitter: ``submit`` returns the in-process
    ``Aggregator.submit`` verdict's shape, so a ``LearnerReplica`` given
    one (``updates=``) submits over TCP while its registration and basis
    pulls stay with the in-process aggregator. The last encoded frame is
    kept (``last_frame``) so a supervisor can replay a killed replica's
    in-flight bytes."""

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0,
                 secret: str | None = None, codec: str = "f32"):
        if codec not in CODECS:
            raise ValueError(f"unknown update codec {codec!r}")
        self.codec = codec
        self.last_frame: bytes | None = None
        self.acks = 0
        super().__init__(host, port, connect_timeout=connect_timeout,
                         secret=secret)

    def submit(self, replica_id: int, epoch: int, params, basis_version: int,
               step: int = 0, generation: int = 0,
               trace_id: int | None = None) -> dict:
        if trace_id is None:
            trace_id = new_trace_id(replica_id) if TRACE.enabled else 0
        frame = encode_update(
            params, replica_id=replica_id, epoch=epoch,
            generation=generation, basis_version=basis_version, step=step,
            codec=self.codec, trace_id=trace_id)
        self.last_frame = frame
        return self.submit_frame(frame)

    def submit_frame(self, frame: bytes) -> dict:
        """Send raw frame bytes and wait for the ack. A transport fault
        raises ``ConnectionError``; the caller owns the respawn."""
        self._check_open()
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                self._sock.sendall(frame)
                ack = _recv_exact(self._sock, _UPD_ACK.size)
            except OSError as e:
                self._drop_sock()
                raise ConnectionError(f"update submit failed: {e}") from e
            if ack is None:
                self._drop_sock()
                raise ConnectionError("aggregator closed during submit")
        magic, status, version, lag, weight, clipped = _UPD_ACK.unpack(ack)
        if magic != _UPD_MAGIC:
            raise ProtocolError(f"bad ack magic {magic:#x}")
        self.acks += 1
        return {"status": _STATUS_NAMES.get(status, "fenced"),
                "version": version, "lag": None if lag < 0 else lag,
                "weight": weight, "clipped": bool(clipped)}
