"""Actor -> learner transition transport over TCP.

Counterpart of ``d4pg_tpu/distributed/transport.py``: the frames are the
reference's, byte for byte (the registry in ``core/wire.py``), so a
torch actor streams to a JAX learner and a JAX actor to a torch learner.

Wire format (length-prefixed frames over TCP):
    [u32 magic][u32 payload_len][payload]
with two payload codecs: npz (``_encode``/``_decode``, the default, a
self-describing ``np.savez`` of the ``TransitionBatch`` plus the actor id
and the count flag) and raw v2 (``encode_raw``/``decode_raw``: a fixed
struct header with the actor id, a flag byte and per-field dtype and
shape, then the C-contiguous columns; ``raw_frame_meta`` reads the actor
id, the row count and the flags from the header alone). The count flag
(bit 0 of the v2 flag byte, the ``count`` member of an npz frame) keeps
synthetic rows (HER relabels) out of the learner's env-step counter.

Hardening, as in the reference: servers bind loopback by default,
payload lengths are capped (``MAX_PAYLOAD``: the u32 length is
peer-controlled), and a shared ``secret`` enables an HMAC-SHA256
challenge-response handshake on connect, optionally followed by the
receiver's generation greeting. ``np.load`` is pickle-free, so payloads
cannot execute code.

Ported: the handshake and greeting, both codecs, ``ReconnectingClient``,
``TransitionSender`` (bounded retry, exponential backoff with seeded
upward jitter, ``drop_on_timeout``), ``CoalescingSender``,
``ConnRegistry`` and ``TransitionReceiver`` at one shard, decoding in the
connection thread. The sharded receiver (``num_shards > 1``, and
``on_payload``, which hands undecoded frames to the service's shard
workers) waits for ROADMAP Queue 1 item 12 and raises.
"""

from __future__ import annotations

import hashlib
import hmac
import io
import os
import socket
import struct
import threading
from typing import Callable, Optional

import numpy as np

# All framing facts (magics, header structs, flag bits, payload cap) come
# from the declared wire registry (core/wire.py).
from d4pg_tpu_torch.core.wire import (
    F_COUNT as _F_COUNT,
    F_GEN as _F_GEN,
    F_TRACE as _F_TRACE,
    FRAME_HEADER as _HEADER,
    GEN_GREETING as _GEN_GREETING,
    MAGIC_GEN_GREETING as _MAGIC_GEN,
    MAGIC_INGEST_V1 as _MAGIC,
    MAGIC_INGEST_V2 as _MAGIC_RAW,
    MAX_PAYLOAD,
    RAW_FIELD_PRE as _RAW_FIELD_PRE,
    RAW_GEN as _RAW_GEN,
    RAW_NFIELDS as _RAW_NFIELDS,
    RAW_PRE as _RAW_PRE,
    RAW_TRACE as _RAW_TRACE,
    ingest_v2_layout as _ingest_v2_layout,
)
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.replay.uniform import TransitionBatch

_NONCE_LEN = 16
_MAC_LEN = 32  # sha256 digest

CODECS = ("npz", "raw")


def _hs_mac(secret: str, nonce: bytes) -> bytes:
    return hmac.new(secret.encode(), nonce, hashlib.sha256).digest()


def server_handshake(conn: socket.socket, secret: Optional[str],
                     timeout: float = 5.0) -> bool:
    """Server side of the connect handshake: send a fresh nonce, require
    HMAC-SHA256(secret, nonce) back. No-op (True) when no secret is set."""
    if not secret:
        return True
    nonce = os.urandom(_NONCE_LEN)
    prev = conn.gettimeout()
    conn.settimeout(timeout)
    try:
        conn.sendall(nonce)
        mac = _recv_exact(conn, _MAC_LEN)
        return mac is not None and hmac.compare_digest(
            mac, _hs_mac(secret, nonce))
    except OSError:
        return False
    finally:
        conn.settimeout(prev)


def client_handshake(sock: socket.socket, secret: Optional[str],
                     timeout: float = 5.0) -> None:
    """Client side: answer the server's nonce challenge."""
    if not secret:
        return
    prev = sock.gettimeout()
    sock.settimeout(timeout)
    try:
        nonce = _recv_exact(sock, _NONCE_LEN)
        if nonce is None:
            raise ConnectionError("server closed during handshake")
        sock.sendall(_hs_mac(secret, nonce))
    finally:
        sock.settimeout(prev)


def _encode(actor_id: str, batch: TransitionBatch,
            count_env_steps: bool = True) -> bytes:
    buf = io.BytesIO()
    np.savez(
        buf,
        actor_id=np.frombuffer(actor_id.encode(), np.uint8),
        obs=batch.obs,
        action=batch.action,
        reward=batch.reward,
        next_obs=batch.next_obs,
        done=batch.done,
        discount=batch.discount,
        # synthetic rows (HER relabels) must not inflate the learner's
        # env-step counter ((1 + her_ratio)x inflation otherwise)
        count=np.uint8(count_env_steps),
    )
    payload = buf.getvalue()
    return _HEADER.pack(_MAGIC, len(payload)) + payload


def _decode(payload: bytes) -> tuple[str, TransitionBatch, bool]:
    with np.load(io.BytesIO(payload)) as z:
        actor_id = z["actor_id"].tobytes().decode()
        batch = TransitionBatch(
            obs=z["obs"], action=z["action"], reward=z["reward"],
            next_obs=z["next_obs"], done=z["done"], discount=z["discount"],
        )
        count = bool(z["count"]) if "count" in z.files else True
    return actor_id, batch, count


# -- v2 raw column codec ---------------------------------------------------
#
# The npz codec pays zipfile member parsing on both ends of every frame.
# The v2 frame is the sharded ingest plane's native format: a fixed struct
# header carrying actor id, row count and per-field (dtype, shape), then
# the raw C-contiguous column bytes back to back. Decode is a header parse
# plus six ``np.frombuffer`` views, and — the part sharding
# needs — ``raw_frame_meta`` reads actor id / row count / count-flag from
# the header WITHOUT touching the columns, so admission can route, shed
# (with exact row accounting) and heartbeat before any decode happens.
#
# Header extension (the wire-to-grad tracing plane, obs/trace):
# the leading byte is a FLAG byte — bit 0 is the count-env-steps flag it
# always carried (old encoders wrote exactly 0 or 1), bit 1 marks an
# optional 16-byte trace extension (u64 trace id + f64 birth timestamp)
# between the actor id and the field table. Frames WITHOUT the extension
# are byte-identical to the original v2 format and decode unchanged
# forever; the extension is readable from the header alone, so sampled
# frames are traceable at zero-decode admission time (a shed frame gets
# its terminal span without ever parsing a column).
#
# Generation extension (the crash-recovery plane): bit 2 marks an
# optional 4-byte u32 service-generation id AFTER the trace extension
# (both optional, fixed order: aid, [trace], [gen], field table). A
# sender learns the serving generation from the receiver's post-handshake
# greeting and stamps it into every frame it ENCODES; a frame encoded
# before a service crash and retried verbatim across the restart still
# carries the pre-crash generation, which is exactly how the restarted
# service fences ambiguous in-flight frames (the reference's
# ReplayService.add_payload; ROADMAP Queue 1 items 12 and 17) instead of risking a double-commit against the restored snapshot.
# Like the trace extension, it is header-only readable and absent bytes
# keep old frames byte-identical forever.

# The structs and flag bits for both extensions are declared once in
# core/wire.py (ingest-v2 row of the registry) and imported above:
# _RAW_PRE "!BB" (flags, len(aid)), _RAW_TRACE "!Qd", _RAW_GEN "!I",
# _F_COUNT/_F_TRACE/_F_GEN bits 0/1/2 of the ingest flag byte.
#
# Post-handshake receiver greeting (_MAGIC_GEN + _GEN_GREETING "!HI"):
# magic + current service generation. Opt-in on BOTH sides (receiver
# configured with a generation source, sender constructed with
# expect_generation=True) so the legacy wire conversation is untouched
# byte for byte.


def encode_raw(actor_id: str, batch: TransitionBatch,
               count_env_steps: bool = True,
               trace: tuple[int, float] | None = None,
               generation: int | None = None) -> bytes:
    aid = actor_id.encode()
    if len(aid) > 255:
        raise ValueError("actor_id longer than 255 bytes")
    flags = ((_F_COUNT if count_env_steps else 0)
             | (_F_TRACE if trace else 0)
             | (_F_GEN if generation is not None else 0))
    head = [_RAW_PRE.pack(flags, len(aid)), aid]
    if trace:
        head.append(_RAW_TRACE.pack(int(trace[0]), float(trace[1])))
    if generation is not None:
        head.append(_RAW_GEN.pack(int(generation) & 0xFFFFFFFF))
    head.append(_RAW_NFIELDS.pack(len(batch)))
    blobs = []
    for v in batch:
        a = np.ascontiguousarray(v)
        ds = a.dtype.str.encode()
        head.append(_RAW_FIELD_PRE.pack(len(ds), a.ndim) + ds
                    + struct.pack(f"!{a.ndim}I", *a.shape))
        blobs.append(a.tobytes())
    payload = b"".join(head) + b"".join(blobs)
    return _HEADER.pack(_MAGIC_RAW, len(payload)) + payload


def _raw_header(payload: bytes):
    """Parse the v2 header: (actor_id, count, [(dtype, shape)], data_off,
    trace, generation) — ``trace`` is ``(trace_id, birth_ts)`` when the
    frame carries the tracing extension, ``generation`` the u32 service
    generation when it carries the recovery extension; else None.

    Extension offsets come from the registry's declared layout
    (``wire.ingest_v2_layout``) rather than a hand-rolled running
    offset, so the header-only readers and the full decoder can never
    drift from the declared frame shape."""
    flags, laid = _RAW_PRE.unpack_from(payload, 0)
    layout = _ingest_v2_layout(flags, laid)
    actor_id = payload[layout["aid"]:layout["aid"] + laid].decode()
    trace = None
    if layout["trace"] >= 0:
        trace = _RAW_TRACE.unpack_from(payload, layout["trace"])
    generation = None
    if layout["generation"] >= 0:
        (generation,) = _RAW_GEN.unpack_from(payload, layout["generation"])
    off = layout["fields"]
    (nf,) = _RAW_NFIELDS.unpack_from(payload, off)
    off += _RAW_NFIELDS.size
    fields = []
    for _ in range(nf):
        lds, ndim = _RAW_FIELD_PRE.unpack_from(payload, off)
        off += _RAW_FIELD_PRE.size
        dtype = np.dtype(payload[off:off + lds].decode())
        off += lds
        shape = struct.unpack_from(f"!{ndim}I", payload, off)
        off += 4 * ndim
        fields.append((dtype, shape))
    return actor_id, bool(flags & _F_COUNT), fields, off, trace, generation


def raw_frame_meta(payload: bytes) -> tuple[str, int, bool]:
    """(actor_id, n_rows, count_env_steps) from the header alone — no
    column bytes touched. The admission-time accounting hook for the
    sharded receiver (shed rows are counted exactly without a decode)."""
    actor_id, n, count, _trace, _gen = raw_frame_meta_ex(payload)
    return actor_id, n, count


def raw_frame_meta_ex(payload: bytes) -> tuple[
        str, int, bool, tuple[int, float] | None, int | None]:
    """``raw_frame_meta`` plus the trace extension ``(trace_id,
    birth_ts)`` and the generation extension (each None when absent) —
    still header-only, so a sampled frame is traceable (and a stale-
    generation frame fence-able, with its terminal span) before any
    column byte is parsed."""
    actor_id, count, fields, _, trace, generation = _raw_header(payload)
    n = int(fields[0][1][0]) if fields and fields[0][1] else 0
    return actor_id, n, count, trace, generation


def decode_raw(payload: bytes) -> tuple[str, TransitionBatch, bool]:
    actor_id, count, fields, off, _trace, _gen = _raw_header(payload)
    if len(fields) != len(TransitionBatch._fields):
        raise ProtocolError(
            f"raw frame carries {len(fields)} fields, expected "
            f"{len(TransitionBatch._fields)}")
    cols = []
    for dtype, shape in fields:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        end = off + n * dtype.itemsize
        if end > len(payload):
            raise ProtocolError("raw frame truncated mid-column")
        # zero-copy read-only views into the payload: every consumer
        # copies rows onward (staging ring / storage write) anyway
        cols.append(np.frombuffer(payload, dtype, n, off).reshape(shape))
        off = end
    return actor_id, TransitionBatch(*cols), count


def decode_frame(payload: bytes, codec: str) -> tuple[str, TransitionBatch, bool]:
    """Decode one payload by codec name ('npz' | 'raw') — the hook the
    sharded ``ReplayService`` workers use for lazy decode."""
    return decode_raw(payload) if codec == "raw" else _decode(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class ProtocolError(ConnectionError):
    """A deterministic wire-format violation (bad magic, oversized frame).
    NOT retried by the reconnecting clients: a corrupt stream is a config/
    version fault that reconnecting cannot heal, so it must surface at the
    first frame rather than masquerade as network downtime."""


class ReconnectingClient:
    """Shared client-side connection management for the DCN plane: one
    socket + handshake, dropped and re-established on transport failure
    (subclasses decide retry policy), with a ``close()`` that is FINAL —
    it interrupts an in-flight retry loop and makes later calls raise
    instead of silently reconnecting."""

    def __init__(self, host: str, port: int,
                 connect_timeout: float = 10.0,
                 secret: Optional[str] = None):
        self._addr = (host, port)
        self._connect_timeout = connect_timeout
        self._secret = secret
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock: socket.socket | None = None
        # the INITIAL connect fails fast: a wrong host/port/secret should
        # surface at startup, not spin in a retry loop
        self._connect()

    def _connect(self) -> None:
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout)
        try:
            client_handshake(sock, self._secret)
            sock.settimeout(None)
        except (OSError, ConnectionError):
            sock.close()
            raise
        if self._stop.is_set():
            # close() ran while we were connecting: finalize the close
            # instead of resurrecting the client (the fd would leak and a
            # frame could be delivered after close)
            sock.close()
            raise ConnectionError(f"{type(self).__name__} is closed")
        self._sock = sock

    def _drop_sock(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _check_open(self) -> None:
        if self._stop.is_set():
            raise ConnectionError(f"{type(self).__name__} is closed")

    def close(self) -> None:
        # no lock: an in-flight retry loop holds it for up to its whole
        # retry window. Setting the stop flag makes that loop exit at its
        # next check; closing the socket out from under a blocked sendall
        # surfaces as OSError there, which the loop translates via
        # _check_open.
        self._stop.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._sock = None


class TransitionSender(ReconnectingClient):
    """Actor-side client: connects to the learner host and streams batches.

    ``send`` survives learner restarts: on a broken pipe it
    reconnects with exponential backoff + full jitter and resends the frame
    — a restarting learner re-attaches the whole fleet instead of stranding
    it (the reference's fleet story is ``mp.Process`` + ``join``; a dead
    parent ends everything). The retry loop is
    BOUNDED twice over: ``retry_timeout`` seconds of wall clock per call
    AND ``max_retries`` reconnect attempts (None = time bound only). What
    happens at the bound is the fleet-degradation policy:

      - ``drop_on_timeout=False`` (default, the training-loop contract):
        raise ``ConnectionError`` — a learner gone past the bound is fatal.
      - ``drop_on_timeout=True`` (the fleet-plane contract): ``send``
        returns **False** and the frame is dropped with a counted metric —
        a 256-actor fleet degrades by losing replay rows (benign), never
        by wedging 256 threads on one dead receiver.

    The backoff jitter is seeded (``backoff_seed``) so fleet runs are
    reproducible; unseeded senders draw fresh entropy, which decorrelates
    a fleet-wide reconnect stampede after a learner restart.

    Delivery semantics are TCP's: the first write after a silent peer
    death can land in the kernel buffer and be lost (no app-level acks by
    design — an ack round-trip per frame would serialize the streaming
    plane), later writes observe the break and the frame in hand — the
    one encoded byte string — is retried verbatim across reconnects, so a
    frame that survives a retry is bitwise the frame that was first
    attempted. Lost-or-duplicated replay rows are both benign for ingest.

    Counters (monotonic over the sender's life, read by the fleet
    harness): ``frames_sent``, ``frames_dropped``, ``retries`` (reconnect
    attempts)."""

    def __init__(self, host: str, port: int, actor_id: str = "remote",
                 connect_timeout: float = 10.0, secret: Optional[str] = None,
                 retry_timeout: float = 300.0,
                 max_retries: Optional[int] = None,
                 drop_on_timeout: bool = False,
                 backoff_base: float = 0.2, backoff_max: float = 5.0,
                 backoff_seed: Optional[int] = None,
                 codec: str = "npz",
                 trace_sample: float = 0.0,
                 expect_generation: bool = False,
                 reconnect_jitter_s: float = 0.0):
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
        self.codec = codec
        self.actor_id = actor_id
        # Crash-recovery plane: when the peer receiver serves a generation
        # greeting, every (re)connect refreshes the id and raw frames are
        # stamped with it at ENCODE time — a frame retried verbatim across
        # a service restart keeps its pre-crash stamp and gets fenced.
        self._expect_generation = bool(expect_generation)
        self.generation = 0
        self._retry_timeout = retry_timeout
        self._max_retries = max_retries
        self._drop_on_timeout = drop_on_timeout
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self._backoff_rng = np.random.default_rng(backoff_seed)
        # Reconnect-storm guard (crash-recovery plane): when > 0, the
        # FIRST retry of a send episode sleeps an extra seeded uniform in
        # [0, reconnect_jitter_s) before reconnecting. A service restart
        # breaks every fleet lane at the same instant; the exponential
        # backoff alone starts every lane at the same backoff_base, so
        # the first wave of reconnects still lands as a storm. A separate
        # rng keeps the pinned backoff stream bit-identical whether or
        # not the guard is armed.
        self._reconnect_jitter_s = float(reconnect_jitter_s)
        self._storm_rng = np.random.default_rng(
            None if backoff_seed is None else backoff_seed + 0x57a9)
        self.storm_jitters = 0
        self.storm_jitter_s: list[float] = []
        # Wire-to-grad tracing (obs/trace): sample this fraction of raw
        # frames and stamp them with a trace id + birth timestamp in the
        # v2 header extension. Seeded alongside the backoff rng so a
        # seeded fleet samples the same frames run to run; npz frames
        # carry no extension, so trace_sample is inert at codec='npz'.
        self._trace_sample = float(trace_sample)
        self._trace_rng = np.random.default_rng(
            None if backoff_seed is None else backoff_seed + 0x7ace)
        self._trace_salt = hash(actor_id) & 0xFFFF
        self.frames_traced = 0
        self.frames_sent = 0
        self.frames_dropped = 0
        self.retries = 0
        super().__init__(host, port, connect_timeout, secret)

    def _connect(self) -> None:
        super()._connect()
        if not self._expect_generation:
            return
        # the greeting rides the fresh socket before any frame: a missing
        # or malformed greeting is a config fault (peer not serving
        # generations), surfaced as ProtocolError — reconnecting can't heal
        sock = self._sock
        sock.settimeout(self._connect_timeout)
        try:
            raw = _recv_exact(sock, _GEN_GREETING.size)
            if raw is None:
                raise ConnectionError("peer closed before generation greeting")
            magic, gen = _GEN_GREETING.unpack(raw)
            if magic != _MAGIC_GEN:
                raise ProtocolError(
                    f"expected generation greeting, got magic {magic:#x}")
            self.generation = int(gen)
        except (OSError, ConnectionError):
            self._drop_sock()
            raise
        finally:
            if self._sock is not None:
                self._sock.settimeout(None)

    def send(self, batch: TransitionBatch, count_env_steps: bool = True,
             timeout: float | None = None) -> bool:
        """Stream one frame; True once it is handed to the kernel, False
        (``drop_on_timeout``) / ``ConnectionError`` (default) when the
        retry budget — ``timeout`` seconds (default ``retry_timeout``)
        or ``max_retries`` reconnect attempts — is exhausted first."""
        import time

        if self.codec == "raw":
            trace = None
            if (self._trace_sample > 0.0
                    and float(self._trace_rng.random()) < self._trace_sample):
                from d4pg_tpu_torch.obs.trace import new_trace_id

                trace = (new_trace_id(self._trace_salt), time.monotonic())
                self.frames_traced += 1
            data = encode_raw(self.actor_id, batch, count_env_steps,
                              trace=trace,
                              generation=(self.generation
                                          if self._expect_generation
                                          else None))
        else:
            data = _encode(self.actor_id, batch, count_env_steps)
        with self._lock:
            self._check_open()
            budget = self._retry_timeout if timeout is None else timeout
            deadline = time.monotonic() + budget
            backoff = self._backoff_base
            attempts = 0
            while True:
                if self._sock is not None:
                    try:
                        self._sock.sendall(data)
                        self.frames_sent += 1
                        return True
                    except OSError:
                        self._drop_sock()
                self._check_open()
                now = time.monotonic()
                if now >= deadline or (self._max_retries is not None
                                       and attempts >= self._max_retries):
                    self.frames_dropped += 1
                    if self._drop_on_timeout:
                        return False
                    raise ConnectionError(
                        f"learner unreachable for {budget:.0f}s "
                        f"({attempts} reconnect attempts) "
                        f"at {self._addr[0]}:{self._addr[1]}")
                # Event.wait doubles as an interruptible sleep: close()
                # wakes the loop immediately. Upward jitter (uniform in
                # [backoff, 1.5*backoff]) de-synchronizes a fleet-wide
                # reconnect stampede; the lower bound stays the plain
                # exponential schedule so the first retry never lands
                # inside a dying peer's teardown window (a just-closed
                # listener can keep completing handshakes into its backlog
                # for a beat — connecting there loses the frame silently).
                extra = 0.0
                if attempts == 0 and self._reconnect_jitter_s > 0.0:
                    # storm guard: only the FIRST attempt of an episode
                    # pays the spread — later attempts are already
                    # de-synchronized by the exponential schedule
                    extra = (float(self._storm_rng.random())
                             * self._reconnect_jitter_s)
                    self.storm_jitters += 1
                    self.storm_jitter_s.append(extra)
                jitter = 1.0 + 0.5 * float(self._backoff_rng.random())
                self._stop.wait(
                    min(backoff * jitter + extra,
                        max(0.0, deadline - now)))
                self._check_open()
                backoff = min(backoff * 2, self._backoff_max)
                attempts += 1
                self.retries += 1
                # flight-recorder breadcrumb (obs/flight): reconnect
                # attempts are exactly the context a receiver-side
                # postmortem wants around a stall or deadlock
                record_event("transport_retry", actor=self.actor_id,
                             attempt=attempts)
                try:
                    self._connect()
                except (OSError, ConnectionError):
                    self._drop_sock()


class CoalescingSender(TransitionSender):
    """Actor-side block coalescing: many small ``send`` calls become ONE
    wire frame per block (the ingest plane's transport stage).

    Per-tick sends dominate the DCN plane's measured ~5,200 rows/s/core
    ceiling with framing + npz header overhead: each frame pays the
    length-prefixed header, the npz directory, and a receiver wakeup for
    a handful of rows. This subclass accumulates rows column-major into
    PREALLOCATED per-field arrays (allocated once from the first batch's
    shapes/dtypes — uint8 pixels stay packed; appends are slice copies,
    no per-row serialization) and flushes one contiguous frame when the
    block fills, when ``flush_interval`` elapses, or when the
    ``count_env_steps`` flag changes (the flag is per-frame on the wire,
    so HER relabels never merge with real env rows).

    Backpressure-aware sizing: the target block grows toward
    ``max_block`` while the previous flush observed TCP backpressure (a
    slow ``sendall`` means the learner is the bottleneck — bigger blocks
    amortize framing exactly when it matters) and decays toward
    ``min_block`` when sends are fast (small blocks keep ingest latency
    low when the plane has headroom).

    Degradation (``drop_on_timeout=True``): a flush whose frame times out
    is DROPPED — the rows are counted in ``dropped_rows`` and the target
    block snaps back to ``min_block`` so the next attempt ships
    sooner-and-smaller instead of letting a stalled receiver grow an
    ever-larger block behind an ever-longer wait. ``delivered_rows``
    counts the complement. This is the fleet-plane sender contract:
    shrink and shed, never block forever.
    """

    def __init__(self, host: str, port: int, actor_id: str = "remote",
                 connect_timeout: float = 10.0, secret: Optional[str] = None,
                 retry_timeout: float = 300.0, min_block: int = 64,
                 max_block: int = 4096, flush_interval: float = 0.25,
                 max_retries: Optional[int] = None,
                 drop_on_timeout: bool = False,
                 backoff_base: float = 0.2, backoff_max: float = 5.0,
                 backoff_seed: Optional[int] = None,
                 codec: str = "npz",
                 trace_sample: float = 0.0,
                 expect_generation: bool = False,
                 reconnect_jitter_s: float = 0.0):
        super().__init__(host, port, actor_id,
                         connect_timeout=connect_timeout, secret=secret,
                         retry_timeout=retry_timeout, max_retries=max_retries,
                         drop_on_timeout=drop_on_timeout,
                         backoff_base=backoff_base, backoff_max=backoff_max,
                         backoff_seed=backoff_seed, codec=codec,
                         trace_sample=trace_sample,
                         expect_generation=expect_generation,
                         reconnect_jitter_s=reconnect_jitter_s)
        self._min_block = max(1, int(min_block))
        self._max_block = max(self._min_block, int(max_block))
        self._target = self._min_block
        self._flush_interval = float(flush_interval)
        self._cols: Optional[list] = None  # per-field [max_block, ...] arrays
        self._fill = 0
        self._count_flag = True
        self._first_row_t = 0.0
        self._block_lock = threading.Lock()
        self.dropped_rows = 0
        self.delivered_rows = 0

    def _ensure_cols(self, batch: TransitionBatch) -> None:
        if self._cols is None:
            self._cols = [
                np.empty((self._max_block, *np.asarray(v).shape[1:]),
                         np.asarray(v).dtype)
                for v in batch
            ]

    def send(self, batch: TransitionBatch, count_env_steps: bool = True,
             timeout: float | None = None) -> bool:
        import time

        n = np.asarray(batch.obs).shape[0]
        if n == 0:
            return True
        ok = True
        with self._block_lock:
            self._ensure_cols(batch)
            if self._fill and count_env_steps != self._count_flag:
                ok = self._flush_locked() and ok  # flags can't share a frame
            self._count_flag = count_env_steps
            done = 0
            while done < n:
                if self._fill == 0:
                    self._first_row_t = time.monotonic()
                take = min(n - done, self._max_block - self._fill)
                for col, v in zip(self._cols, batch):
                    col[self._fill:self._fill + take] = \
                        np.asarray(v)[done:done + take]
                self._fill += take
                done += take
                if (self._fill >= self._target
                        or time.monotonic() - self._first_row_t
                        >= self._flush_interval):
                    ok = self._flush_locked() and ok
        return ok

    def flush(self) -> bool:
        """Ship any partially-filled block now (episode/shutdown
        boundaries). False when the frame was shed on timeout."""
        with self._block_lock:
            return self._flush_locked()

    def _flush_locked(self) -> bool:
        import time

        if not self._fill:
            return True
        frame = TransitionBatch(*[col[:self._fill] for col in self._cols])
        n = self._fill
        self._fill = 0
        t0 = time.monotonic()
        if not super().send(frame, count_env_steps=self._count_flag):
            # timed out under drop_on_timeout: shed the block and snap the
            # target back so the next attempt is small and immediate
            self.dropped_rows += n
            self._target = self._min_block
            return False
        self.delivered_rows += n
        dt = time.monotonic() - t0
        # > 2ms/KRow on the wire = kernel buffers pushing back: grow the
        # block so framing amortizes; fast sends decay toward min_block
        if dt > 0.002 * max(1.0, n / 1000.0):
            self._target = min(self._target * 2, self._max_block)
        else:
            self._target = max(self._target // 2, self._min_block)
        return True

    def close(self) -> None:
        try:
            self.flush()
        except (ConnectionError, OSError):
            pass  # peer already gone; pending rows are benign to lose
        super().close()


class ConnRegistry:
    """Tracking + teardown of a server's live peer connections, shared by
    ``TransitionReceiver`` and ``WeightServer``: a closed service must
    stop serving (clients observe the break and fail over to the
    replacement service), not just stop accepting."""

    def __init__(self):
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()

    def _register_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.add(conn)

    def _unregister_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.discard(conn)

    def _shutdown_conns(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class TransitionReceiver(ConnRegistry):
    """Learner-side server: accepts actor connections, decodes frames in
    the connection thread, and forwards batches into a callback (normally
    ``ReplayService.add``), which receives ``(batch, actor_id,
    count_env_steps)``. ``generation`` (an int or a zero-argument
    callable) turns on the greeting after the handshake. A frame with an
    unknown magic or over ``max_payload``, or one that does not decode,
    drops its connection and counts in ``frames_rejected``.

    The sharded plane (``num_shards > 1``: listeners sharing the port by
    ``SO_REUSEPORT``; ``on_payload``: undecoded frames handed to the
    service's shard workers) waits for ROADMAP Queue 1 item 12 and
    raises."""

    def __init__(
        self,
        on_batch: Callable[[TransitionBatch, str, bool], object],
        host: str = "127.0.0.1",
        port: int = 0,
        secret: Optional[str] = None,
        max_payload: int = MAX_PAYLOAD,
        num_shards: int = 1,
        on_payload: Optional[Callable[[bytes, int, str], object]] = None,
        generation: int | Callable[[], int] | None = None,
    ):
        if int(num_shards) != 1 or on_payload is not None:
            raise NotImplementedError(
                "the sharded transition receiver (num_shards > 1, "
                "on_payload) is not ported yet (ROADMAP Queue 1 item 12)")
        super().__init__()
        self._on_batch = on_batch
        self._generation = generation
        self._secret = secret
        self._max_payload = int(max_payload)
        # hostile or corrupt frames dropped (bad magic, oversize, decode
        # failure). Monotonic; reads are informational so no lock.
        self.frames_rejected = 0
        self.num_shards = 1
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
        except OSError:
            s.close()
            raise
        s.listen()
        self._server = s
        self.port = s.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept,
                                               daemon=True)
        self._accept_thread.start()

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
                # reap finished connection threads (a long-lived service
                # with a churning fleet otherwise grows this list without
                # bound)
                self._threads = [t for t in self._threads if t.is_alive()]
                self._register_conn(conn)
                t = threading.Thread(target=self._serve, args=(conn,),
                                     daemon=True)
                t.start()
                self._threads.append(t)
        except Exception as e:
            contained_crash("ingest.accept", e)

    def _serve(self, conn: socket.socket) -> None:
        try:
            self._serve_conn(conn)
        except Exception as e:
            # a raising _on_batch callback must not silently
            # kill the connection thread
            contained_crash("ingest.serve", e)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                if not server_handshake(conn, self._secret):
                    return  # unauthenticated peer; drop before reading frames
                if self._generation is not None:
                    gen = (self._generation() if callable(self._generation)
                           else self._generation)
                    conn.sendall(_GEN_GREETING.pack(
                        _MAGIC_GEN, int(gen) & 0xFFFFFFFF))
                while not self._stop.is_set():
                    header = _recv_exact(conn, _HEADER.size)
                    if header is None:
                        return
                    magic, length = _HEADER.unpack(header)
                    if (magic not in (_MAGIC, _MAGIC_RAW)
                            or length > self._max_payload):
                        # corrupt or hostile stream; drop the connection
                        self.frames_rejected += 1
                        return
                    payload = _recv_exact(conn, length)
                    if payload is None:
                        return
                    codec = "raw" if magic == _MAGIC_RAW else "npz"
                    actor_id, batch, count = decode_frame(payload, codec)
                    self._on_batch(batch, actor_id, count)
        except (ProtocolError, struct.error, ValueError, TypeError):
            # hostile-but-well-framed payload rejected by decode_frame
            # (_raw_header unpack, np.dtype on a garbage name,
            # UnicodeDecodeError ⊂ ValueError): count it, drop the conn.
            # Must precede OSError — ProtocolError ⊂ ConnectionError.
            self.frames_rejected += 1
            return
        except OSError:
            return  # peer died mid-frame; not a rejection
        finally:
            self._unregister_conn(conn)

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        # the accept loop wakes within its 0.2 s poll and lets the
        # listening socket go; a peer it accepted meanwhile is shut below
        self._accept_thread.join(timeout=1.0)
        self._shutdown_conns()
        for t in self._threads:
            t.join(timeout=1.0)
