"""Serving-plane wire protocol: CRC-framed action request and response.

Counterpart of ``d4pg_tpu/serving/protocol.py`` (numpy, ``struct`` and
``zlib`` only): the frames are byte for byte the reference's, so a port
client talks to a reference server and the other way round. A fixed
``!II`` (magic, body length) outer frame, a fixed inner header and a
CRC32 over the float payload. The CRC is the torn-response defense: a
response cut mid-``sendall`` is a counted rejection at the client, never
a wrong action batch.

    request  0xD4E2: !BIHHI  flags, req_id, n_rows, obs_dim, crc32
             [16-byte trace ext ``!Qd`` (trace id, birth ts) if flags&1]
             payload: float32 obs rows [n_rows, obs_dim]
    response 0xD4E3: !BIIIHHI status, req_id, generation, version,
                              n_rows, act_dim, crc32
             payload: float32 action rows [n_rows, act_dim] (OK only)

Status codes: OK (actions attached), NO_PARAMS (the server adopted
nothing yet: the client falls back), BAD_REQUEST (the server could not
trust the request; the req_id is echoed so the caller fails that one
request), OVERLOAD (an admission budget said no; the elastic policy that
sends it is not ported, the status is kept so both sides decode it).
"""

from __future__ import annotations

import zlib

import numpy as np

# Frame shapes come from the declared wire registry (core/wire.py).
# MAX_BODY is the serving plane's tighter cap: it catches a desynced
# stream before it allocates gigabytes.
from d4pg_tpu_torch.core.wire import (
    FRAME_HEADER as HEADER,
    MAGIC_SERVE_REQUEST as MAGIC_REQUEST,
    MAGIC_SERVE_RESPONSE as MAGIC_RESPONSE,
    MAX_BODY,
    SERVE_REQ_HEADER as REQ_HEADER,
    SERVE_RSP_HEADER as RSP_HEADER,
    SERVE_TRACE_EXT as TRACE_EXT,
    SFLAG_TRACE as FLAG_TRACE,
)


class ProtocolError(RuntimeError):
    """Malformed serving frame (bad magic, truncation, size mismatch).
    Not the transport module's ``ProtocolError``: callers that speak both
    planes catch both."""


STATUS_OK = 0
STATUS_NO_PARAMS = 1
STATUS_BAD_REQUEST = 2
# an admission budget rejected the request: a load verdict, not an
# error; clients degrade down their ladder as for NO_PARAMS
STATUS_OVERLOAD = 3


class TornFrameError(ProtocolError):
    """CRC mismatch: the payload bytes do not match the header's CRC.

    Deterministic wire corruption (torn write across a server kill, or
    injected chaos) — the caller counts and REJECTS the frame; retrying
    the same bytes can never succeed."""


def encode_request(req_id: int, obs: np.ndarray,
                   trace: tuple[int, float] | None = None) -> bytes:
    """One action request frame for a [n_rows, obs_dim] float32 batch."""
    obs = np.ascontiguousarray(obs, dtype=np.float32)
    if obs.ndim != 2:
        raise ValueError(f"obs must be [n_rows, obs_dim], got {obs.shape}")
    n_rows, obs_dim = obs.shape
    payload = obs.tobytes()
    flags = FLAG_TRACE if trace is not None else 0
    head = REQ_HEADER.pack(flags, req_id & 0xFFFFFFFF, n_rows, obs_dim,
                           zlib.crc32(payload))
    ext = TRACE_EXT.pack(trace[0], trace[1]) if trace is not None else b""
    body = head + ext + payload
    return HEADER.pack(MAGIC_REQUEST, len(body)) + body


def decode_request(body: bytes) -> dict:
    """Parse a request body; raises TornFrameError on CRC mismatch (the
    header fields are still returned inside the exception's ``.meta`` so
    the server can echo the req_id in a BAD_REQUEST response)."""
    if len(body) < REQ_HEADER.size:
        raise ProtocolError(f"request body too short ({len(body)} bytes)")
    flags, req_id, n_rows, obs_dim, crc = REQ_HEADER.unpack_from(body)
    off = REQ_HEADER.size
    trace = None
    if flags & FLAG_TRACE:
        if len(body) < off + TRACE_EXT.size:
            raise ProtocolError("request trace extension truncated")
        trace = TRACE_EXT.unpack_from(body, off)
        off += TRACE_EXT.size
    payload = body[off:]
    if len(payload) != 4 * n_rows * obs_dim:
        raise ProtocolError(
            f"request payload {len(payload)}B != {4 * n_rows * obs_dim}B "
            f"for [{n_rows}, {obs_dim}] f32")
    if zlib.crc32(payload) != crc:
        err = TornFrameError(f"request {req_id} failed CRC")
        err.meta = {"req_id": req_id}
        raise err
    obs = np.frombuffer(payload, np.float32).reshape(n_rows, obs_dim)
    return {"req_id": req_id, "obs": obs, "trace": trace}


def encode_response(req_id: int, status: int, generation: int, version: int,
                    actions: np.ndarray | None) -> bytes:
    """One response frame; ``actions`` is required iff status == OK."""
    if status == STATUS_OK:
        actions = np.ascontiguousarray(actions, dtype=np.float32)
        n_rows, act_dim = actions.shape
        payload = actions.tobytes()
    else:
        n_rows = act_dim = 0
        payload = b""
    head = RSP_HEADER.pack(status, req_id & 0xFFFFFFFF,
                           generation & 0xFFFFFFFF, version & 0xFFFFFFFF,
                           n_rows, act_dim, zlib.crc32(payload))
    body = head + payload
    return HEADER.pack(MAGIC_RESPONSE, len(body)) + body


def decode_response(body: bytes) -> dict:
    """Parse a response body; TornFrameError on CRC mismatch — the
    client counts it and treats the request as failed (degrading to its
    local fallback), never acts on the corrupt rows."""
    if len(body) < RSP_HEADER.size:
        raise ProtocolError(f"response body too short ({len(body)} bytes)")
    status, req_id, generation, version, n_rows, act_dim, crc = \
        RSP_HEADER.unpack_from(body)
    payload = body[RSP_HEADER.size:]
    if status == STATUS_OK and len(payload) != 4 * n_rows * act_dim:
        raise ProtocolError(
            f"response payload {len(payload)}B != {4 * n_rows * act_dim}B")
    if zlib.crc32(payload) != crc:
        raise TornFrameError(f"response {req_id} failed CRC")
    actions = (np.frombuffer(payload, np.float32).reshape(n_rows, act_dim)
               if status == STATUS_OK else None)
    return {"req_id": req_id, "status": status, "generation": generation,
            "version": version, "actions": actions}


def read_frame(sock, expect_magic: int, recv_exact) -> bytes | None:
    """Read one length-prefixed frame body off ``sock`` (None on clean
    EOF). ``recv_exact`` is injected so client and server share the
    transport module's socket-read discipline without importing its
    private helper here."""
    head = recv_exact(sock, HEADER.size)
    if head is None:
        return None
    magic, body_len = HEADER.unpack(head)
    if magic != expect_magic:
        raise ProtocolError(f"bad serving magic 0x{magic:X} "
                            f"(want 0x{expect_magic:X})")
    if body_len > MAX_BODY:
        raise ProtocolError(f"serving body {body_len}B exceeds {MAX_BODY}B")
    body = recv_exact(sock, body_len)
    if body is None:
        raise ProtocolError("peer closed mid-frame")
    return body
