"""Declared wire-protocol registry: the single table of every frame magic.

Counterpart of ``d4pg_tpu/core/wire.py``, copied (stdlib only). Every
magic, header ``struct``, flag bit and payload cap of the reference's
wire planes is declared here once, with the same values, so a frame the
port encodes is byte for byte the frame the reference encodes and each
side decodes the other's. The port's planes (``distributed/transport``,
``distributed/weight_server``) import from here. The port speaks the
ingest frames (v1 npz, v2 raw with the count, trace and generation
extensions, the generation greeting) and the v1 weight frames; the v2
weight plane, the update plane, the serving frames and the replay
sidecar are declared for completeness and wait for ROADMAP Queue 1 items
12, 13 and 17. The reference's static mirror of this table (its lint
pass) is not ported.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

# --------------------------------------------------------------------------
# Magics. One u32 (or 4-byte prefix) per frame family; all socket magics
# live in the 0xD4xx page. Seed-derivation uses of 0xD4xx literals
# (SeedSequence spawn keys, default_rng XOR salts) are NOT wire magics.
# --------------------------------------------------------------------------

MAGIC_INGEST_V1 = 0xD4F6  # transition frames, npz payload
MAGIC_INGEST_V2 = 0xD4F8  # transition frames, raw column payload
MAGIC_GEN_GREETING = 0xD4FA  # server->client generation greeting (u16 on wire)
MAGIC_WEIGHTS_V1 = 0xD4F7  # legacy full-snapshot weight pull
MAGIC_WEIGHTS_V2 = 0xD4FC  # versioned delta/full weight plane
MAGIC_UPDATE = 0xD4AB  # learner update submission + ack
MAGIC_SERVE_REQUEST = 0xD4E2  # policy inference request
MAGIC_SERVE_RESPONSE = 0xD4E3  # policy inference response
SIDECAR_MAGIC = b"D4RS"  # replay snapshot sidecar file prefix (not socket-facing)

# --------------------------------------------------------------------------
# Header / extension structs. Each format string is written ONCE, here,
# as the Struct constructor literal; the registry table below references
# the compiled ``.format`` so declaration and compilation cannot drift.
# --------------------------------------------------------------------------

FRAME_HEADER = struct.Struct("!II")  # [magic][payload len] outer framing
GEN_GREETING = struct.Struct("!HI")  # [u16 magic][u32 generation]

# ingest v2 raw-payload header walk, in fixed order:
#   [pre][actor id bytes][trace ext?][generation ext?][field table]
RAW_PRE = struct.Struct("!BB")  # [flag byte][actor-id length]
RAW_TRACE = struct.Struct("!Qd")  # trace ext: [trace id][t_enqueue]
RAW_GEN = struct.Struct("!I")  # generation ext: [generation]
RAW_NFIELDS = struct.Struct("!B")  # field-table prefix: [field count]
RAW_FIELD_PRE = struct.Struct("!BB")  # per field: [dtype-str len][ndim]

WEIGHTS_V1_REQ = struct.Struct("!Iq")  # [magic][have_version]
WEIGHTS_V1_RESP = struct.Struct("!II")  # [magic][payload len]
WEIGHTS_V2_REQ = struct.Struct("!IqIBB")  # [magic][have_ver][have_gen][codec][flags]
WEIGHTS_V2_RESP = struct.Struct("!IBII")  # [magic][kind][crc32][payload len]

# [magic][replica][epoch][generation][version][base_version][clock]
# [weight][flags][crc32][payload len]
UPDATE_HEADER = struct.Struct("!IIIIqqqdBII")
# [magic][status][version][lag][weight][clipped]
UPDATE_ACK = struct.Struct("!IBqqdB")

SERVE_REQ_HEADER = struct.Struct("!BIHHI")  # [flags][req_id][n_rows][obs_dim][crc32]
SERVE_RSP_HEADER = struct.Struct("!BIIIHHI")  # [status][req_id][gen][ver][rows][dim][crc]
SERVE_TRACE_EXT = struct.Struct("!Qd")  # [trace id][t_submit]

SIDECAR_HEAD = struct.Struct("!4sBI")  # [b"D4RS"][version][crc32]
SIDECAR_VERSION = 1

# --------------------------------------------------------------------------
# Flag-byte bit allocations, per plane. A plane's flag byte is a single
# namespace: two extensions claiming the same bit is a wire break
# (``_plane_flag_bits`` refuses it at import). Bits not declared here are
# unallocated.
# --------------------------------------------------------------------------

F_COUNT = 0x01  # ingest bit0: payload carries a transition count
F_TRACE = 0x02  # ingest bit1: RAW_TRACE extension present
F_GEN = 0x04  # ingest bit2: RAW_GEN extension present
WFLAG_DELTA = 0x01  # weights bit0: client can apply a delta frame
SFLAG_TRACE = 0x01  # serving bit0: SERVE_TRACE_EXT present

# --------------------------------------------------------------------------
# Payload caps (shared admission bound per plane).
# --------------------------------------------------------------------------

MAX_PAYLOAD = 64 << 20  # ingest / weights / updates frames
MAX_BODY = 8 << 20  # serving request/response bodies


@dataclass(frozen=True)
class FrameSpec:
    """One frame family: a magic, its owning plane, and its codec facts.

    ``crc`` is the CRC discipline: ``"none"`` or ``"crc32-payload"``
    (a u32 crc32 of the payload travels in the header and MUST be
    checked before the payload is parsed). ``flags`` are the
    ``(bit, meaning)`` allocations of this frame's flag byte;
    ``extensions`` are the ``(name, format)`` sub-structs that follow
    the header, in wire order where the order is fixed.
    """

    name: str
    plane: str  # ingest | weights | updates | serving | recovery
    magic: object  # int for socket frames, bytes for the file sidecar
    header: str  # struct format of the magic-bearing header
    crc: str = "none"
    flags: tuple = ()
    extensions: tuple = ()

    @property
    def header_size(self) -> int:
        return struct.calcsize(self.header)


REGISTRY: dict[str, FrameSpec] = {
    spec.name: spec
    for spec in (
        FrameSpec("ingest-v1", "ingest", MAGIC_INGEST_V1, FRAME_HEADER.format),
        FrameSpec(
            "ingest-v2",
            "ingest",
            MAGIC_INGEST_V2,
            FRAME_HEADER.format,
            flags=((F_COUNT, "count"), (F_TRACE, "trace"), (F_GEN, "generation")),
            extensions=(
                ("pre", RAW_PRE.format),
                ("trace", RAW_TRACE.format),
                ("generation", RAW_GEN.format),
                ("nfields", RAW_NFIELDS.format),
                ("field-pre", RAW_FIELD_PRE.format),
            ),
        ),
        FrameSpec("gen-greeting", "ingest", MAGIC_GEN_GREETING, GEN_GREETING.format),
        FrameSpec("weights-v1-req", "weights", MAGIC_WEIGHTS_V1, WEIGHTS_V1_REQ.format),
        FrameSpec("weights-v1-resp", "weights", MAGIC_WEIGHTS_V1, WEIGHTS_V1_RESP.format),
        FrameSpec(
            "weights-v2-req",
            "weights",
            MAGIC_WEIGHTS_V2,
            WEIGHTS_V2_REQ.format,
            flags=((WFLAG_DELTA, "delta"),),
        ),
        FrameSpec(
            "weights-v2-resp",
            "weights",
            MAGIC_WEIGHTS_V2,
            WEIGHTS_V2_RESP.format,
            crc="crc32-payload",
        ),
        FrameSpec(
            "update-req", "updates", MAGIC_UPDATE, UPDATE_HEADER.format,
            crc="crc32-payload",
        ),
        FrameSpec("update-ack", "updates", MAGIC_UPDATE, UPDATE_ACK.format),
        FrameSpec(
            "serve-request",
            "serving",
            MAGIC_SERVE_REQUEST,
            FRAME_HEADER.format,
            crc="crc32-payload",
            flags=((SFLAG_TRACE, "trace"),),
            extensions=(
                ("req-header", SERVE_REQ_HEADER.format),
                ("trace", SERVE_TRACE_EXT.format),
            ),
        ),
        FrameSpec(
            "serve-response",
            "serving",
            MAGIC_SERVE_RESPONSE,
            FRAME_HEADER.format,
            crc="crc32-payload",
            extensions=(("rsp-header", SERVE_RSP_HEADER.format),),
        ),
        FrameSpec(
            "sidecar", "recovery", SIDECAR_MAGIC, SIDECAR_HEAD.format,
            crc="crc32-payload",
        ),
    )
}


def _magic_planes() -> dict:
    """Magic -> owning plane; a magic shared by req/resp specs must agree."""
    planes: dict = {}
    for spec in REGISTRY.values():
        prev = planes.setdefault(spec.magic, spec.plane)
        if prev != spec.plane:
            raise AssertionError(
                f"magic {spec.magic!r} claimed by planes {prev} and {spec.plane}"
            )
    return planes


MAGIC_PLANES = _magic_planes()


def _plane_flag_bits() -> dict:
    """Plane -> {bit: meaning}; a bit claimed twice with different
    meanings is a declaration-time collision."""
    bits: dict = {}
    for spec in REGISTRY.values():
        table = bits.setdefault(spec.plane, {})
        for bit, meaning in spec.flags:
            prev = table.setdefault(bit, meaning)
            if prev != meaning:
                raise AssertionError(
                    f"plane {spec.plane} flag bit {bit:#04x} claimed as "
                    f"both {prev!r} and {meaning!r}"
                )
    return bits


PLANE_FLAG_BITS = _plane_flag_bits()


def ingest_v2_layout(flags: int, aid_len: int) -> dict:
    """Declared byte offsets of an ingest-v2 payload carrying ``flags``.

    The v2 raw header is [RAW_PRE][actor id][trace?][generation?][field
    table] in that fixed order. The zero-decode admission readers
    (``transport.raw_frame_meta*``) and the full decoder both walk the
    header through THESE offsets, so admission can never drift from the
    codec. Absent extensions report offset -1; ``"fields"`` is where
    the field table starts.
    """
    off = RAW_PRE.size + aid_len
    layout = {"aid": RAW_PRE.size, "trace": -1, "generation": -1}
    if flags & F_TRACE:
        layout["trace"] = off
        off += RAW_TRACE.size
    if flags & F_GEN:
        layout["generation"] = off
        off += RAW_GEN.size
    layout["fields"] = off
    return layout
