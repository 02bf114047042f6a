"""Weight-distribution plane v2: versioned delta broadcast, quantized
transport, relay fan-out and generation fencing.

Counterpart of ``d4pg_tpu/distributed/weight_plane.py``; the frames are
the reference's byte for byte, so a JAX puller reads a torch learner's
plane and a torch puller a JAX learner's. Like the reference, the plane
is numpy on the host: published weights are host copies already
(``weights.copy_params(to_host=True)``), and byte-equal frames are the
bar, which a rewrite of the codecs in torch would not meet.

Wire protocol (v2; one port answers both magics, so v1
``weight_server.WeightClient`` pullers keep working):

  client sends  [u32 0xD4FC][i64 have_version][u32 have_generation]
                [u8 codec][u8 flags]                 (flags bit0: deltas ok)
  server replies[u32 0xD4FC][u8 kind][u32 crc32][u32 len][payload]
                (kind 0: not newer, len == 0; kind 1: npz frame)

payload = npz of codec-encoded tensor entries plus metadata
(``__version__``, ``__step__``, ``__generation__``, ``__codec__``,
``__kind__``, ``__base_version__``, ``__pub_ts__``, ``__trace__``). The
crc32 covers the payload: a torn, truncated or corrupted frame is
detected at the client, counted and dropped, never accepted. The tensors
are the actor's Flax tree (``weight_server._flatten``), as in v1.

Delta encoding: the server keeps a bounded window of recent versions'
flattened params. A puller whose ``have_version`` is in the window (same
generation) receives per-tensor deltas against its base: tensors
bitwise equal to the base ship by name in ``__same__`` (0 bytes),
changed tensors ship a sparse XOR (u32 word indices and XOR words) when
that is smaller, else the whole tensor. XOR on raw bytes is exact for
any dtype, and ``verify=True`` (default) checks the reconstruction of
every delta frame built against the full snapshot (the delta oracle).

Quantized transport (per client, the request's codec byte): ``bf16``
rounds float32 tensors to bfloat16 bits to nearest even (relative error
at most ``BF16_REL_BOUND``); ``int8`` quantizes with a per-tensor
symmetric scale (absolute error at most scale / 2). Metadata and
normalizer keys (``__*``) and non-float32 tensors travel raw.
``verify=True`` checks the declared bound on every tensor encoded (the
quantization oracle). Deltas compose with codecs: the window caches the
encoded flat per codec and the XOR runs over encoded bytes.

Generation fencing: a restarted learner's ``WeightStore`` is built at
``generation + 1`` and every frame carries ``(generation, version)``. The
server purges its window the moment it sees a newer generation; clients
refuse a frame whose generation is below the highest they have seen, and
a non-newer version within one. ``WeightRelay`` pulls from an upstream,
republishes verbatim into its own store and serves peers the same
protocol, so trees of relays compose.

Observability: every server feeds the registry's ``weights`` provider
(frames by kind, bytes, delta hit rate, oracle tallies) and the
``weights.staleness_ms`` histogram (pull instant minus publish instant).
With the trace recorder on, each honestly served frame opens a span
(birth: the publish instant; admission: the serve instant); an accepting
client in the same process records ``commit``, a rejecting one ``shed``,
and a connection's teardown sheds the frames still in flight on it. A
frame served to another process ends in that process's recorder.
"""

from __future__ import annotations

import io
import json
import struct
import threading
import time
import weakref
import zipfile
import zlib
from collections import OrderedDict

import numpy as np
import torch

from d4pg_tpu_torch.core.locking import TieredLock
from d4pg_tpu_torch.core.wire import (
    MAGIC_WEIGHTS_V1 as _V1_MAGIC,
    MAGIC_WEIGHTS_V2 as _PLANE_MAGIC,
    WEIGHTS_V1_REQ as _V1_REQ,
    WEIGHTS_V2_REQ as _PLANE_REQ,
    WEIGHTS_V2_RESP as _PLANE_RESP,
    WFLAG_DELTA as _FLAG_DELTA,
)
from d4pg_tpu_torch.distributed.transport import (
    MAX_PAYLOAD,
    ProtocolError,
    ReconnectingClient,
    _recv_exact,
    server_handshake,
)
from d4pg_tpu_torch.distributed.weight_server import (
    WeightServer,
    _flatten,
    _unflatten,
)
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.io.from_jax import torch_layout
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.obs.trace import RECORDER as TRACE, TERMINALS, new_trace_id

_KIND_NONE = 0
_KIND_FRAME = 1

CODECS = ("f32", "bf16", "int8")
_CODEC_ID = {name: i for i, name in enumerate(CODECS)}

# Declared quantization error bounds (the oracle's and the tests' one
# source): bf16 keeps 8 significand bits, so round to nearest is within
# 2^-8 relative for normal values, plus bf16's subnormal step; int8
# rounds to the nearest multiple of the per-tensor scale, give or take
# the float32 rounding of the quantizer's division and of the client's
# dequantizing product (``INT8_ROUNDING`` of |x| + scale).
BF16_REL_BOUND = 2.0 ** -8
BF16_ABS_FUDGE = 2.0 ** -133
INT8_HALF_STEPS = 0.5
INT8_ROUNDING = 2.0 ** -23


# ------------------------------------------------------------ codecs ----

def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit pattern (uint16), round to nearest even."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = bits + 0x7FFF + ((bits >> 16) & 1)
    return (rounded >> 16).astype(np.uint16)


def bf16_to_f32(h: np.ndarray) -> np.ndarray:
    """bfloat16 bit pattern (uint16) -> float32 (exact)."""
    return (h.astype(np.uint32) << 16).view(np.float32)


def quantize_int8(x: np.ndarray) -> tuple[np.ndarray, float]:
    """Symmetric per-tensor int8: scale = max|x| / 127 (1.0 for the
    all-zero tensor, so dequantization stays exact); |x - q * scale| <=
    scale / 2."""
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    scale = (amax / 127.0) or 1.0
    q = np.clip(np.rint(x / np.float32(scale)), -127, 127).astype(np.int8)
    return q, scale


def encode_flat(flat: dict[str, np.ndarray], codec: str
                ) -> dict[str, np.ndarray]:
    """Codec-encode a flattened param dict into wire tensors. The key
    prefix names each tensor's decode rule: ``r:`` raw, ``h:`` bf16
    bits, ``q:`` int8 with its float32 scale under ``qs:``. Metadata and
    normalizer keys (``__*``) and non-float32 tensors are always raw."""
    if codec not in _CODEC_ID:
        raise ValueError(f"unknown weight codec {codec!r}")
    out: dict[str, np.ndarray] = {}
    for k, arr in flat.items():
        arr = np.asarray(arr)
        if codec == "f32" or k.startswith("__") or arr.dtype != np.float32:
            out[f"r:{k}"] = arr
        elif codec == "bf16":
            out[f"h:{k}"] = f32_to_bf16(arr)
        else:  # int8
            q, scale = quantize_int8(arr)
            out[f"q:{k}"] = q
            out[f"qs:{k}"] = np.float32(scale)
    return out


def decode_flat(enc: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Invert ``encode_flat`` (dequantizing to float32 where encoded)."""
    out: dict[str, np.ndarray] = {}
    for k, arr in enc.items():
        if k.startswith("r:"):
            out[k[2:]] = arr
        elif k.startswith("h:"):
            out[k[2:]] = bf16_to_f32(arr)
        elif k.startswith("q:"):
            out[k[2:]] = arr.astype(np.float32) * enc[f"qs:{k[2:]}"]
        elif k.startswith("qs:"):
            continue
        else:
            raise ProtocolError(f"unknown encoded-tensor prefix in {k!r}")
    return out


def quant_error_excess(flat: dict[str, np.ndarray],
                       enc: dict[str, np.ndarray]) -> float:
    """Max (error - declared bound) over the quantized tensors (the
    quantization oracle): <= 0 means every tensor keeps its bound.

    The int8 error is the client's float32 dequantization against x,
    measured in float64. The reference measures it in float32 against
    ``scale / 2 * (1 + 1e-6)``, which a value whose quotient rounds to an
    exact half step (then to even) exceeds by float32 rounding alone: it
    counts such tensors as failures on trained weights."""
    worst = -np.inf
    for k, arr in flat.items():
        x = np.asarray(arr, dtype=np.float32)
        if f"h:{k}" in enc:
            err = np.abs(bf16_to_f32(enc[f"h:{k}"]) - x)
            bound = BF16_REL_BOUND * np.abs(x) + BF16_ABS_FUDGE
        elif f"q:{k}" in enc:
            scale = np.float32(enc[f"qs:{k}"])
            deq = enc[f"q:{k}"].astype(np.float32) * scale
            x64 = x.astype(np.float64)
            err = np.abs(deq.astype(np.float64) - x64)
            bound = (INT8_HALF_STEPS * float(scale)
                     + INT8_ROUNDING * (np.abs(x64) + float(scale)))
        else:
            continue
        if err.size:
            worst = max(worst, float(np.max(err - bound)))
    return worst if np.isfinite(worst) else 0.0


# ------------------------------------------------------------- delta ----

def _xor_words(a: bytes, b: bytes) -> np.ndarray:
    """XOR two equal-length byte strings as zero-padded u32 words."""
    pad = (-len(a)) % 4
    av = np.frombuffer(a + b"\0" * pad, dtype=np.uint32)
    bv = np.frombuffer(b + b"\0" * pad, dtype=np.uint32)
    return av ^ bv


def delta_encode(base: dict[str, np.ndarray], new: dict[str, np.ndarray]
                 ) -> dict[str, np.ndarray]:
    """Per-tensor delta of ``new`` against ``base``: bitwise-equal tensors
    ship by name (``__same__``), changed ones a sparse XOR (``xi:``/
    ``xv:``, u32 word indices and XOR words) when that is smaller than
    the tensor, else the tensor (``t:``). Tensors absent from the base
    (or of another shape or dtype) ship whole; base tensors absent from
    ``new`` are listed in ``__dropped__``. ``delta_apply`` inverts it
    exactly."""
    out: dict[str, np.ndarray] = {}
    same: list[str] = []
    for k, arr in new.items():
        b = base.get(k)
        if b is None or b.dtype != arr.dtype or b.shape != arr.shape:
            out[f"t:{k}"] = arr
            continue
        bb, nb = b.tobytes(), arr.tobytes()
        if bb == nb:
            same.append(k)
            continue
        w = _xor_words(bb, nb)
        idx = np.flatnonzero(w)
        if idx.size * 8 < len(nb):
            out[f"xi:{k}"] = idx.astype(np.uint32)
            out[f"xv:{k}"] = w[idx]
        else:
            out[f"t:{k}"] = arr
    dropped = [k for k in base if k not in new]
    out["__same__"] = np.frombuffer(json.dumps(same).encode(), np.uint8)
    out["__dropped__"] = np.frombuffer(json.dumps(dropped).encode(), np.uint8)
    return out


def delta_apply(base: dict[str, np.ndarray],
                entries: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rebuild the new encoded flat from ``base`` and a delta frame's
    entries (the bitwise inverse of ``delta_encode``)."""
    same = set(json.loads(entries["__same__"].tobytes().decode()))
    dropped = set(json.loads(entries["__dropped__"].tobytes().decode()))
    out: dict[str, np.ndarray] = {
        k: v for k, v in base.items() if k in same and k not in dropped}
    for ek, v in entries.items():
        if ek.startswith("t:"):
            out[ek[2:]] = v
        elif ek.startswith("xi:"):
            k = ek[3:]
            b = base.get(k)
            if b is None:
                raise ProtocolError(f"delta references unknown base {k!r}")
            raw = b.tobytes()
            pad = (-len(raw)) % 4
            w = np.frombuffer(raw + b"\0" * pad, dtype=np.uint32).copy()
            w[v] ^= entries[f"xv:{k}"]
            out[k] = np.frombuffer(w.tobytes()[:len(raw)],
                                   dtype=b.dtype).reshape(b.shape)
    missing = same - set(base)
    if missing:
        raise ProtocolError(f"delta __same__ references unknown base "
                            f"tensors {sorted(missing)[:3]}")
    return out


# --------------------------------------------------------- wire chaos ----

class WeightWireChaos:
    """Seeded server-side fault injection for the weight wire:
    ``torn_prob`` corrupts a frame's payload without fixing its crc32
    (the client must detect and refuse it); ``stale_prob`` serves a
    stale frame, a pre-crash generation from ``stash`` when there is
    one, else the oldest window version. One seeded stream makes every
    decision, so a seed replays the same fault script."""

    def __init__(self, torn_prob: float = 0.0, stale_prob: float = 0.0,
                 seed: int = 0):
        self.torn_prob = float(torn_prob)
        self.stale_prob = float(stale_prob)
        self._rng = np.random.default_rng(
            np.random.SeedSequence(seed, spawn_key=(0x77E1,)))
        self.stash: list[bytes] = []  # pre-crash full-frame payloads
        self.torn_injected = 0
        self.stale_injected = 0

    def decide(self) -> str:
        u_torn, u_stale, _u_pick = self._rng.random(3)
        if u_torn < self.torn_prob:
            return "torn"
        if u_stale < self.stale_prob:
            return "stale"
        return "ok"

    def corrupt(self, payload: bytes) -> bytes:
        """Flip a seeded run of bytes mid-payload (the crc left stale)."""
        buf = bytearray(payload)
        if buf:
            start = int(self._rng.integers(0, max(1, len(buf) - 8)))
            for i in range(start, min(len(buf), start + 8)):
                buf[i] ^= 0xA5
        return bytes(buf)

    def pick_stash(self) -> bytes | None:
        if not self.stash:
            return None
        return self.stash[int(self._rng.integers(0, len(self.stash)))]


# -------------------------------------------------------- the server ----

class WeightPlaneServer(WeightServer):
    """Versioned delta and quantized weight broadcast over one port,
    answering v1 pullers (the base class's memoized full frames) and v2
    pullers (codec, delta, generation fencing, crc). All plane state (the
    bounded version window, the encoded flats per codec, the frame memo)
    lives under the base class's ``wserve`` lock with single-flight
    fills: N pullers of one (version, codec, base) cost one encode."""

    def __init__(self, store: WeightStore, host: str = "127.0.0.1",
                 port: int = 0, secret: str | None = None,
                 window: int = 8, verify: bool = True,
                 chaos: WeightWireChaos | None = None):
        # plane state first: the base constructor starts the accept
        # thread, and a connection arriving before these exist would race
        self.window_size = max(1, int(window))
        self.verify = bool(verify)
        self.chaos = chaos
        self._window: OrderedDict[tuple[int, int], dict] = OrderedDict()
        self._enc: dict[tuple[int, int, str], dict] = {}
        self._frames: dict[tuple, tuple[bytes, int]] = {}
        self._latest: tuple[int, int] | None = None
        self.stats = {
            "snapshots_built": 0, "codec_encodes": 0, "frames_full": 0,
            "frames_delta": 0, "frames_not_newer": 0, "frames_v1": 0,
            "bytes_sent": 0, "bytes_delta": 0, "bytes_full": 0,
            "torn_injected": 0, "stale_injected": 0,
            "oracle_delta_checks": 0, "oracle_delta_failures": 0,
            "oracle_quant_checks": 0, "oracle_quant_failures": 0,
            "window_purged_generations": 0,
        }
        super().__init__(store, host=host, port=port, secret=secret)
        _SERVERS.add(self)

    # -- window + caches (all under _frame_lock) --------------------------

    def _refresh_locked(self) -> None:
        snap = self._store.snapshot_ex()
        if snap["params"] is None:
            return
        gen, version = snap["generation"], snap["version"]
        if self._latest == (gen, version):
            return
        if self._latest is not None:
            cur_gen, cur_ver = self._latest
            if (gen, version) <= (cur_gen, cur_ver) and gen <= cur_gen:
                return  # the store rewound without a generation bump
            if gen > cur_gen:
                # generation fence: purge every pre-crash entry the moment
                # the new generation is visible
                self._window.clear()
                self._enc.clear()
                self._frames.clear()
                self.stats["window_purged_generations"] += 1
                record_event("weight_gen_purge", old_gen=cur_gen, new_gen=gen)
        flat = _flatten(snap["params"])
        norm = snap["norm_stats"]
        if norm is not None:
            flat["__norm_mean__"] = np.asarray(norm[0])
            flat["__norm_std__"] = np.asarray(norm[1])
            if len(norm) > 2:
                flat["__norm_clip__"] = np.float64(norm[2])
        self._window[(gen, version)] = {
            "flat": flat, "step": snap["step"],
            "pub_ts": snap["published_ts"] or time.monotonic(),
        }
        self._latest = (gen, version)
        self.stats["snapshots_built"] += 1
        while len(self._window) > self.window_size:
            old_key, _ = self._window.popitem(last=False)
            self._enc = {k: v for k, v in self._enc.items()
                         if k[:2] != old_key}
            self._frames = {k: v for k, v in self._frames.items()
                            if k[:2] != old_key}

    def _encoded_locked(self, gen: int, version: int, codec: str) -> dict:
        key = (gen, version, codec)
        enc = self._enc.get(key)
        if enc is None:
            entry = self._window[(gen, version)]
            enc = self._enc[key] = encode_flat(entry["flat"], codec)
            self.stats["codec_encodes"] += 1
            if self.verify and codec != "f32":
                self.stats["oracle_quant_checks"] += 1
                if quant_error_excess(entry["flat"], enc) > 0:
                    self.stats["oracle_quant_failures"] += 1
                    record_event("weight_quant_oracle_fail",
                                 version=version, codec=codec)
        return enc

    def _frame_locked(self, gen: int, version: int, codec: str,
                      base_version: int) -> tuple[bytes, int, int]:
        """Build (or take from the memo) the serialized frame; returns
        (payload, kind, trace_id). ``base_version < 0`` means full."""
        key = (gen, version, codec, base_version)
        hit = self._frames.get(key)
        if hit is not None:
            payload, tid = hit
            kind = 1 if base_version >= 0 else 0
            return payload, kind, tid
        entry = self._window[(gen, version)]
        enc_new = self._encoded_locked(gen, version, codec)
        if base_version >= 0:
            enc_base = self._encoded_locked(gen, base_version, codec)
            entries = delta_encode(enc_base, enc_new)
            kind = 1
            if self.verify:
                # the delta oracle: the reconstruction must be bitwise the
                # full snapshot, for every frame, before it ships
                self.stats["oracle_delta_checks"] += 1
                rebuilt = delta_apply(enc_base, entries)
                ok = (rebuilt.keys() == enc_new.keys()
                      and all(rebuilt[k].tobytes() == enc_new[k].tobytes()
                              for k in enc_new))
                if not ok:
                    self.stats["oracle_delta_failures"] += 1
                    record_event("weight_delta_oracle_fail",
                                 version=version, base=base_version)
        else:
            entries = {f"t:{k}": v for k, v in enc_new.items()}
            kind = 0
        tid = new_trace_id()
        buf = io.BytesIO()
        np.savez(
            buf,
            __version__=np.int64(version),
            __step__=np.int64(entry["step"]),
            __generation__=np.int64(gen),
            __codec__=np.int64(_CODEC_ID[codec]),
            __kind__=np.int64(kind),
            __base_version__=np.int64(base_version),
            __pub_ts__=np.float64(entry["pub_ts"]),
            __trace__=np.uint64(tid),
            **entries,
        )
        payload = buf.getvalue()
        self._frames[key] = (payload, tid)
        return payload, kind, tid

    def reset_window(self) -> None:
        """Drop every cached version and frame (a relay's generation
        swap)."""
        with self._frame_lock:
            self._window.clear()
            self._enc.clear()
            self._frames.clear()
            self._latest = None

    def latest_full_payload(self, codec: str = "f32") -> bytes | None:
        """The latest full-frame payload (the fencing drill stashes it
        before a learner restart)."""
        with self._frame_lock:
            self._refresh_locked()
            if self._latest is None:
                return None
            gen, version = self._latest
            payload, _, _ = self._frame_locked(gen, version, codec, -1)
            return payload

    # -- serving -----------------------------------------------------------

    def _respond(self, have_version: int, have_gen: int, codec: str,
                 want_delta: bool) -> tuple[bytes, int | None, int | None]:
        """One v2 response (header and payload), the trace id to track as
        in flight (None for not-newer and chaos-injected answers) and the
        version served (None when no frame went out)."""
        with self._frame_lock:
            self._refresh_locked()
            if self._latest is None:
                return (_PLANE_RESP.pack(_PLANE_MAGIC, _KIND_NONE, 0, 0),
                        None, None)
            gen, version = self._latest
            if gen == have_gen and version <= have_version:
                self.stats["frames_not_newer"] += 1
                return (_PLANE_RESP.pack(_PLANE_MAGIC, _KIND_NONE, 0, 0),
                        None, None)
            injected = self.chaos.decide() if self.chaos is not None else "ok"
            if injected == "stale":
                payload = self._stale_payload_locked(codec)
                if payload is not None:
                    # a valid crc over stale content: the client must fence
                    # it by generation and version, not by checksum
                    self.chaos.stale_injected += 1
                    self.stats["stale_injected"] += 1
                    head = _PLANE_RESP.pack(_PLANE_MAGIC, _KIND_FRAME,
                                            zlib.crc32(payload), len(payload))
                    return head + payload, None, None
            base = -1
            if (want_delta and gen == have_gen and 0 <= have_version < version
                    and (gen, have_version) in self._window):
                base = have_version
            payload, _, tid = self._frame_locked(gen, version, codec, base)
            if injected == "torn":
                self.chaos.torn_injected += 1
                self.stats["torn_injected"] += 1
                torn = self.chaos.corrupt(payload)
                # the crc is the original bytes': detection is certain,
                # and no trace opens (the frame never validly existed)
                head = _PLANE_RESP.pack(_PLANE_MAGIC, _KIND_FRAME,
                                        zlib.crc32(payload), len(torn))
                return head + torn, None, None
            if base >= 0:
                self.stats["frames_delta"] += 1
                self.stats["bytes_delta"] += len(payload)
            else:
                self.stats["frames_full"] += 1
                self.stats["bytes_full"] += len(payload)
            self.stats["bytes_sent"] += len(payload)
            entry = self._window[(gen, version)]
            _STALENESS.observe(
                1e3 * max(0.0, time.monotonic() - entry["pub_ts"]))
            if TRACE.enabled:
                TRACE.begin(tid, entry["pub_ts"])
                TRACE.record_span(tid, "admission")
            head = _PLANE_RESP.pack(_PLANE_MAGIC, _KIND_FRAME,
                                    zlib.crc32(payload), len(payload))
            return head + payload, tid, version

    def _stale_payload_locked(self, codec: str) -> bytes | None:
        stashed = self.chaos.pick_stash()
        if stashed is not None:
            return stashed
        for key in self._window:
            if key != self._latest:
                gen, version = key
                payload, _, _ = self._frame_locked(gen, version, codec, -1)
                return payload
        return None

    def _serve(self, conn) -> None:
        """The dual-protocol serve loop, dispatching each request on its
        magic. ``outstanding`` holds the trace ids served honestly on
        this connection; the connection's next request is the implicit
        ack (the protocol is strictly request/response per connection),
        and teardown sheds whatever is still in flight."""
        try:
            self._serve_plane_conn(conn)
        except Exception as e:  # noqa: BLE001 — counted, the thread ends
            contained_crash("weights.serve", e)

    def _serve_plane_conn(self, conn) -> None:
        outstanding: list[int] = []
        try:
            peer = "%s:%d" % conn.getpeername()[:2]
            with conn:
                if not server_handshake(conn, self._secret):
                    return
                while not self._stop.is_set():
                    head = _recv_exact(conn, 4)
                    if head is None:
                        return
                    (magic,) = struct.unpack("!I", head)
                    if magic == _V1_MAGIC:
                        rest = _recv_exact(conn, _V1_REQ.size - 4)
                        if rest is None:
                            return
                        (have,) = struct.unpack("!q", rest)
                        with self._frame_lock:
                            self.stats["frames_v1"] += 1
                        self._answer_v1(conn, peer, have)
                        continue
                    if magic != _PLANE_MAGIC:
                        return
                    rest = _recv_exact(conn, _PLANE_REQ.size - 4)
                    if rest is None:
                        return
                    have_version, have_gen, codec_id, flags = struct.unpack(
                        "!qIBB", rest)
                    if codec_id >= len(CODECS):
                        return
                    outstanding.clear()  # implicit ack of earlier frames
                    resp, tid, version = self._respond(
                        have_version, have_gen, CODECS[codec_id],
                        bool(flags & _FLAG_DELTA))
                    # register the in-flight trace before the write: its
                    # admission span is stamped, so a peer dying mid-send
                    # must still reach the teardown sweep
                    if tid is not None:
                        outstanding.append(tid)
                    if version is not None:
                        self.pulls_served += 1
                        self.served_versions[peer] = version
                    conn.sendall(resp)
        except OSError:
            return  # the peer died mid-frame; the sweep below sheds traces
        finally:
            self._shed_outstanding(outstanding)
            self._unregister_conn(conn)

    @staticmethod
    def _shed_outstanding(tids: list[int]) -> None:
        if not tids or not TRACE.enabled:
            return
        table = TRACE.span_table()
        for tid in tids:
            spans = table.get(tid)
            if spans is None or not any(t in spans for t in TERMINALS):
                TRACE.terminal_shed(tid)

    def weight_stats(self) -> dict:
        """One consistent snapshot of this server (one lock round trip);
        the ``weights`` provider sums them over the live servers."""
        with self._frame_lock:
            out = dict(self.stats)
            out["window_len"] = len(self._window)
            out["frame_memo_len"] = len(self._frames)
            out["latest"] = self._latest
        out["frame_encodes_v1"] = self.frame_encodes
        served = out["frames_delta"] + out["frames_full"]
        out["delta_hit_rate"] = (round(out["frames_delta"] / served, 4)
                                 if served else None)
        return out


# The aggregate provider: the weight plane lives for the process. Each
# server's snapshot is taken under its own lock; the totals are sums of
# per-server-consistent snapshots.
_SERVERS: "weakref.WeakSet[WeightPlaneServer]" = weakref.WeakSet()
_STALENESS = REGISTRY.histogram("weights.staleness_ms")


def _weights_snapshot() -> dict:
    totals: dict = {"servers": 0}
    for srv in list(_SERVERS):
        stats = srv.weight_stats()
        totals["servers"] += 1
        for k, v in stats.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[k] = totals.get(k, 0) + v
    served = totals.get("frames_delta", 0) + totals.get("frames_full", 0)
    totals["delta_hit_rate"] = (round(totals.get("frames_delta", 0) / served,
                                      4) if served else None)
    totals["staleness_ms"] = _STALENESS.snapshot_dict()
    return totals


REGISTRY.register_provider("weights", _weights_snapshot)


# -------------------------------------------------------- the client ----

class WeightPlaneClient(ReconnectingClient):
    """v2 puller: codec and delta negotiation, crc check and generation
    fencing, with the v1 ``WeightClient``'s stale-degradation contract (a
    down server means acting on stale weights; only ``down_timeout``
    seconds of continuous failure raise). ``version`` and ``generation``
    advance only on accepted frames; every refusal (torn crc, fenced
    generation, non-newer version, missing delta base) is counted and
    sheds its trace.

    ``get_if_newer`` returns ``(version, state_dict)``: the torch names
    of the frame's Flax tree (``io/from_jax.torch_layout``), as CPU
    tensors, as the v1 client does; ``step``, ``norm_stats`` and
    ``last_pub_ts`` describe the last frame adopted."""

    def __init__(self, host: str, port: int, codec: str = "f32",
                 delta: bool = True, connect_timeout: float = 10.0,
                 secret: str | None = None, down_timeout: float = 300.0,
                 reconnect_interval: float = 10.0):
        if codec not in _CODEC_ID:
            raise ValueError(f"unknown weight codec {codec!r}")
        self.codec = codec
        self._delta = bool(delta)
        self._down_timeout = down_timeout
        self._down_since: float | None = None
        self._ever_pulled = False
        self._reconnect_interval = reconnect_interval
        self._next_reconnect = 0.0
        self._enc: dict[str, np.ndarray] | None = None
        self.version = 0
        self.generation = 0
        self.step = 0
        self.norm_stats: tuple | None = None
        self.last_pub_ts = 0.0
        self.counters = {
            "pulls": 0, "accepts": 0, "not_newer": 0, "full_frames": 0,
            "delta_frames": 0, "bytes_received": 0, "torn_rejected": 0,
            "fenced_rejected": 0, "stale_rejected": 0, "delta_base_misses": 0,
        }
        super().__init__(host, port, connect_timeout, secret)

    def get_if_newer(self, have_version: int | None = None):
        """Pull when the server has anything newer than this client's
        state (``have_version`` is accepted for the ``WeightStore``
        reader interface; the fencing state decides). Returns ``(version,
        params)`` or None."""
        with self._lock:
            self._check_open()
            if (self._sock is None and self._ever_pulled
                    and time.monotonic() < self._next_reconnect):
                return None
            try:
                if self._sock is None:
                    self._next_reconnect = (time.monotonic()
                                            + self._reconnect_interval)
                    self._connect()
                result = self._pull_frame()
                self._ever_pulled = True
                if self._down_since is not None:
                    record_event("weight_stale_exit",
                                 addr=f"{self._addr[0]}:{self._addr[1]}",
                                 down_s=round(
                                     time.monotonic() - self._down_since, 3))
                self._down_since = None
                return result
            except ProtocolError:
                self._drop_sock()
                raise
            except (OSError, ConnectionError):
                self._drop_sock()
                self._check_open()
                if not self._ever_pulled:
                    raise  # a config or auth fault: no stale weights yet
                now = time.monotonic()
                if self._down_since is None:
                    self._down_since = now
                    record_event("weight_stale_enter",
                                 addr=f"{self._addr[0]}:{self._addr[1]}",
                                 have_version=self.version)
                if now - self._down_since > self._down_timeout:
                    raise ConnectionError(
                        f"weight server unreachable for "
                        f"{self._down_timeout:.0f}s at "
                        f"{self._addr[0]}:{self._addr[1]}")
                return None

    def _pull_frame(self):
        """One request and response, and the frame's checks; the caller
        holds ``_lock``."""
        self.counters["pulls"] += 1
        delta_ok = self._delta and self._enc is not None
        self._sock.sendall(_PLANE_REQ.pack(
            _PLANE_MAGIC, self.version, self.generation,
            _CODEC_ID[self.codec], _FLAG_DELTA if delta_ok else 0))
        head = _recv_exact(self._sock, _PLANE_RESP.size)
        if head is None:
            raise ConnectionError("weight server closed the connection")
        magic, kind, crc, length = _PLANE_RESP.unpack(head)
        if magic != _PLANE_MAGIC or length > MAX_PAYLOAD:
            raise ProtocolError("corrupt weight stream")
        # a well-formed header proves the handshake and protocol: a torn
        # first frame is transient damage, not a config fault
        self._ever_pulled = True
        if kind == _KIND_NONE:
            self.counters["not_newer"] += 1
            return None
        payload = _recv_exact(self._sock, length)
        if payload is None:
            raise ConnectionError("truncated weight payload")
        self.counters["bytes_received"] += len(payload)
        if zlib.crc32(payload) != crc:
            # detected, counted, never accepted; the stream may be out of
            # step, so the socket goes and the client degrades to stale
            self.counters["torn_rejected"] += 1
            record_event("weight_torn_rejected",
                         addr=f"{self._addr[0]}:{self._addr[1]}",
                         bytes=len(payload))
            raise ConnectionError("weight frame failed crc (torn payload)")
        return self._accept(payload)

    def _accept(self, payload: bytes):
        try:
            with np.load(io.BytesIO(payload)) as z:
                meta_gen = int(z["__generation__"])
                version = int(z["__version__"])
                kind = int(z["__kind__"])
                base_version = int(z["__base_version__"])
                tid = int(z["__trace__"])
                entries = {k: z[k] for k in z.files if not k.startswith("__")}
                entries["__same__"] = (z["__same__"] if "__same__" in z.files
                                       else np.frombuffer(b"[]", np.uint8))
                entries["__dropped__"] = (z["__dropped__"]
                                          if "__dropped__" in z.files
                                          else np.frombuffer(b"[]", np.uint8))
                step = int(z["__step__"])
                pub_ts = float(z["__pub_ts__"])
        except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
            # a crc-valid but unparseable body: refused like a torn frame,
            # so the actor degrades to stale weights instead of crashing
            self.counters["torn_rejected"] += 1
            record_event("weight_torn_rejected",
                         addr=f"{self._addr[0]}:{self._addr[1]}",
                         bytes=len(payload), parse_error=type(e).__name__)
            raise ConnectionError(
                f"weight frame unparseable after crc pass: {e}") from e
        if meta_gen < self.generation:
            # generation fence: a pre-crash frame is never adopted,
            # whatever its version number says
            self.counters["fenced_rejected"] += 1
            record_event("weight_fence_rejected", frame_gen=meta_gen,
                         have_gen=self.generation, version=version)
            self._shed(tid)
            return None
        if meta_gen == self.generation and version <= self.version:
            self.counters["stale_rejected"] += 1
            self._shed(tid)
            return None
        if kind == _KIND_FRAME and base_version >= 0:
            if (meta_gen != self.generation or self._enc is None
                    or base_version != self.version):
                # a delta against a base this client no longer holds:
                # force a full pull next time
                self.counters["delta_base_misses"] += 1
                self._enc = None
                self.version = 0
                self._shed(tid)
                return None
            enc = delta_apply(self._enc, entries)
            self.counters["delta_frames"] += 1
        else:
            enc = {k[2:]: v for k, v in entries.items() if k[:2] == "t:"}
            self.counters["full_frames"] += 1
        if meta_gen > self.generation:
            record_event("weight_gen_adopted", old_gen=self.generation,
                         new_gen=meta_gen, version=version)
        if self._delta:
            self._enc = enc
        flat = decode_flat(enc)
        norm_mean = flat.pop("__norm_mean__", None)
        norm_std = flat.pop("__norm_std__", None)
        norm_clip = flat.pop("__norm_clip__", None)
        if norm_mean is not None:
            self.norm_stats = (norm_mean, norm_std)
            if norm_clip is not None:
                self.norm_stats += (float(norm_clip),)
        self.version = version
        self.generation = meta_gen
        self.step = step
        self.last_pub_ts = pub_ts
        self.counters["accepts"] += 1
        if TRACE.enabled:
            TRACE.record_span(tid, "commit")
        tree = _unflatten(flat)
        params = {name: torch.from_numpy(np.array(a))
                  for name, a in torch_layout(tree["params"]).items()}
        return version, params

    @staticmethod
    def _shed(tid: int) -> None:
        if TRACE.enabled:
            TRACE.terminal_shed(tid)


# --------------------------------------------------------- the relay ----

class WeightRelay:
    """One fan-out node: pulls from an upstream (a learner or a relay),
    keeps the snapshot in its own store and serves peers the same
    protocol. Version, generation and the original publish timestamp
    pass through, so fencing and staleness hold end to end over a tree.

    A generation swap is fenced twice: the puller refuses pre-crash
    frames, and on adoption the relay purges its server's window before
    it republishes (``wrelay`` -> ``wserve`` -> ``wstore``, descending
    tiers), so no downstream pull sees a pre-crash version served as
    current."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None, poll_interval: float = 0.02,
                 window: int = 8, down_timeout: float = 300.0,
                 chaos: WeightWireChaos | None = None):
        self._relay_lock = TieredLock("wrelay")
        self._gen = 0
        self.pulls_ok = 0
        self.gen_adoptions = 0
        # relays pull full precision with deltas: quantization is a leaf
        # client's choice, and quantizing again per hop would compound
        self._client = WeightPlaneClient(
            upstream_host, upstream_port, codec="f32", delta=True,
            secret=secret, down_timeout=down_timeout,
            reconnect_interval=min(1.0, poll_interval * 10))
        self._store = WeightStore()
        self._server = WeightPlaneServer(self._store, host=host, port=port,
                                         secret=secret, window=window,
                                         chaos=chaos)
        self.port = self._server.port
        self._poll_interval = float(poll_interval)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    @property
    def generation(self) -> int:
        return self._gen  # a plain int read; written under _relay_lock

    def _poll(self) -> None:
        try:
            self._poll_loop()
        except Exception as e:  # noqa: BLE001 — counted, the thread ends
            contained_crash("weights.relay_poll", e)

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                res = self._client.get_if_newer()
            except (ConnectionError, OSError, ProtocolError):
                res = None  # degrade stale; the client paces its retries
            if res is not None:
                version, params = res
                with self._relay_lock:
                    if self._client.generation > self._gen:
                        self._gen = self._client.generation
                        self.gen_adoptions += 1
                        # purge before the republish: no moment in which
                        # the server could pair a pre-crash frame with a
                        # post-crash store
                        self._server.reset_window()
                    self.pulls_ok += 1
                    self._store.publish_versioned(
                        params, version, self._client.step,
                        norm_stats=self._client.norm_stats,
                        generation=self._client.generation,
                        publish_ts=self._client.last_pub_ts)
            self._stop.wait(self._poll_interval)

    def weight_stats(self) -> dict:
        return self._server.weight_stats()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._server.close()
        self._client.close()
