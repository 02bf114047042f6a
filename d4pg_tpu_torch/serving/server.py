"""PolicyInferenceServer: continuous-batching greedy-action inference.

Counterpart of ``d4pg_tpu/serving/server.py``. Many lanes send obs batches
over the serving wire (``serving.protocol``); one batcher thread fuses
whatever arrived inside a bounded window into ONE forward of the actor.

- **Bounded window, never a stall.** The batcher waits at most
  ``batch_window_s`` after the first pending request (or until
  ``max_batch_rows`` rows wait); an idle server waits on its condition.
- **Padded power-of-two buckets.** The fused rows are padded with zero
  rows to the next power of two, as the reference pads them so that its
  compiled shapes stay few. Torch compiles nothing here; the buckets are
  kept so that ``padded_rows`` and ``batch_occupancy`` count what the
  reference counts.
- **Fenced freshness.** A refresher thread adopts (generation, version)
  snapshots of the ``WeightStore`` monotonically; a regression without a
  generation bump is a counted rejection (``fenced_rejected``), and every
  response carries the pair that produced it. ``staleness_s`` is exported,
  and a batch served past ``sla_staleness_s`` counts in ``sla_breaches``.

Where inference runs: ``device`` is ``'cpu'`` (the reference driver's
default: the card belongs to the learner) or ``'default'`` (the learner's
device, ``cuda`` unless ``learner_device`` names another), resolved by
``serving.client.resolve_act_device``. Each adoption loads the snapshot
into a fresh copy of the actor network on that device outside the
serving condition, waits until the copy is complete (the refresher
synchronizes the device's current stream), and only then swaps the
network in under the condition, so the batcher never reads a half-copied
network.

Obs rows arrive already normalized (the normalizer view lives with the
lane); the server computes greedy actions only.

Locking: the pending queue, the adopted network and the counters live
under the ``pserve``-tier condition; the store read, the copy to the
device, the forward and the socket writes happen outside it. The
batcher writes the responses it serves, a connection's reader thread the
ones it answers at once (a bad request, an overload rejection); a client
may pipeline requests, so every frame goes out whole under its
connection's send lock (``_send``: a plain lock, nothing acquired under
it).

The elastic plane's knobs and gate (``elastic/``): ``set_batch_limits``
and ``set_admission_depth`` change the batching window, the row budget
and the admission bound live; each takes the serving condition at top
level and the next window runs under the new values. With an
``admission=`` policy (``elastic.AdmissionPolicy``) a request is
classified by its lane (the top 12 bits of its req_id, which a client
cannot raise) and admitted only while the pending queue stands below its
class's share of ``admission_depth``; a rejection answers
``STATUS_OVERLOAD`` at once, records an ``admission_reject`` event and
counts in ``admission_rejects`` and ``admission_rejects_by_class``. With
``sla_latency_ms`` a served request whose enqueue-to-write time passes it
counts in ``latency_breaches``. Without a policy the queue is unbounded,
as before.
"""

from __future__ import annotations

import copy
import socket
import threading
import time
from collections import deque

import numpy as np
import torch

from d4pg_tpu_torch.core.locking import TieredCondition
from d4pg_tpu_torch.distributed.transport import (
    ConnRegistry,
    _recv_exact,
    server_handshake,
)
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.learner.update import act_deterministic
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import EVENT_ADMISSION_REJECT, record_event
from d4pg_tpu_torch.obs.registry import REGISTRY, percentile_summary
from d4pg_tpu_torch.obs.trace import RECORDER
from d4pg_tpu_torch.serving import protocol
from d4pg_tpu_torch.serving.client import resolve_act_device


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class ServingChaos:
    """Deterministic response corruption for the serving wire: flips one
    payload byte AFTER the CRC is computed, at a seeded rate, so the frame
    still parses but its CRC check must reject it. ``torn_req_ids`` is the
    injection ledger a test intersects with the clients' acceptance
    ledgers (the intersection must be empty)."""

    def __init__(self, torn_response_rate: float = 0.0, seed: int = 0):
        self.torn_response_rate = float(torn_response_rate)
        self._rng = np.random.default_rng((seed << 4) ^ 0xD4E3)
        self._mu = threading.Lock()
        self.torn_req_ids: set[int] = set()
        self.torn_injected = 0

    def maybe_tear(self, req_id: int, frame: bytes) -> bytes:
        body_payload_off = protocol.HEADER.size + protocol.RSP_HEADER.size
        if (self.torn_response_rate <= 0.0
                or len(frame) <= body_payload_off
                or self._rng.random() >= self.torn_response_rate):
            return frame
        torn = bytearray(frame)
        idx = body_payload_off + int(
            self._rng.integers(0, len(frame) - body_payload_off))
        torn[idx] ^= 0xFF
        with self._mu:
            self.torn_req_ids.add(req_id)
            self.torn_injected += 1
        return bytes(torn)


class PolicyInferenceServer(ConnRegistry):
    """Continuous-batching greedy-action service over one port."""

    def __init__(
        self,
        config: D4PGConfig,
        weights,
        host: str = "127.0.0.1",
        port: int = 0,
        secret: str | None = None,
        batch_window_s: float = 0.002,
        max_batch_rows: int = 256,
        sla_staleness_s: float = 1.0,
        refresh_interval_s: float = 0.02,
        device: str = "cpu",
        chaos: ServingChaos | None = None,
        admission=None,
        admission_depth: int = 64,
        sla_latency_ms: float | None = None,
        learner_device: str | torch.device | None = None,
    ):
        super().__init__()
        self.config = config
        self._weights = weights
        self._secret = secret
        self.batch_window_s = float(batch_window_s)
        self.max_batch_rows = int(max_batch_rows)
        self.sla_staleness_s = float(sla_staleness_s)
        self.refresh_interval_s = float(refresh_interval_s)
        # SLO admission (see the module docstring); None keeps the
        # unbounded queue
        self._admission = admission
        self.admission_depth = int(admission_depth)
        # the queueing-latency SLO (staleness is freshness; this is
        # promptness)
        self.sla_latency_ms = sla_latency_ms
        self.chaos = chaos
        self._obs_dim = int(config.obs_dim)
        self.device = resolve_act_device(device, learner_device)
        # the network each adoption copies: built once, never run
        self._template = config.build_actor(
            torch.Generator().manual_seed(0)).to(self.device)
        self._template.requires_grad_(False)
        # ---- serving state, all under the pserve tier ----
        self._pserve_cond = TieredCondition("pserve")
        self._pending: deque = deque()  # (conn, req dict, enqueue_ts)
        self._actor = None  # the adopted network
        self._generation = 0
        self._version = 0
        self._published_ts: float | None = None
        self._occupancy: deque = deque(maxlen=4096)
        self._latency_ms: deque = deque(maxlen=4096)
        self._batch_rows: deque = deque(maxlen=4096)
        self.stats = {
            "requests": 0, "responses_ok": 0, "batches": 0, "rows": 0,
            "padded_rows": 0, "no_params": 0, "bad_requests": 0,
            "write_errors": 0, "adoptions": 0, "fenced_rejected": 0,
            "sla_breaches": 0, "admission_rejects": 0,
            "latency_breaches": 0,
        }
        # class name -> rejected requests, under the serving condition
        self.admission_rejects_by_class: dict[str, int] = {}
        # ---- wiring ----
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen()
        self.port = self._server.getsockname()[1]
        self._stop = threading.Event()
        self._conn_threads: list[threading.Thread] = []
        # connection -> its send lock, set by its reader thread
        self._send_locks: dict[socket.socket, threading.Lock] = {}
        self._accept_thread = threading.Thread(
            target=self._accept, daemon=True, name="serving-accept")
        self._batch_thread = threading.Thread(
            target=self._batcher, daemon=True, name="serving-batcher")
        self._refresh_thread = threading.Thread(
            target=self._refresher, daemon=True, name="serving-refresh")
        REGISTRY.register_provider("serving", self.serving_stats)
        self._accept_thread.start()
        self._batch_thread.start()
        self._refresh_thread.start()

    # -- param freshness ----------------------------------------------------
    def _refresher(self) -> None:
        try:
            while not self._stop.is_set():
                self.refresh_once()
                self._stop.wait(self.refresh_interval_s)
        except Exception as e:  # noqa: BLE001 — counted, the thread ends
            contained_crash("serving.refresher", e)

    def _newer(self, gen: int, ver: int) -> bool:
        return (gen > self._generation
                or (gen == self._generation and ver > self._version))

    def refresh_once(self) -> bool:
        """One adoption attempt against the store's current snapshot. The
        store read and the copy to the device happen outside the serving
        condition; only the swap is under it."""
        snap = self._weights.snapshot_ex()
        if snap["params"] is None:
            return False
        gen, ver = int(snap["generation"]), int(snap["version"])
        with self._pserve_cond:
            if not self._newer(gen, ver):
                if ((gen, ver) != (self._generation, self._version)
                        and self._actor is not None):
                    # the fence: behind what we serve, no generation bump
                    self.stats["fenced_rejected"] += 1
                return False
        actor = copy.deepcopy(self._template)
        actor.load_state_dict(snap["params"])
        if self.device.type == "cuda":
            # the copy is complete before the batcher can read the network
            torch.cuda.current_stream(self.device).synchronize()
        with self._pserve_cond:
            # another refresh may have adopted something newer meanwhile
            if self._newer(gen, ver):
                self._actor = actor
                self._generation, self._version = gen, ver
                self._published_ts = snap.get("published_ts") \
                    or time.monotonic()
                self.stats["adoptions"] += 1
                return True
        return False

    def staleness_s(self) -> float | None:
        """Age of the served snapshot against the SLA clock."""
        with self._pserve_cond:
            if self._published_ts is None:
                return None
            return time.monotonic() - self._published_ts

    # -- live capacity knobs (the autoscaler's actuators) --------------------
    def set_batch_limits(self, window_s: float | None = None,
                         max_rows: int | None = None) -> None:
        """Change the batching window and the row budget live (rows at
        least 1). The batcher reads both under the serving condition, so a
        window that is open closes under the new limits; taken at top
        level, with nothing else held."""
        with self._pserve_cond:
            if window_s is not None:
                self.batch_window_s = float(window_s)
            if max_rows is not None:
                self.max_batch_rows = max(1, int(max_rows))
            self._pserve_cond.notify()

    def set_admission_depth(self, depth: int) -> None:
        """Change the queue-depth bound the class budgets are computed
        against (at least 1); the next request is admitted under it."""
        with self._pserve_cond:
            self.admission_depth = max(1, int(depth))

    # -- connections --------------------------------------------------------
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
                t = threading.Thread(target=self._reader, args=(conn,),
                                     daemon=True)
                self._conn_threads.append(t)
                t.start()
        except Exception as e:  # noqa: BLE001 — counted, the thread ends
            contained_crash("serving.accept", e)

    def _reader(self, conn: socket.socket) -> None:
        """Per-connection request pump: decode, validate, enqueue."""
        try:
            self._read_conn(conn)
        except Exception as e:  # noqa: BLE001 — counted, the thread ends
            contained_crash("serving.reader", e)

    def _read_conn(self, conn: socket.socket) -> None:
        self._send_locks[conn] = threading.Lock()
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if not server_handshake(conn, self._secret):
                return
            conn.settimeout(None)
            while not self._stop.is_set():
                body = protocol.read_frame(conn, protocol.MAGIC_REQUEST,
                                           _recv_exact)
                if body is None:
                    return
                try:
                    req = protocol.decode_request(body)
                except protocol.TornFrameError as e:
                    # a corrupt payload under a readable header fails the
                    # one request and keeps the connection
                    self._respond_error(conn, e.meta["req_id"],
                                        protocol.STATUS_BAD_REQUEST)
                    continue
                if req["obs"].shape[1] != self._obs_dim:
                    self._respond_error(conn, req["req_id"],
                                        protocol.STATUS_BAD_REQUEST)
                    continue
                self._admit_request(conn, req)
        except (OSError, protocol.ProtocolError):
            return  # peer died or desynced; the lane reconnects
        finally:
            self._unregister_conn(conn)
            self._send_locks.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

    def _admit_request(self, conn: socket.socket, req: dict) -> None:
        """Queue one decoded request, opening its trace span; the span
        rides the queue entry until the response path ends it. With an
        admission policy the request first passes its class's budget; a
        rejection is answered ``STATUS_OVERLOAD`` from this reader thread,
        outside the serving condition, and its span ends shed."""
        now = time.monotonic()
        tid = None
        if req["trace"] is not None:
            tid, birth = req["trace"]
            RECORDER.begin(tid, birth)
            RECORDER.record_span(tid, "admission", now)
        rejected_cls = None
        try:
            with self._pserve_cond:
                self.stats["requests"] += 1
                if self._admission is not None:
                    cls = self._admission.classify_index(
                        (req["req_id"] >> 20) & 0xFFF)
                    budget = self._admission.depth_for(
                        cls, self.admission_depth)
                    if len(self._pending) >= budget:
                        rejected_cls = self._admission.class_name(cls)
                        self.stats["admission_rejects"] += 1
                        self.admission_rejects_by_class[rejected_cls] = (
                            self.admission_rejects_by_class.get(
                                rejected_cls, 0) + 1)
                if rejected_cls is None:
                    self._pending.append((conn, req, now))
                    self._pserve_cond.notify()
        except BaseException:
            # a failed enqueue ends the span it opened before re-raising
            if tid is not None:
                RECORDER.terminal_shed(tid)
            raise
        if rejected_cls is not None:
            record_event(EVENT_ADMISSION_REJECT, plane="serving",
                         cls=rejected_cls, req_id=req["req_id"])
            try:
                self._send(conn, protocol.encode_response(
                    req["req_id"], protocol.STATUS_OVERLOAD, 0, 0, None))
            except OSError:
                with self._pserve_cond:
                    self.stats["write_errors"] += 1
            if tid is not None:
                RECORDER.terminal_shed(tid)

    def _send(self, conn: socket.socket, frame: bytes) -> None:
        """One whole frame on ``conn``: the batcher and the reader thread
        may both answer on it."""
        lock = self._send_locks.get(conn)
        if lock is None:  # the connection is gone: sendall raises
            conn.sendall(frame)
            return
        with lock:
            conn.sendall(frame)

    def _respond_error(self, conn: socket.socket, req_id: int,
                       status: int) -> None:
        with self._pserve_cond:
            self.stats["bad_requests"] += 1
        try:
            self._send(conn, protocol.encode_response(req_id, status, 0, 0,
                                                      None))
        except OSError:
            with self._pserve_cond:
                self.stats["write_errors"] += 1

    # -- the batcher --------------------------------------------------------
    # the batcher pops inside its ``with self._pserve_cond`` window
    def _pop_batch_locked(self) -> list:  # jaxlint: guarded-by=_pserve_cond
        """FIFO-pop pending requests up to the row budget (at least one: a
        single oversized request is served alone in its own bucket)."""
        batch, rows = [], 0
        while self._pending:
            n = self._pending[0][1]["obs"].shape[0]
            if batch and rows + n > self.max_batch_rows:
                break
            batch.append(self._pending.popleft())
            rows += n
        return batch

    def _batcher(self) -> None:
        try:
            self._batch_loop()
        except Exception as e:  # noqa: BLE001 — counted, the thread ends
            contained_crash("serving.batcher", e)

    def _batch_loop(self) -> None:
        while True:
            with self._pserve_cond:
                while not self._pending and not self._stop.is_set():
                    self._pserve_cond.wait(0.1)
                if self._stop.is_set():
                    return
                # the first pending request opens the window; later ones
                # ride along until it closes or the row budget fills. Both
                # limits are read on every wake-up, so ``set_batch_limits``
                # also closes a window that is open
                opened = time.monotonic()
                while (sum(r[1]["obs"].shape[0] for r in self._pending)
                        < self.max_batch_rows):
                    remaining = opened + self.batch_window_s - time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        break
                    self._pserve_cond.wait(remaining)
                batch = self._pop_batch_locked()
                actor = self._actor
                gen, ver = self._generation, self._version
                pub_ts = self._published_ts
            if batch:
                self._serve_batch(batch, actor, gen, ver, pub_ts)

    def _serve_batch(self, batch: list, actor, gen: int, ver: int,
                     pub_ts: float | None) -> None:
        """One fused forward for a popped batch, outside the serving
        condition (compute and socket writes never hold it)."""
        rows = sum(req["obs"].shape[0] for _, req, _ in batch)
        if actor is None:
            for conn, req, _ in batch:
                self._write_response(conn, req, protocol.encode_response(
                    req["req_id"], protocol.STATUS_NO_PARAMS, gen, ver, None))
            with self._pserve_cond:
                self.stats["batches"] += 1
                self.stats["no_params"] += len(batch)
            return
        bucket = _next_pow2(rows)
        fused = np.zeros((bucket, self._obs_dim), np.float32)
        np.concatenate([req["obs"] for _, req, _ in batch], axis=0,
                       out=fused[:rows])
        mu = act_deterministic(
            actor, torch.from_numpy(fused).to(self.device)).cpu().numpy()
        now = time.monotonic()
        ok = 0
        off = 0
        for conn, req, t_enq in batch:
            n = req["obs"].shape[0]
            frame = protocol.encode_response(
                req["req_id"], protocol.STATUS_OK, gen, ver, mu[off:off + n])
            off += n
            if self.chaos is not None:
                frame = self.chaos.maybe_tear(req["req_id"], frame)
            if self._write_response(conn, req, frame):
                ok += 1
            self._latency_ms.append(1e3 * (now - t_enq))
        breach = (pub_ts is not None
                  and (now - pub_ts) > self.sla_staleness_s)
        late = 0
        if self.sla_latency_ms is not None:
            late = sum(1 for _, _, t_enq in batch
                       if 1e3 * (now - t_enq) > self.sla_latency_ms)
        with self._pserve_cond:
            self.stats["batches"] += 1
            self.stats["rows"] += rows
            self.stats["padded_rows"] += bucket - rows
            self.stats["responses_ok"] += ok
            if breach:
                self.stats["sla_breaches"] += 1
            self.stats["latency_breaches"] += late
            self._occupancy.append(rows / bucket)
            self._batch_rows.append(rows)

    def _write_response(self, conn: socket.socket, req: dict,
                        frame: bytes) -> bool:
        try:
            self._send(conn, frame)
        except OSError:
            with self._pserve_cond:
                self.stats["write_errors"] += 1
            if req["trace"] is not None:
                RECORDER.terminal_shed(req["trace"][0])
            return False
        if req["trace"] is not None:
            RECORDER.record_span(req["trace"][0], "commit")
        return True

    # -- observability ------------------------------------------------------
    def serving_stats(self) -> dict:
        """The ``serving`` registry provider: one snapshot under the
        serving condition."""
        with self._pserve_cond:
            out = dict(self.stats)
            out["queue_depth"] = len(self._pending)
            out["admission_rejects_by_class"] = dict(
                self.admission_rejects_by_class)
            out["admission_depth"] = self.admission_depth
            out["batch_window_s"] = self.batch_window_s
            out["max_batch_rows"] = self.max_batch_rows
            out["generation"] = self._generation
            out["version"] = self._version
            out["staleness_s"] = (
                None if self._published_ts is None
                else round(time.monotonic() - self._published_ts, 6))
            out["sla_staleness_s"] = self.sla_staleness_s
            out["batch_occupancy"] = percentile_summary(list(self._occupancy))
            out["batch_rows"] = percentile_summary(list(self._batch_rows))
            out["latency_ms"] = percentile_summary(list(self._latency_ms))
        if self.chaos is not None:
            out["torn_injected"] = self.chaos.torn_injected
        return out

    def close(self) -> None:
        self._stop.set()
        with self._pserve_cond:
            self._pserve_cond.notify_all()
        try:
            self._server.close()
        except OSError:
            pass
        self._shutdown_conns()
        self._batch_thread.join(timeout=5.0)
        self._refresh_thread.join(timeout=5.0)
        self._accept_thread.join(timeout=5.0)
        for t in self._conn_threads:
            t.join(timeout=2.0)
        # pending requests die with the server: traced ones get their end
        with self._pserve_cond:
            leftovers = list(self._pending)
            self._pending.clear()
        for _, req, _ in leftovers:
            if req["trace"] is not None:
                RECORDER.terminal_shed(req["trace"][0])
        record_event("serving_server_closed", port=self.port,
                     requests=self.stats["requests"])
        REGISTRY.unregister_provider("serving", self.serving_stats)
