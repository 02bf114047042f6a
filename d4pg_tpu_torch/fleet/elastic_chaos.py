"""Elastic-chaos drill: a flash crowd against the autoscaler, A/B.

Counterpart of ``d4pg_tpu/fleet/elastic_chaos.py``. The same seeded
offered load (``elastic/traffic.py``: the flash crowd scripted into the
model, every lane's schedule a recurrence over its own model clock) runs
through two arms:

  - **static**: the serving batcher and the ingest deques pinned at a
    modest capacity, per-class admission doing the shedding;
  - **elastic**: the same, plus an ``Autoscaler`` sensing the planes and
    moving the serving batch limits and the ingest deque depth live,

and the A/B gate compares their SLO ledgers: the elastic arm must show
strictly fewer serving SLO breaches (staleness plus queueing latency) and
strictly fewer ingest shed rows at equal offered load. The gate is a
measured claim (it depends on the host's timing), not a correctness
check.

Load comes from light pumps: a request pump speaks the raw serving wire
(req_ids tagged with the lane, a bounded pipeline window, so a flash
queues at the server) and an ingest pump drives ``ReplayService.add``
in process at the model's row rates, while a consumer samples chunks so
the commit drain contends for the buffer lock as under training.

The standing oracles ride along: lock-hierarchy violations, contained
crashes and trace orphans (at sample rate 1.0) all 0, the arms' draw
ledgers equal (the same offered load), and the elastic arm's ledger
replaying its decisions from its recorded signals
(``autoscaler.replay_matches``).

Device: the policy server answers on ``ElasticChaosConfig.device``
(``cuda`` by default; the tests ask for the CPU). The weights are the
port's ``init_state`` from the config's seed.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.transport import _recv_exact
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.elastic import (
    AdmissionPolicy,
    Autoscaler,
    AutoscalerConfig,
    ScalingLedger,
    TrafficConfig,
    TrafficModel,
)
from d4pg_tpu_torch.elastic.autoscaler import replay_matches
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.learner.update import act_deterministic
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.draw_ledger import LEDGER
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.registry import REGISTRY, percentile_summary
from d4pg_tpu_torch.obs.trace import RECORDER as TRACE
from d4pg_tpu_torch.obs.trace import new_trace_id
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch
from d4pg_tpu_torch.serving import PolicyInferenceServer, protocol


@dataclasses.dataclass(frozen=True)
class ElasticChaosConfig:
    """One A/B drill. Offered load is pinned by model time: each pump runs
    until its model clock crosses ``model_horizon_s``, so both arms offer
    the same request and row schedule however fast each serves it."""

    # serving-side request pumps
    n_lanes: int = 16
    rows_per_req: int = 8
    base_req_per_s: float = 60.0   # per lane, at multiplier 1.0
    pipeline_window: int = 4       # in-flight requests per lane
    # ingest-side row pumps
    n_ingest_lanes: int = 8
    block_rows: int = 64
    base_ingest_rows_per_s: float = 2500.0  # per lane
    # the scripted flash crowd (model seconds)
    model_horizon_s: float = 3.0
    flash_start_s: float = 1.0
    flash_duration_s: float = 0.8
    flash_amp: float = 8.0
    # the static arm's knobs (modest: the flash must exceed them)
    static_max_batch_rows: int = 8
    static_batch_window_s: float = 0.002
    static_ingest_capacity: int = 24   # batches per shard deque
    shed_watermark: float = 0.75
    # SLOs and admission
    sla_latency_ms: float = 25.0
    admission_depth: int = 96
    # the elastic arm's ceilings
    serving_rows_max: int = 256
    ingest_capacity_max: int = 512
    autoscaler_interval_s: float = 0.05
    # the learner-contention consumer (the same in both arms)
    consume_chunk_k: int = 8
    consume_batch: int = 64
    env_horizon: int = 50
    hidden: tuple = (32, 32)
    n_atoms: int = 11
    seed: int = 0
    # where the policy server's forward runs (``cuda`` unless asked)
    device: str = "cuda"

    def agent_config(self) -> D4PGConfig:
        """A tiny real network (PointMass dims): the server runs a real
        ``act_deterministic``, not a stub."""
        return D4PGConfig(obs_dim=4, act_dim=2, v_min=-50.0, v_max=0.0,
                          n_atoms=self.n_atoms, hidden=tuple(self.hidden))

    def serving_traffic(self) -> TrafficConfig:
        return TrafficConfig(
            seed=self.seed, n_actors=self.n_lanes,
            base_rows_per_sec=self.base_req_per_s * self.rows_per_req,
            diurnal_amp=0.1, diurnal_period_s=self.model_horizon_s * 4,
            flash_schedule=((self.flash_start_s, self.flash_duration_s,
                             self.flash_amp),),
            horizon_s=self.model_horizon_s)

    def ingest_traffic(self) -> TrafficConfig:
        return TrafficConfig(
            seed=self.seed + 1, n_actors=self.n_ingest_lanes,
            base_rows_per_sec=self.base_ingest_rows_per_s,
            diurnal_amp=0.1, diurnal_period_s=self.model_horizon_s * 4,
            flash_schedule=((self.flash_start_s, self.flash_duration_s,
                             self.flash_amp),),
            horizon_s=self.model_horizon_s)

    def autoscaler_config(self) -> AutoscalerConfig:
        return AutoscalerConfig(
            interval_s=self.autoscaler_interval_s,
            serving_rows_init=self.static_max_batch_rows,
            serving_rows_min=self.static_max_batch_rows,
            serving_rows_max=self.serving_rows_max,
            serving_window_hot_s=0.0005,
            serving_window_cold_s=self.static_batch_window_s,
            queue_high=4, queue_low=1,
            latency_high_ms=0.5 * self.sla_latency_ms,
            latency_low_ms=0.1 * self.sla_latency_ms,
            ingest_capacity_init=self.static_ingest_capacity,
            ingest_capacity_min=self.static_ingest_capacity,
            ingest_capacity_max=self.ingest_capacity_max,
            ingest_high=0.5, ingest_low=0.1,
            cooldown_ticks=2)


class _RequestPump:
    """One serving lane: raw protocol over one socket, req_ids tagged
    with the lane id (the server's admission class derives from exactly
    those bits), a bounded pipeline window, model-clock pacing."""

    def __init__(self, lane: int, cfg: ElasticChaosConfig, port: int,
                 rate_fn, stop: threading.Event):
        self.lane = lane
        self.cfg = cfg
        self.port = port
        self.rate_fn = rate_fn
        self.stop = stop
        self.counters = {"sent": 0, "served": 0, "overload": 0,
                         "no_params": 0, "errors": 0}
        # (model_t, latency_ms, status) per completed request
        self.records: list[tuple[float, float, int]] = []
        self.model_t = 0.0
        self._inflight: list[tuple[int, float, float]] = []
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"elastic-pump-{lane}")

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)

    def run(self) -> None:
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("elastic.request_pump", e)

    def _read_one(self, sock: socket.socket) -> bool:
        body = protocol.read_frame(sock, protocol.MAGIC_RESPONSE,
                                   _recv_exact)
        if body is None:
            return False
        rsp = protocol.decode_response(body)
        now = time.monotonic()
        for i, (rid, t0, mt) in enumerate(self._inflight):
            if rid == rsp["req_id"]:
                del self._inflight[i]
                self.records.append((mt, 1e3 * (now - t0), rsp["status"]))
                break
        if rsp["status"] == protocol.STATUS_OK:
            self.counters["served"] += 1
        elif rsp["status"] == protocol.STATUS_OVERLOAD:
            self.counters["overload"] += 1
        elif rsp["status"] == protocol.STATUS_NO_PARAMS:
            self.counters["no_params"] += 1
        else:
            self.counters["errors"] += 1
        return True

    def _run(self) -> None:
        cfg = self.cfg
        sock = socket.create_connection(("127.0.0.1", self.port),
                                        timeout=30.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        obs = np.zeros((cfg.rows_per_req, 4), np.float32)
        counter = 0
        next_t = time.monotonic()
        try:
            while self.model_t < cfg.model_horizon_s \
                    and not self.stop.is_set():
                rate = max(1e-6, float(self.rate_fn(self.model_t)))
                period = cfg.rows_per_req / rate
                req_id = ((self.lane & 0xFFF) << 20) | (counter & 0xFFFFF)
                counter += 1
                tid = new_trace_id(self.lane)
                t0 = time.monotonic()
                sock.sendall(protocol.encode_request(
                    req_id, obs, trace=(tid, t0)))
                self.counters["sent"] += 1
                self._inflight.append((req_id, t0, self.model_t))
                self.model_t += period
                while len(self._inflight) > cfg.pipeline_window:
                    if not self._read_one(sock):
                        return
                next_t += period
                wait = next_t - time.monotonic()
                if wait > 0:
                    self.stop.wait(wait)
                else:
                    next_t = time.monotonic()  # behind: no catch-up burst
            while self._inflight:
                if not self._read_one(sock):
                    return
        except (OSError, protocol.ProtocolError):
            self.counters["errors"] += 1
        finally:
            try:
                sock.close()
            except OSError:
                pass


class _IngestPump:
    """One ingest lane: paced in-process ``service.add`` at the model's
    row rates (the transport slice is the ingest harness's business —
    here the service's admission/shed path is the subject)."""

    def __init__(self, lane: int, cfg: ElasticChaosConfig,
                 service: ReplayService, template: TransitionBatch,
                 rate_fn, stop: threading.Event):
        self.lane = lane
        self.cfg = cfg
        self.service = service
        self.template = template
        self.rate_fn = rate_fn
        self.stop = stop
        self.blocks_offered = 0
        self.blocks_rejected = 0
        self.model_t = 0.0
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"elastic-ingest-{lane}")

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)

    def run(self) -> None:
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("elastic.ingest_pump", e)

    def _run(self) -> None:
        cfg = self.cfg
        next_t = time.monotonic()
        while self.model_t < cfg.model_horizon_s and not self.stop.is_set():
            rate = max(1e-6, float(self.rate_fn(self.model_t)))
            period = cfg.block_rows / rate
            self.model_t += period
            self.blocks_offered += 1
            if not self.service.add(self.template,
                                    actor_id=f"elastic-{self.lane}",
                                    block=False):
                self.blocks_rejected += 1
            next_t += period
            wait = next_t - time.monotonic()
            if wait > 0:
                self.stop.wait(wait)
            else:
                next_t = time.monotonic()


def _consumer(service: ReplayService, cfg: ElasticChaosConfig,
              stop: threading.Event) -> None:
    """Learner-contention lane: hammer the sample path so the commit
    drain contends for the buffer lock exactly as it does under a real
    training loop. Identical in both arms — contention is part of the
    environment, not the treatment."""
    try:
        while not stop.is_set():
            if len(service) >= cfg.consume_batch:
                service.sample_chunk(cfg.consume_chunk_k, cfg.consume_batch)
            else:
                stop.wait(0.002)
    except Exception as e:  # noqa: BLE001 — top frame of the lane
        contained_crash("elastic.consumer", e)


def _synth_block(cfg: ElasticChaosConfig) -> TransitionBatch:
    n = cfg.block_rows
    rng = np.random.default_rng(cfg.seed)
    return TransitionBatch(
        obs=rng.standard_normal((n, 4)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, 4)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32),
    )


def _curves(pumps: list[_RequestPump], cfg: ElasticChaosConfig,
            bins: int = 12) -> list[dict]:
    """Offered-vs-served + SLO-compliance curve over model time: per
    bin, requests offered, served OK, overload-rejected, and the
    fraction of served requests inside the latency SLO."""
    edges = np.linspace(0.0, cfg.model_horizon_s, bins + 1)
    out = []
    for b in range(bins):
        lo, hi = float(edges[b]), float(edges[b + 1])
        offered = served = rejected = within = 0
        for p in pumps:
            for mt, lat, status in p.records:
                if lo <= mt < hi:
                    offered += 1
                    if status == protocol.STATUS_OK:
                        served += 1
                        if lat <= cfg.sla_latency_ms:
                            within += 1
                    elif status == protocol.STATUS_OVERLOAD:
                        rejected += 1
        out.append({
            "t": round(0.5 * (lo + hi), 4),
            "offered": offered,
            "served": served,
            "rejected": rejected,
            "slo_compliance": round(within / served, 4) if served else None,
        })
    return out


def _run_arm(cfg: ElasticChaosConfig, elastic: bool,
             device: torch.device) -> dict:
    """One arm: the same offered load and environment; the autoscaler
    runs only when ``elastic``."""
    agent_cfg = cfg.agent_config()
    # a fresh draw-count window per arm: every counted draw in it is a
    # construction-time TrafficModel draw (config-deterministic), so the
    # gate can pin the whole digest across arms
    LEDGER.reset(armed=True)
    policy = AdmissionPolicy()
    store = WeightStore()
    store.publish(init_state(agent_cfg, cfg.seed, device).actor, step=0,
                  to_host=False)
    server = PolicyInferenceServer(
        agent_cfg, store, port=0, device="default", learner_device=device,
        batch_window_s=cfg.static_batch_window_s,
        max_batch_rows=cfg.static_max_batch_rows,
        sla_staleness_s=1e9,  # latency is the SLO under test, not age
        refresh_interval_s=0.02,
        admission=policy, admission_depth=cfg.admission_depth,
        sla_latency_ms=cfg.sla_latency_ms)
    service = ReplayService(
        ReplayBuffer(8192, 4, 2, seed=cfg.seed),
        ingest_capacity=cfg.static_ingest_capacity,
        shed_watermark=cfg.shed_watermark,
        admission=policy)

    autoscaler = None
    if elastic:
        autoscaler = Autoscaler(
            cfg.autoscaler_config(),
            actuators={
                "serving_rows":
                    lambda v: server.set_batch_limits(max_rows=v),
                "serving_window_s":
                    lambda v: server.set_batch_limits(window_s=v),
                "ingest_capacity": service.set_ingest_depth,
            },
            ledger=ScalingLedger(),
            register_provider=False,
        ).start()

    stop = threading.Event()
    consumer = threading.Thread(target=_consumer,
                                args=(service, cfg, stop), daemon=True,
                                name="elastic-consumer")
    consumer.start()

    serving_model = TrafficModel(cfg.serving_traffic())
    ingest_model = TrafficModel(cfg.ingest_traffic())
    template = _synth_block(cfg)
    ingest_pumps = [
        _IngestPump(i, cfg, service, template, ingest_model.rate_fn(i),
                    stop)
        for i in range(cfg.n_ingest_lanes)
    ]
    pumps = [
        _RequestPump(i, cfg, server.port, serving_model.rate_fn(i), stop)
        for i in range(cfg.n_lanes)
    ]
    t0 = time.monotonic()
    for p in ingest_pumps:
        p.start()
    for p in pumps:
        p.start()
    budget = max(30.0, 20.0 * cfg.model_horizon_s)
    for p in pumps:
        p.join(budget)
    for p in ingest_pumps:
        p.join(budget)
    wall_s = time.monotonic() - t0
    stop.set()
    consumer.join(timeout=5.0)
    if autoscaler is not None:
        autoscaler.close()
    service.flush(timeout=10.0)

    sstats = server.serving_stats()
    istats = service.ingest_stats()
    counters: dict = {}
    latencies: list[float] = []
    for p in pumps:
        for k, v in p.counters.items():
            counters[k] = counters.get(k, 0) + v
        latencies.extend(lat for _, lat, st in p.records
                         if st == protocol.STATUS_OK)
    arm = {
        "wall_s": round(wall_s, 3),
        "requests": counters,
        "request_latency_ms": percentile_summary(latencies),
        "curves": _curves(pumps, cfg),
        "serving": {
            "sla_breaches": sstats["sla_breaches"],
            "latency_breaches": sstats["latency_breaches"],
            "admission_rejects": sstats["admission_rejects"],
            "admission_rejects_by_class":
                sstats["admission_rejects_by_class"],
            "responses_ok": sstats["responses_ok"],
            "batches": sstats["batches"],
            "max_batch_rows": sstats["max_batch_rows"],
            "batch_window_s": sstats["batch_window_s"],
            "latency_ms": sstats["latency_ms"],
        },
        "ingest": {
            "rows_committed": istats["rows_committed"],
            "sheds": istats["sheds"],
            "shed_rows": istats["shed_rows"],
            "sheds_by_class": istats["sheds_by_class"],
            "admit_fails": istats["admit_fails"],
            "ingest_capacity": istats["ingest_capacity"],
            "blocks_offered": sum(p.blocks_offered for p in ingest_pumps),
            "blocks_rejected": sum(p.blocks_rejected for p in ingest_pumps),
        },
    }
    if autoscaler is not None:
        astats = autoscaler.autoscaler_stats()
        arm["autoscaler"] = {
            "ticks": astats["ticks"],
            "decisions": astats["decisions"],
            "actuations": astats["actuations"],
            "actuator_errors": astats["actuator_errors"],
            "final_targets": astats["targets"],
            "ledger_digest": astats["ledger_digest"],
            "ledger_records": astats["ledger_records"],
            "ledger_replay_ok": replay_matches(cfg.autoscaler_config(),
                                               autoscaler.ledger),
            "ledger_tail": autoscaler.ledger.to_jsonable(tail=8),
        }
    arm["draw_ledger"] = LEDGER.export()
    server.close()
    service.close()
    return arm


def run_elastic_chaos(cfg: ElasticChaosConfig | None = None, **overrides
                      ) -> dict:
    """Run the A/B drill and return its report (the reference's drill
    block). The lock plane runs in record mode: a violation is counted,
    not raised."""
    cfg = dataclasses.replace(cfg or ElasticChaosConfig(), **overrides)
    device = resolve_device(cfg.device)
    with locking.record_mode():
        return _run(cfg, device)


def _run(cfg: ElasticChaosConfig, device: torch.device) -> dict:
    agent_cfg = cfg.agent_config()
    violations_before = locking.violation_count()
    crashes_before = REGISTRY.counter("threads.contained_crashes").value
    TRACE.reset()
    TRACE.enable(sample_rate=1.0)
    record_event("elastic_chaos_start", n_lanes=cfg.n_lanes,
                 flash_amp=cfg.flash_amp, seed=cfg.seed)

    # warm every power-of-two bucket both arms can reach: the first
    # forward at a new shape (the card's kernel choice) must not pass for
    # a queueing-latency breach in whichever arm meets it first
    actor = init_state(agent_cfg, cfg.seed, device).actor
    b = 1
    while b <= cfg.serving_rows_max:
        act_deterministic(actor, torch.zeros((b, 4), device=device)).cpu()
        b *= 2

    arms = {"static": _run_arm(cfg, elastic=False, device=device),
            "elastic": _run_arm(cfg, elastic=True, device=device)}

    def slo(arm: dict) -> int:
        return (arm["serving"]["sla_breaches"]
                + arm["serving"]["latency_breaches"])

    gate = {
        "slo_breaches_static": slo(arms["static"]),
        "slo_breaches_elastic": slo(arms["elastic"]),
        "shed_rows_static": arms["static"]["ingest"]["shed_rows"],
        "shed_rows_elastic": arms["elastic"]["ingest"]["shed_rows"],
        # equal-seeded-load oracle: both arms constructed their traffic
        # models from the same config, so their counted RNG draw
        # histories must hash identically — a mismatch means the arms
        # were not compared under the same offered load
        "draw_digest_equal": (arms["static"]["draw_ledger"]["digest"]
                              == arms["elastic"]["draw_ledger"]["digest"]),
    }
    gate["pass"] = bool(
        gate["slo_breaches_elastic"] < gate["slo_breaches_static"]
        and gate["shed_rows_elastic"] < gate["shed_rows_static"]
        and gate["draw_digest_equal"])

    trace_block = TRACE.latency_block()
    TRACE.disable()
    report = {
        "metric": "elastic_chaos",
        "schema": 1,
        "n_lanes": cfg.n_lanes,
        "n_ingest_lanes": cfg.n_ingest_lanes,
        "model_horizon_s": cfg.model_horizon_s,
        "flash": {"start_s": cfg.flash_start_s,
                  "duration_s": cfg.flash_duration_s,
                  "amp": cfg.flash_amp},
        "sla_latency_ms": cfg.sla_latency_ms,
        "arms": arms,
        "ab_gate": gate,
        "hierarchy_violations":
            locking.violation_count() - violations_before,
        "contained_crashes":
            REGISTRY.counter("threads.contained_crashes").value
            - crashes_before,
        "trace": {
            "orphans": trace_block["orphans"],
            "n_traces": trace_block["n_traces"],
            "completed": trace_block["completed"],
            "shed": trace_block["shed"],
            "overflow": trace_block["overflow"],
        },
        "seed": cfg.seed,
    }
    TRACE.reset()
    return report
