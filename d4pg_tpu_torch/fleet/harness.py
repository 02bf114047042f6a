"""The fleet harness: N chaos-wrapped sender lanes against ONE replay service.

Counterpart of ``d4pg_tpu/fleet/harness.py``. The harness runs the
fan-out (real TCP, real frames, seeded faults) and reports what the
ingest plane does under it:

  - rows/s actually inserted,
  - p50/p99 send latency across every lane,
  - every loss, named: chaos drops, backpressure drops (sender-side
    timeout sheds), receiver sheds (oldest-batch watermark evictions),
  - recovery: crash -> first delivered block per lane, and the service's
    own eviction -> re-admission intervals,
  - a deadlock verdict (all lanes joined, drain alive, queue drained),
  - with service chaos, the supervisor's kills, restarts and MTTR,
  - the lock plane's per-tier counters and hierarchy violations, run in
    record mode (``core.locking``).

Lanes are threads by default (a 256-lane fleet on one host); ``mode=
'process'`` spawns subprocesses running the same loop and ``mode='actor'``
real ``actor_main`` processes. Chaos is seeded and index-deterministic
(``fleet/chaos.py``), so a run's fault script replays bit for bit; use
``max_ticks`` (instead of ``duration_s``) to make two runs' scripts
comparable end to end. The whole plane is host work: no tensor of a run
lies on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import numpy as np

from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.transport import TransitionReceiver
from d4pg_tpu_torch.elastic.traffic import TrafficConfig, TrafficModel
from d4pg_tpu_torch.fleet.chaos import ChaosConfig, ChaosPolicy, StallGate
from d4pg_tpu_torch.fleet.sender import ThrottledSender, synthetic_block
from d4pg_tpu_torch.obs import draw_ledger as obs_draw
from d4pg_tpu_torch.obs import flight as obs_flight
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs import trace as obs_trace
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay.uniform import ReplayBuffer

# Default postmortem directory for flight-recorder dumps (deadlock /
# crash / assertion / recorded hierarchy violation); tests and scripts
# pass their own ``flight_dir``.
_EVIDENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "docs", "evidence", "fleet_torch")


@dataclasses.dataclass
class FleetConfig:
    n_actors: int = 8
    duration_s: float = 8.0
    # when set, every lane runs EXACTLY this many ticks and duration_s is
    # ignored — the deterministic mode (chaos scripts align 1:1 across runs)
    max_ticks: int | None = None
    rows_per_sec: float = 20.0  # per-lane offered load
    block_rows: int = 16
    obs_dim: int = 376  # Humanoid-sized rows: comparable to the priced plane
    act_dim: int = 17
    capacity: int = 100_000
    ingest_capacity: int = 64
    shed_watermark: float = 0.75
    heartbeat_timeout: float = 3.0
    evict_every_s: float = 0.5
    send_timeout: float = 1.0
    max_retries: int | None = 4
    # 'thread' | 'process' | 'actor' — 'actor' lanes spawn REAL
    # ``actor_main`` subprocesses (env + policy + n-step folding) against
    # the harness's receiver + a live weight server, closing the
    # "harness drives only the transport slice" gap; chaos injection does
    # not apply there (real actors own their own fault story).
    mode: str = "thread"
    # Sharded ingest plane: K accept/decode/commit shards on the receiver
    # (``ReplayService(num_ingest_shards=K)`` behind a
    # ``TransitionReceiver(num_shards=K)``).
    ingest_shards: int = 1
    # 'auto' | 'npz' | 'raw'. auto resolves to the sharded plane's native
    # v2 raw-column frames when ingest_shards > 1 (their fixed header is
    # what zero-decode admission/routing needs) and to the legacy npz
    # frames at K=1, so a K=1 sweep row measures the single-receiver
    # plane.
    codec: str = "auto"
    # Run the receiver's tiered locks (core/locking.py) with hierarchy
    # assertions in RECORD mode + contention counting: the report gains a
    # ``locks`` block (per-tier acquisitions/contended/wait_ns/max_hold_ns
    # and the hierarchy-violation count, which every committed artifact
    # must show as 0). Record mode, not raise: a raise inside a shard
    # worker would read as a deadlock instead of a named violation.
    lock_debug: bool = True
    # Wire-to-grad tracing (obs/trace): fraction of frames each
    # lane samples with a trace id + birth timestamp in the v2 header
    # extension. 0 (default) keeps the plane exactly as shipped; > 0
    # requires the raw codec to carry spans (npz frames are never
    # traced) and arms the receiver-side recorder + a consumer lane that
    # concurrently samples the service (so committed rows get a real
    # grad-consumption mark, and the chaos run exercises the sample path
    # under ingest load — previously untested concurrency).
    trace_sample: float = 0.0
    # Consumer-lane sampling cadence (Hz) when tracing is armed.
    consume_hz: float = 50.0
    # Flight-recorder dump directory (None = docs/evidence/fleet_torch). Dumps
    # fire on deadlock, run exception, or a recorded lock-hierarchy
    # violation — the chaos postmortem.
    flight_dir: str | None = None
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    template_seed: int = 0
    connect_stagger_s: float = 0.002  # per-lane offset on the connect storm
    # Reconnect-storm guard (service_chaos runs): seeded per-lane upward
    # jitter, uniform in [0, reconnect_jitter_s), on the FIRST retry
    # after a lane loses its connection — a restarted service meets a
    # spread of reconnects instead of n_actors simultaneous handshakes.
    reconnect_jitter_s: float = 0.25
    # 'actor' mode knobs: the env each real actor runs and its pool width
    actor_env: str = "point"
    actor_num_envs: int = 2
    # Elastic traffic plane (elastic/traffic.py): when set, thread-mode
    # lanes pace themselves off the seeded TrafficModel (diurnal curve +
    # flash crowds + heavy-tailed per-actor rates) instead of the flat
    # ``rows_per_sec`` — the offered-load trace replays bit-for-bit from
    # ``traffic.seed``. ``rows_per_sec`` still feeds the demand estimate
    # shown in reports (the traffic model's base rate should match it).
    traffic: TrafficConfig | None = None

    def __post_init__(self):
        if self.mode not in ("thread", "process", "actor"):
            raise ValueError(f"unknown fleet mode {self.mode!r}")
        if self.codec not in ("auto", "npz", "raw"):
            raise ValueError(f"unknown codec {self.codec!r}")
        if self.ingest_shards < 1:
            raise ValueError("ingest_shards must be >= 1")
        if self.chaos.service_chaos_enabled():
            # generation fencing rides the v2 raw header: npz frames
            # carry no generation, so a restarted service could not tell
            # a pre-crash retry from a fresh row — a silent duplicate
            # instead of a declared fence. Refuse the configuration.
            if self.resolved_codec() != "raw":
                raise ValueError(
                    "service_chaos needs codec='raw' (generation fencing "
                    "is a v2 raw-header extension)")
            if self.mode != "thread":
                raise ValueError(
                    "service_chaos supervisor runs in thread mode only")

    def resolved_codec(self) -> str:
        if self.codec != "auto":
            return self.codec
        return "raw" if self.ingest_shards > 1 else "npz"

    def demand_rows_per_sec(self) -> float:
        return self.n_actors * self.rows_per_sec


def _quiesce(service: ReplayService, settle_s: float = 0.25,
             timeout: float = 5.0) -> None:
    """Wait for the in-flight tail: lanes have closed their sockets, but
    their final frames can still be in kernel buffers / receiver threads.
    Returns once the insert counter stops moving for ``settle_s`` (so the
    accounting the report does is over a drained plane), bounded by
    ``timeout``."""
    deadline = time.monotonic() + timeout
    last = service.env_steps
    last_change = time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.05)
        now_steps = service.env_steps
        if now_steps != last:
            last, last_change = now_steps, time.monotonic()
        elif time.monotonic() - last_change >= settle_s:
            return


def _percentiles(values: list[float]) -> dict:
    if not values:
        return {"p50": None, "p99": None, "mean": None, "n": 0}
    arr = np.asarray(values, np.float64)
    return {
        "p50": round(float(np.percentile(arr, 50)), 3),
        "p99": round(float(np.percentile(arr, 99)), 3),
        "mean": round(float(arr.mean()), 3),
        "n": int(arr.size),
    }


def _recovery_stats(samples: list[float]) -> dict:
    if not samples:
        return {"mean_s": None, "max_s": None, "n": 0}
    arr = np.asarray(samples, np.float64)
    return {
        "mean_s": round(float(arr.mean()), 3),
        "max_s": round(float(arr.max()), 3),
        "n": int(arr.size),
    }


class FleetHarness:
    def __init__(self, config: FleetConfig):
        self.config = config
        self.policy = ChaosPolicy(config.chaos)

    # -- observability plane -----------------------------------------------
    def _arm_obs(self) -> None:
        """Reset + arm the flight recorder (always), the draw ledger
        (always — every chaos run reports per-stream RNG draw counts),
        and the trace recorder (when ``trace_sample`` > 0)."""
        cfg = self.config
        obs_draw.LEDGER.reset(armed=True)
        obs_flight.RECORDER.reset()
        obs_flight.record_event(
            "fleet_run_start", n_actors=cfg.n_actors, mode=cfg.mode,
            ingest_shards=cfg.ingest_shards, codec=cfg.resolved_codec(),
            seed=cfg.chaos.seed)
        obs_trace.RECORDER.reset()
        if cfg.trace_sample > 0:
            obs_trace.RECORDER.enable(cfg.trace_sample)

    def _latency_report(self) -> dict | None:
        """Latency block + disarm; None when tracing was off."""
        if self.config.trace_sample <= 0:
            return None
        obs_trace.RECORDER.mark_grad()  # stamp the committed tail
        block = obs_trace.RECORDER.latency_block()
        obs_trace.RECORDER.disable()
        return block

    def _maybe_dump_flight(self, reason: str, extra: dict | None = None
                           ) -> str | None:
        directory = self.config.flight_dir or _EVIDENCE_DIR
        try:
            return obs_flight.RECORDER.dump(directory, reason, extra=extra)
        except OSError as e:  # a failing dump must not mask the failure
            print(f"flight-recorder dump failed: {e}", flush=True)
            return None

    def _start_consumer(self, service_ref,
                        stop: threading.Event) -> threading.Thread | None:
        """The consumer lane: concurrently samples the service like a
        learner would and marks grad consumption for committed traces.
        Only runs when tracing is armed — it changes the plane's
        concurrency profile (sample() under the buffer lock vs the
        commit thread), which untraced runs must not silently gain.
        ``service_ref`` is a zero-arg callable: under service_chaos the
        live service is swapped out by the supervisor mid-run."""
        cfg = self.config
        if cfg.trace_sample <= 0:
            return None
        period = 1.0 / max(1.0, cfg.consume_hz)
        batch = min(64, cfg.block_rows * 4)

        def consume():
            try:
                while not stop.is_set():
                    service = service_ref()
                    if len(service) >= batch:
                        try:
                            service.sample(batch)
                        except (ValueError, RuntimeError):
                            pass  # raced an empty buffer or a dying service
                        obs_trace.RECORDER.mark_grad()
                    stop.wait(period)
            except Exception as e:  # noqa: BLE001 — top frame of the lane
                contained_crash("fleet.consumer", e)

        t = threading.Thread(target=consume, daemon=True,
                             name="fleet-consumer")
        t.start()
        return t

    def _lock_report(self) -> dict | None:
        """Snapshot of the run's lock counters. ``per_lock`` keys are tier names (all shard
        conditions fold into ``shard``, etc.); ``wait_ns`` is contended
        acquisition time — the number that attributes fleet time to lock
        waits in the K-sweep artifact."""
        if not self.config.lock_debug:
            return None
        report = {
            "hierarchy_violations": locking.violation_count(),
            "violation_samples": locking.hierarchy_violations()[:4],
            "per_lock": locking.lock_stats(),
        }
        return report

    # -- shared receiver construction --------------------------------------
    def _make_service(self, obs_dim: int | None = None,
                      act_dim: int | None = None,
                      generation: int = 0) -> ReplayService:
        cfg = self.config
        return ReplayService(
            ReplayBuffer(cfg.capacity,
                         cfg.obs_dim if obs_dim is None else obs_dim,
                         cfg.act_dim if act_dim is None else act_dim),
            ingest_capacity=cfg.ingest_capacity,
            heartbeat_timeout=cfg.heartbeat_timeout,
            shed_watermark=cfg.shed_watermark,
            num_ingest_shards=cfg.ingest_shards,
            generation=generation,
        )

    def _make_receiver(self, service: ReplayService,
                       gate: StallGate | None = None,
                       port: int = 0,
                       generation=None) -> TransitionReceiver:
        """K>1 (or K=1 on the raw codec): shard-aware receiver forwarding
        UNDECODED payloads so decode runs on the owning ingest shard's
        worker — the path that reads the v2 header's trace extension at
        admission. K=1 on npz: the legacy decode-in-connection-thread
        path. ``port``/``generation``: the
        service_chaos supervisor rebinds a restarted receiver on the SAME
        port (SO_REUSEADDR — the fleet's retry path reconnects to the
        address it already has) and arms the generation greeting so
        pre-crash frames fence at admission."""
        cfg = self.config
        if cfg.ingest_shards > 1 or cfg.resolved_codec() == "raw":
            def on_payload(payload, shard, codec):
                if gate is not None:
                    gate.wait()
                service.add_payload(payload, shard=shard, codec=codec)

            return TransitionReceiver(
                lambda b, aid, count: service.add(
                    b, actor_id=aid, block=False, count_env_steps=count),
                host="127.0.0.1", port=port, num_shards=cfg.ingest_shards,
                on_payload=on_payload, generation=generation)

        def on_batch(batch, actor_id, count):
            if gate is not None:
                gate.wait()
            service.add(batch, actor_id=actor_id, block=False,
                        count_env_steps=count)

        return TransitionReceiver(on_batch, host="127.0.0.1", port=port,
                                  generation=generation)

    # -- thread mode -------------------------------------------------------
    def run(self) -> dict:
        """One run in ``config.mode``. With ``lock_debug`` the lock
        sentinels run in record mode for the whole run, their counters
        reset at its start; the mode set before it comes back after."""
        cfg = self.config
        with (locking.record_mode() if cfg.lock_debug
              else contextlib.nullcontext()):
            if cfg.lock_debug:
                locking.reset_stats()
            if cfg.mode == "process":
                return self._run_processes()
            if cfg.mode == "actor":
                return self._run_actors()
            try:
                return self._run_threads()
            except BaseException:
                # crash/assertion postmortem: whatever the ring saw last
                self._maybe_dump_flight("run_exception")
                raise

    def _run_threads(self) -> dict:
        cfg = self.config
        svc_chaos = cfg.chaos.service_chaos_enabled()
        self._arm_obs()
        # Mutable holder: under service_chaos the supervisor SIGKILLs the
        # service and swaps a restored replacement in mid-run; every
        # long-lived thread (monitor, consumer, teardown) reads the live
        # instance through the holder instead of a stale binding.
        holder: dict = {"svc": self._make_service()}
        gate = StallGate()
        gen_ref = (lambda: holder["svc"].generation) if svc_chaos else None
        holder["recv"] = self._make_receiver(holder["svc"], gate,
                                             generation=gen_ref)
        port = holder["recv"].port
        template = synthetic_block(cfg.block_rows, cfg.obs_dim, cfg.act_dim,
                                   seed=cfg.template_seed)
        stop = threading.Event()
        traffic_model = (TrafficModel(cfg.traffic)
                         if cfg.traffic is not None else None)
        lanes = [
            ThrottledSender(
                i, f"fleet-{i}", "127.0.0.1", port, template,
                self.policy.actor_stream(i, f"fleet-{i}"),
                rows_per_sec=cfg.rows_per_sec,
                send_timeout=cfg.send_timeout, max_retries=cfg.max_retries,
                max_ticks=cfg.max_ticks, stop=stop,
                connect_stagger_s=i * cfg.connect_stagger_s,
                codec=cfg.resolved_codec(),
                trace_sample=cfg.trace_sample,
                expect_generation=svc_chaos,
                reconnect_jitter_s=(cfg.reconnect_jitter_s if svc_chaos
                                    else 0.0),
                rate_fn=(traffic_model.rate_fn(i)
                         if traffic_model is not None else None),
            )
            for i in range(cfg.n_actors)
        ]
        threads = [
            # ThrottledSender.run owns the lane's top-frame broad handler
            # and counts the crash
            threading.Thread(target=lane.run, daemon=True,
                             name=f"fleet-lane-{i}")
            for i, lane in enumerate(lanes)
        ]

        monitor_stop = threading.Event()

        def monitor():
            # periodic heartbeat eviction + the seeded receiver-stall script
            try:
                horizon = cfg.duration_s if cfg.max_ticks is None else 3600.0
                stalls = list(self.policy.stall_schedule(horizon))
                t0 = time.monotonic()
                while not monitor_stop.is_set():
                    holder["svc"].evict_dead()
                    now = time.monotonic() - t0
                    if stalls and now >= stalls[0][0]:
                        _, dur = stalls.pop(0)
                        obs_flight.record_event("receiver_stall", dur_s=dur)
                        gate.stall()
                        monitor_stop.wait(dur)
                        gate.resume()
                    monitor_stop.wait(cfg.evict_every_s)
            except Exception as e:  # noqa: BLE001 — top frame of the lane
                contained_crash("fleet.monitor", e)

        monitor_thread = threading.Thread(target=monitor, daemon=True)

        recovery = None
        supervisor_thread = None
        if svc_chaos:
            recovery = {"kills": 0, "restarts": 0, "failed_restarts": 0,
                        "mttr_s": [], "rows_lost_to_crash": 0,
                        "snapshots": 0, "frames_fenced": 0, "rows_fenced": 0}
            supervisor_thread = threading.Thread(
                target=self._supervise, daemon=True,
                name="fleet-supervisor",
                args=(holder, gate, gen_ref, monitor_stop, recovery))

        t_start = time.monotonic()
        steps0 = holder["svc"].env_steps
        for t in threads:
            t.start()
        monitor_thread.start()
        if supervisor_thread is not None:
            supervisor_thread.start()
        consumer_stop = threading.Event()
        consumer_thread = self._start_consumer(lambda: holder["svc"],
                                               consumer_stop)

        deadlocks = 0
        if cfg.max_ticks is not None:
            # deterministic mode: lanes exit on their own tick budget
            budget = (cfg.max_ticks
                      * (cfg.block_rows / cfg.rows_per_sec + cfg.send_timeout)
                      + 10 * (cfg.chaos.restart_delay_s + 1.0) + 30.0)
            for t in threads:
                t.join(timeout=max(0.0, budget - (time.monotonic() - t_start)))
        else:
            stop.wait(cfg.duration_s)
            stop.set()
            for t in threads:
                t.join(timeout=cfg.send_timeout + 10.0)
        stop.set()
        deadlocks += sum(t.is_alive() for t in threads)
        dt = time.monotonic() - t_start

        gate.resume()  # never leave the drain gated during teardown
        monitor_stop.set()
        monitor_thread.join(timeout=5.0)
        if supervisor_thread is not None:
            supervisor_thread.join(timeout=15.0)
        service, receiver = holder["svc"], holder["recv"]
        _quiesce(service)
        receiver.close()
        service.flush(timeout=10.0)
        consumer_stop.set()
        if consumer_thread is not None:
            consumer_thread.join(timeout=5.0)
        rows_inserted = service.env_steps - steps0
        stats = service.ingest_stats()
        if stats["pending"] > 0 or not service._commit_thread.is_alive():
            deadlocks += 1  # drain wedged with accepted batches in flight
        if recovery is not None:
            # the final incarnation's fence counters (killed incarnations
            # were absorbed at their kill instants)
            recovery["frames_fenced"] += stats.get("fenced_frames", 0)
            recovery["rows_fenced"] += stats.get("fenced_rows", 0)
            recovery["final_generation"] = service.generation
        service.close()

        return self._report(lanes=[lane.summary() for lane in lanes],
                            rows_inserted=rows_inserted, dt=dt,
                            service_stats=stats, deadlocks=deadlocks,
                            stalls=gate.stalls, locks=self._lock_report(),
                            recovery=recovery)

    # -- the learner-kill supervisor ---------------------------------------
    def _supervise(self, holder: dict, gate: StallGate, gen_ref,
                   stop_ev: threading.Event, recovery: dict) -> None:
        """Periodic durable snapshots + the seeded kill script. Between
        kills the supervisor snapshots the live service every
        ``service_snapshot_every_s`` (the checkpoint cadence); at each
        kill instant it tears the service down ABRUPTLY and restarts it
        from the latest snapshot — rows committed after that cut are the
        declared crash loss, frames from the dead generation fence at
        admission, and MTTR is kill → first row committed by the
        restored incarnation."""
        try:
            self._supervise_run(holder, gate, gen_ref, stop_ev, recovery)
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("fleet.supervisor", e)

    def _supervise_run(self, holder: dict, gate: StallGate, gen_ref,
                       stop_ev: threading.Event, recovery: dict) -> None:
        cfg = self.config
        ch = cfg.chaos
        horizon = cfg.duration_s if cfg.max_ticks is None else 3600.0
        kills = list(self.policy.service_kill_schedule(horizon))
        t0 = time.monotonic()
        snap = holder["svc"].snapshot(quiesce_timeout=0.25)
        recovery["snapshots"] += 1
        next_snap = time.monotonic() + ch.service_snapshot_every_s
        while not stop_ev.is_set():
            now = time.monotonic() - t0
            if kills and now >= kills[0]:
                kills.pop(0)
                self._kill_and_restart(holder, gate, gen_ref, stop_ev,
                                       recovery, snap)
                next_snap = time.monotonic() + ch.service_snapshot_every_s
                continue
            if time.monotonic() >= next_snap:
                try:
                    snap = holder["svc"].snapshot(quiesce_timeout=0.25)
                    recovery["snapshots"] += 1
                except (RuntimeError, ValueError) as e:
                    obs_flight.record_event("snapshot_failed", err=str(e))
                next_snap = time.monotonic() + ch.service_snapshot_every_s
            stop_ev.wait(0.02)

    def _kill_and_restart(self, holder: dict, gate: StallGate, gen_ref,
                          stop_ev: threading.Event, recovery: dict,
                          snap: dict) -> None:
        cfg = self.config
        ch = cfg.chaos
        svc, recv = holder["svc"], holder["recv"]
        port = recv.port
        # the replacement's FLOOR generation: constructor-seeded above the
        # dead incarnation so fencing stays correct even when two kills
        # land between periodic snapshots (restore alone would rewind the
        # id to snapshot-time + 1, un-fencing the first incarnation)
        next_gen = svc.generation + 1
        t_kill = time.monotonic()
        stats = svc.ingest_stats()
        rows_at_kill = svc.env_steps
        obs_flight.record_event("service_kill", generation=svc.generation,
                                env_steps=rows_at_kill)
        recv.close()
        svc.kill()  # abrupt: accepted-but-uncommitted batches die here
        recovery["kills"] += 1
        recovery["frames_fenced"] += stats.get("fenced_frames", 0)
        recovery["rows_fenced"] += stats.get("fenced_rows", 0)
        recovery["rows_lost_to_crash"] += max(
            0, rows_at_kill - int(snap.get("env_steps", 0)))
        backoff = ch.service_restart_backoff_s
        for attempt in range(max(1, ch.service_restart_max)):
            stop_ev.wait(backoff)
            backoff = min(backoff * 2.0, 5.0)
            new = None
            try:
                new = self._make_service(generation=next_gen)
                new.restore(snap)
                # service first, THEN the receiver: a sender racing the
                # swap must never be greeted with the dead generation
                holder["svc"] = new
                holder["recv"] = self._make_receiver(new, gate, port=port,
                                                     generation=gen_ref)
            except OSError as e:
                obs_flight.record_event("service_restart_failed",
                                        attempt=attempt, err=str(e))
                if new is not None:
                    new.kill()
                continue
            recovery["restarts"] += 1
            obs_flight.record_event("service_restart",
                                    generation=new.generation,
                                    attempt=attempt)
            # MTTR: kill instant -> first row COMMITTED by the restored
            # incarnation (not first reconnect — committed rows are what
            # the learner can train on again)
            restored_steps = new.env_steps
            deadline = time.monotonic() + 30.0
            while not stop_ev.is_set() and time.monotonic() < deadline:
                if new.env_steps > restored_steps:
                    recovery["mttr_s"].append(
                        round(time.monotonic() - t_kill, 4))
                    break
                stop_ev.wait(0.005)
            return
        recovery["failed_restarts"] += 1
        obs_flight.record_event("service_restart_exhausted",
                                attempts=ch.service_restart_max)

    # -- process mode ------------------------------------------------------
    def _run_processes(self) -> dict:
        import multiprocessing as mp

        from d4pg_tpu_torch.fleet.sender import _process_lane_main

        cfg = self.config
        self._arm_obs()
        service = self._make_service()
        receiver = self._make_receiver(service)
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue()
        duration = (cfg.duration_s if cfg.max_ticks is None
                    else cfg.max_ticks * cfg.block_rows / cfg.rows_per_sec
                    + 30.0)
        procs = []
        for i in range(cfg.n_actors):
            kwargs = {
                "actor_index": i, "actor_id": f"fleet-{i}",
                "host": "127.0.0.1", "port": receiver.port,
                "chaos_config": dataclasses.asdict(cfg.chaos),
                "block_rows": cfg.block_rows, "obs_dim": cfg.obs_dim,
                "act_dim": cfg.act_dim, "template_seed": cfg.template_seed,
                "rows_per_sec": cfg.rows_per_sec,
                "send_timeout": cfg.send_timeout,
                "max_retries": cfg.max_retries, "max_ticks": cfg.max_ticks,
                "connect_stagger_s": i * cfg.connect_stagger_s,
                "codec": cfg.resolved_codec(),
                # birth stamps use CLOCK_MONOTONIC — one timeline across
                # processes on a host, so subprocess lanes trace fine
                "trace_sample": cfg.trace_sample,
            }
            p = ctx.Process(target=_process_lane_main,
                            args=(kwargs, duration, out_q), daemon=True)
            p.start()
            procs.append(p)
        t_start = time.monotonic()
        steps0 = service.env_steps
        consumer_stop = threading.Event()
        consumer_thread = self._start_consumer(lambda: service, consumer_stop)
        summaries, deadlocks = [], 0
        for _ in procs:
            try:
                summaries.append(out_q.get(timeout=duration + 60.0))
            except Exception:
                deadlocks += 1
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
        dt = time.monotonic() - t_start
        _quiesce(service)
        receiver.close()
        service.flush(timeout=10.0)
        consumer_stop.set()
        if consumer_thread is not None:
            consumer_thread.join(timeout=5.0)
        rows_inserted = service.env_steps - steps0
        stats = service.ingest_stats()
        service.close()
        return self._report(lanes=summaries, rows_inserted=rows_inserted,
                            dt=dt, service_stats=stats, deadlocks=deadlocks,
                            stalls=0, locks=self._lock_report())

    # -- real-actor mode ---------------------------------------------------
    def _run_actors(self) -> dict:
        """Lanes are REAL ``actor_main`` subprocesses: env pool + policy
        inference + n-step folding + ``CoalescingSender`` over real TCP,
        pulling live weights from a ``WeightServer`` — the full actor
        path, not the transport slice (ROADMAP: "fleet lanes driving REAL
        actor processes"). Each lane runs ``max_ticks`` pool steps (so
        offered rows are exact: ticks x num_envs), then the report closes
        the same accounting as the synthetic lanes."""
        import multiprocessing as mp

        from d4pg_tpu_torch.config import ExperimentConfig
        from d4pg_tpu_torch.distributed.weight_server import WeightServer
        from d4pg_tpu_torch.distributed.weights import WeightStore
        from d4pg_tpu_torch.fleet.sender import _actor_lane_main
        from d4pg_tpu_torch.learner.state import init_state
        from d4pg_tpu_torch.train import infer_dims

        cfg = self.config
        self._arm_obs()
        ticks = cfg.max_ticks if cfg.max_ticks is not None else 30
        acfg = ExperimentConfig(
            env=cfg.actor_env, num_envs=cfg.actor_num_envs, n_steps=2,
            max_steps=20, v_min=-5.0, v_max=0.0, hidden=(16, 16), n_atoms=11,
            actor_device="cpu")
        obs_dim, act_dim, _ = infer_dims(acfg)
        service = self._make_service(obs_dim=obs_dim, act_dim=act_dim)
        receiver = self._make_receiver(service)
        store = WeightStore()
        # the lanes act on the CPU: the template params are drawn there
        store.publish(init_state(
            acfg.learner_config(obs_dim, act_dim, device="cpu"),
            cfg.template_seed, "cpu").actor, step=0)
        weight_server = WeightServer(store, host="127.0.0.1")
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue()
        procs = []
        for i in range(cfg.n_actors):
            p = ctx.Process(
                target=_actor_lane_main,
                args=(dataclasses.asdict(acfg), "127.0.0.1", receiver.port,
                      weight_server.port, f"actor-{i}", ticks,
                      cfg.send_timeout, cfg.max_retries, out_q,
                      cfg.resolved_codec(), cfg.trace_sample),
                daemon=True)
            p.start()
            procs.append(p)
        t_start = time.monotonic()
        steps0 = service.env_steps
        consumer_stop = threading.Event()
        consumer_thread = self._start_consumer(lambda: service, consumer_stop)
        summaries, deadlocks = [], 0
        # real actors pay a torch and env import per process: a
        # generous budget
        budget = 120.0 + ticks * cfg.actor_num_envs * 0.05
        for _ in procs:
            try:
                summaries.append(out_q.get(timeout=budget))
            except Exception:
                deadlocks += 1
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
        dt = time.monotonic() - t_start
        _quiesce(service)
        receiver.close()
        weight_server.close()
        service.flush(timeout=10.0)
        consumer_stop.set()
        if consumer_thread is not None:
            consumer_thread.join(timeout=5.0)
        rows_inserted = service.env_steps - steps0
        stats = service.ingest_stats()
        if stats["pending"] > 0 or not service._commit_thread.is_alive():
            deadlocks += 1
        service.close()
        return {
            "n_actors": cfg.n_actors,
            "mode": "actor",
            "locks": self._lock_report(),
            "latency": self._latency_report(),
            "trace_sample": cfg.trace_sample,
            "flight_events": len(obs_flight.RECORDER),
            "actor_env": cfg.actor_env,
            "num_envs": cfg.actor_num_envs,
            "ticks_per_lane": ticks,
            "duration_s": round(dt, 3),
            "rows_inserted": int(rows_inserted),
            "rows_per_sec": round(rows_inserted / dt, 1) if dt else 0.0,
            "lane_env_steps": [s.get("env_steps", 0) for s in summaries],
            "deadlocks": deadlocks,
            "ingest_shards": cfg.ingest_shards,
            "codec": cfg.resolved_codec(),
            "ingest": {k: stats[k] for k in
                       ("sheds", "shed_rows", "decode_errors",
                        "order_breaks", "evictions", "readmissions")},
        }

    # -- artifact ----------------------------------------------------------
    def _report(self, lanes: list[dict], rows_inserted: int, dt: float,
                service_stats: dict, deadlocks: int, stalls: int,
                locks: dict | None = None,
                recovery: dict | None = None) -> dict:
        cfg = self.config
        latencies = [v for lane in lanes for v in lane["latencies_ms"]]
        lane_recovery = [v for lane in lanes for v in lane["recovery_s"]]
        attempted = sum(lane["rows_attempted"] for lane in lanes)
        rows_per_sec = round(rows_inserted / dt, 1) if dt else 0.0
        # publish the headline into the unified registry (gauges survive
        # the run; export() is the one place that sees the whole process)
        REGISTRY.gauge("fleet.rows_per_sec").set(rows_per_sec)
        REGISTRY.gauge("fleet.deadlocks").set(deadlocks)
        latency = self._latency_report()
        flight_dump = None
        violations = locks["hierarchy_violations"] if locks else 0
        if deadlocks > 0 or violations > 0:
            # the chaos postmortem: dump the event ring next to the
            # artifacts so the failure ships its own context
            reason = ("deadlock" if deadlocks > 0
                      else "hierarchy_violation")
            flight_dump = self._maybe_dump_flight(reason, extra={
                "n_actors": cfg.n_actors, "deadlocks": deadlocks,
                "hierarchy_violations": violations,
                "seed": cfg.chaos.seed})
        return {
            "n_actors": cfg.n_actors,
            "mode": cfg.mode,
            "ingest_shards": cfg.ingest_shards,
            "codec": cfg.resolved_codec(),
            "duration_s": round(dt, 3),
            "rows_per_sec": rows_per_sec,
            "rows_per_sec_per_shard": round(
                rows_per_sec / cfg.ingest_shards, 1),
            "demand_rows_per_sec": round(cfg.demand_rows_per_sec(), 1),
            "rows_inserted": int(rows_inserted),
            "rows_attempted": int(attempted),
            "delivery_ratio": (round(rows_inserted / attempted, 4)
                               if attempted else None),
            "send_latency_ms": _percentiles(latencies),
            "drops": {
                "chaos_rows": sum(lane["rows_dropped_chaos"]
                                  for lane in lanes),
                "backpressure_rows": sum(
                    lane["rows_dropped_backpressure"] for lane in lanes),
                "shed_batches": service_stats["sheds"],
                "shed_rows": service_stats["shed_rows"],
            },
            "retries": sum(lane["retries"] for lane in lanes),
            "crashes": sum(lane["crashes"] for lane in lanes),
            "failed_restarts": sum(lane["failed_restarts"] for lane in lanes),
            "recovery": _recovery_stats(lane_recovery),
            "evictions": service_stats["evictions"],
            "readmissions": service_stats["readmissions"],
            "service_recovery": _recovery_stats(service_stats["recovery_s"]),
            "decode_errors": service_stats.get("decode_errors", 0),
            "order_breaks": service_stats.get("order_breaks", 0),
            "per_shard": service_stats.get("per_shard", []),
            "receiver_stalls": stalls,
            "deadlocks": deadlocks,
            "locks": locks,
            # wire-to-grad stage latency block (None when tracing off)
            "latency": latency,
            "trace_sample": cfg.trace_sample,
            "frames_traced": sum(lane.get("frames_traced", 0)
                                 for lane in lanes),
            "flight_dump": flight_dump,
            "flight_events": len(obs_flight.RECORDER),
            # per-stream RNG draw counts + canonical digests: the A/B
            # drivers pin schedule_digest equality across arms
            "draw_ledger": obs_draw.LEDGER.export(),
            "ticks": sum(lane["ticks"] for lane in lanes),
            "chaos": dataclasses.asdict(cfg.chaos),
            "seed": cfg.chaos.seed,
            # crash-recovery plane (None unless service_chaos ran): the
            # supervisor's ledger + the reconnect-storm spread proof
            "service_chaos": self._recovery_block(lanes, recovery),
            "chaos_log": sorted(
                ev for lane in lanes for ev in lane["chaos_log"]),
        }

    @staticmethod
    def _recovery_block(lanes: list[dict],
                        recovery: dict | None) -> dict | None:
        if recovery is None:
            return None
        jitters = [v for lane in lanes
                   for v in lane.get("storm_jitter_s", [])]
        return {
            "kills": recovery["kills"],
            "restarts": recovery["restarts"],
            "failed_restarts": recovery["failed_restarts"],
            "mttr_s": _recovery_stats(recovery["mttr_s"]),
            "snapshots": recovery["snapshots"],
            "rows_lost_to_crash": recovery["rows_lost_to_crash"],
            "frames_fenced": recovery["frames_fenced"],
            "rows_fenced": recovery["rows_fenced"],
            "final_generation": recovery.get("final_generation"),
            # the satellite's spread proof: distinct seeded jitters drawn
            # by distinct lanes on their first post-break retry — a storm
            # that arrived as one thundering herd would show distinct <= 1
            "reconnect_storm": {
                "jitters": len(jitters),
                "distinct": len({round(v, 6) for v in jitters}),
                "spread_ms": _percentiles([1e3 * v for v in jitters]),
            },
        }
