"""Serving-chaos fleet harness: the action-inference plane under fire.

Counterpart of ``d4pg_tpu/fleet/serving_chaos.py``. The policy server
answers on ``ServingChaosConfig.device`` (``cuda`` by default, raising
without a card; the tests ask for the CPU), and the publisher's actor is
the port's ``init_state`` from the config's seed on the same device. The
lanes, their envs and their fallback policies stay on the host CPU.

The ingest harness proves the actor->learner plane survives faults and
the weight harness proves the learner->actor broadcast does; this module
drills the third wire — the lane->server action path
(``serving/server.py``). One run stands up a publisher feeding a
``WeightStore``, a ``PolicyInferenceServer`` on a fixed port, and N
``VectorActorLane`` threads acting through ``RemotePolicyClient`` while
their transitions flow over the real ingest wire (``CoalescingSender``
-> ``TransitionReceiver`` -> ``ReplayService``), then injects the
serving plane's fault set:

  - **torn responses** — the server corrupts a seeded fraction of
    response payloads after the CRC is computed; every one must be a
    COUNTED client rejection, never an acted-on action batch.
  - **server kill + same-port rebind** — the serving process dies
    mid-flight and a new incarnation rebinds the same port; lanes
    degrade to cached-params fallback (counted, never a stall) and
    MTTR is measured kill -> first response served by the successor.

Three oracles gate the run:

  1. **ledger**: the server's torn-injection ledger intersected with
     the clients' acceptance ledgers must be EMPTY — 0 torn responses
     acted on (the req_id space is partitioned per lane, so the
     intersection is exact, not probabilistic).
  2. **trace**: with the recorder at sample 1.0, every admitted request
     must terminate (commit, write-failure shed, or teardown shed) —
     0 orphans across kills.
  3. **locks**: the run executes under lock-hierarchy record mode
     (``core.locking.record_mode``) —
     0 new violations across the pserve tier and everything it meets.

Liveness is the implicit fourth: the run finishing its drain phase with
every lane still producing served actions means no deadlock and no
unbounded stall — the degradation ladder, not the wire, absorbed every
fault.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.transport import (
    CoalescingSender,
    TransitionReceiver,
)
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.envs.fake import PointMassEnv
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.registry import percentile_summary
from d4pg_tpu_torch.obs.trace import RECORDER as TRACE
from d4pg_tpu_torch.replay.uniform import ReplayBuffer
from d4pg_tpu_torch.serving import (
    ActorConfig,
    PolicyInferenceServer,
    RemotePolicyClient,
    ServingChaos,
    VectorActorLane,
)


@dataclasses.dataclass(frozen=True)
class ServingChaosConfig:
    """One serving-chaos run. ``torn_prob`` is per served response; the
    kill count is scheduled at seeded-jittered instants across the run,
    so a (config, seed) pair replays the same fault script."""

    n_lanes: int = 4
    envs_per_lane: int = 4
    duration_s: float = 4.0
    server_kills: int = 1
    torn_prob: float = 0.05
    request_timeout_s: float = 0.25
    batch_window_s: float = 0.002
    max_batch_rows: int = 256
    publish_hz: float = 20.0
    sla_staleness_s: float = 1.0
    env_horizon: int = 50
    hidden: tuple = (32, 32)
    n_atoms: int = 11
    device: str = "cuda"
    seed: int = 0

    def kill_schedule(self, kills: int, lane: int) -> list[float]:
        """Seeded kill offsets (s): nominally even across the middle
        80% of the run, each jittered +-25% of its slot."""
        if kills <= 0:
            return []
        rng = np.random.default_rng(
            np.random.SeedSequence(self.seed, spawn_key=(0xD4E4, lane)))
        span = 0.8 * self.duration_s
        slot = span / kills
        return sorted(0.1 * self.duration_s + (i + 0.5) * slot
                      + float(rng.uniform(-0.25, 0.25)) * slot
                      for i in range(kills))

    def agent_config(self) -> D4PGConfig:
        """Tiny real network (PointMass dims) — the server dispatches
        the genuine deterministic actor, not a stub."""
        return D4PGConfig(obs_dim=4, act_dim=2, v_min=-50.0, v_max=0.0,
                          n_atoms=self.n_atoms, hidden=tuple(self.hidden))


class _ParamPublisher:
    """The synthetic learner: publishes seeded mutations of REAL
    ``init_state`` actor params at ``publish_hz``. Unlike the weight
    drill, a serving-server kill does NOT kill the store — the learner
    survives; only the inference tier dies — so one store lives for the
    whole run and doubles as every client's fallback-params handle."""

    def __init__(self, cfg: ServingChaosConfig, agent_cfg: D4PGConfig,
                 device: torch.device):
        self._rng = np.random.default_rng(
            np.random.SeedSequence(cfg.seed, spawn_key=(0xD4E5,)))
        self._hz = cfg.publish_hz
        self._actor = init_state(agent_cfg, cfg.seed, device).actor
        self._actor.requires_grad_(False)
        self.store = WeightStore()
        self.publishes = 0
        self._pub_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def publish_once(self) -> None:
        with self._pub_lock:
            rng = self._rng
            for p in self._actor.parameters():
                p.add_(torch.from_numpy(np.asarray(
                    0.01 * rng.standard_normal(tuple(p.shape)), np.float32)
                ).to(p.device))
            self.store.publish(self._actor, step=self.publishes,
                               to_host=False)
            self.publishes += 1

    def _run(self) -> None:
        try:
            interval = 1.0 / self._hz
            while not self._stop.is_set():
                self.publish_once()
                self._stop.wait(interval)
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("chaos.param_publisher", e)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class _SenderSink:
    """``VectorActorLane.service`` adapter over a ``CoalescingSender``:
    the lane's folded batches ride the real ingest wire. ``send``
    already returns False on a counted drop, which is exactly the
    lane's dropped-batch contract."""

    def __init__(self, sender: CoalescingSender):
        self.sender = sender

    def add(self, batch, actor_id: str = "lane", block: bool = True,
            timeout: float | None = None,
            count_env_steps: bool = True) -> bool:
        return bool(self.sender.send(batch,
                                     count_env_steps=count_env_steps))

    def close(self) -> None:
        self.sender.close()


class _Lane:
    """One serving lane: EnvPool + RemotePolicyClient + ingest sender,
    stepping on its own thread until told to stop."""

    def __init__(self, index: int, cfg: ServingChaosConfig,
                 agent_cfg: D4PGConfig, serve_port: int, ingest_port: int,
                 store: WeightStore):
        self.index = index
        pool = EnvPool(
            [lambda: PointMassEnv(horizon=cfg.env_horizon)
             for _ in range(cfg.envs_per_lane)],
            seed=cfg.seed * 10_000 + 100 * index)
        self.client = RemotePolicyClient(
            agent_cfg,
            ActorConfig(noise="gaussian", weight_poll_every=16),
            "127.0.0.1", serve_port,
            lane_id=index, seed=cfg.seed * 1_000 + index,
            timeout=cfg.request_timeout_s, connect_timeout=0.5,
            reconnect_backoff=0.05, weights=store,
            trace_sample=1.0, record_ledger=True)
        self.sink = _SenderSink(CoalescingSender(
            "127.0.0.1", ingest_port, actor_id=f"lane{index}",
            retry_timeout=0.2, max_retries=1, drop_on_timeout=True,
            min_block=32, max_block=128, flush_interval=0.05,
            backoff_seed=cfg.seed * 100_003 + index, codec="raw"))
        self.lane = VectorActorLane(
            f"lane{index}", agent_cfg, self.client.cfg, pool, self.sink,
            policy=self.client)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        # one huge budget; the lane's own stop event breaks the loop
        try:
            self.lane.run(1 << 30)
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("chaos.serving_lane", e)

    def stop(self) -> None:
        self.lane.stop()
        self._thread.join(timeout=10.0)

    def close(self) -> None:
        self.lane.close()   # policy + pool
        self.sink.close()


def _sum_stats(total: dict, part: dict) -> None:
    for k, v in part.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            total[k] = total.get(k, 0) + v


def run_serving_chaos(cfg: ServingChaosConfig | None = None, **overrides
                      ) -> dict:
    """Execute one serving-chaos run and return the artifact block."""
    cfg = dataclasses.replace(cfg or ServingChaosConfig(), **overrides)
    device = resolve_device(cfg.device)
    with locking.record_mode():
        return _run(cfg, device)


def _run(cfg: ServingChaosConfig, device: torch.device) -> dict:
    agent_cfg = cfg.agent_config()
    violations_before = locking.violation_count()
    TRACE.reset()
    TRACE.enable(sample_rate=1.0)
    record_event("serving_chaos_start", n_lanes=cfg.n_lanes,
                 kills=cfg.server_kills, seed=cfg.seed)

    pub = _ParamPublisher(cfg, agent_cfg, device)
    pub.publish_once()  # params exist before the first request
    pub.start()

    # one chaos ledger across every server incarnation: the oracle
    # wants the union of injections, whoever served them
    chaos = ServingChaos(torn_response_rate=cfg.torn_prob, seed=cfg.seed)

    def bind_server(port: int) -> PolicyInferenceServer:
        deadline = time.monotonic() + 10.0
        while True:  # the restarted incarnation re-binds the SAME port
            try:
                return PolicyInferenceServer(
                    agent_cfg, pub.store, port=port, device="default",
                    learner_device=device,
                    batch_window_s=cfg.batch_window_s,
                    max_batch_rows=cfg.max_batch_rows,
                    sla_staleness_s=cfg.sla_staleness_s,
                    refresh_interval_s=0.02, chaos=chaos)
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    server = bind_server(0)
    serve_port = server.port

    # real ingest plane behind the lanes (v2 raw frames)
    service = ReplayService(ReplayBuffer(4096, 4, 2), ingest_capacity=256)
    receiver = TransitionReceiver(
        lambda b, aid, count: service.add(b, actor_id=aid, block=False,
                                          count_env_steps=count),
        host="127.0.0.1", port=0,
        on_payload=lambda payload, shard, codec: service.add_payload(
            payload, shard=shard, codec=codec))

    lanes = [_Lane(i, cfg, agent_cfg, serve_port, receiver.port, pub.store)
             for i in range(cfg.n_lanes)]

    retired_server_stats: dict = {}
    all_latency: list[float] = []
    all_occupancy: list[float] = []

    def retire(srv: PolicyInferenceServer) -> None:
        srv.close()
        _sum_stats(retired_server_stats, dict(srv.stats))
        # raw deques outlive close(); percentiles must span every
        # incarnation, not just the survivor
        all_latency.extend(srv._latency_ms)
        all_occupancy.extend(srv._occupancy)

    kill_times = cfg.kill_schedule(cfg.server_kills, lane=1)
    kills_done = 0
    mttr_s: list[float | None] = []

    start = time.monotonic()
    while True:
        now = time.monotonic() - start
        if now >= cfg.duration_s:
            break
        if kill_times and now >= kill_times[0]:
            kill_times.pop(0)
            t_kill = time.monotonic()
            served_before = sum(
                lane.client.stats()["served"] for lane in lanes)
            retire(server)
            server = bind_server(serve_port)
            kills_done += 1
            record_event("serving_chaos_server_kill", port=serve_port,
                         kill=kills_done)
            # MTTR: kill -> first response served by the successor
            mttr_deadline = time.monotonic() + max(5.0, cfg.duration_s)
            recovered = None
            while time.monotonic() < mttr_deadline:
                if sum(lane.client.stats()["served"]
                       for lane in lanes) > served_before:
                    recovered = time.monotonic() - t_kill
                    break
                time.sleep(0.005)
            mttr_s.append(round(recovered, 4)
                          if recovered is not None else None)
        time.sleep(0.01)
    duration = time.monotonic() - start

    # drain: stop tearing responses, require every lane to get at least
    # one more cleanly-served action batch (the ladder climbed back up)
    chaos.torn_response_rate = 0.0
    served_at_drain = [lane.client.stats()["served"] for lane in lanes]
    drain_deadline = time.monotonic() + max(2.0, 0.5 * cfg.duration_s)
    while time.monotonic() < drain_deadline:
        if all(lane.client.stats()["served"] > served_at_drain[i]
               for i, lane in enumerate(lanes)):
            break
        time.sleep(0.02)
    converged = sum(1 for i, lane in enumerate(lanes)
                    if lane.client.stats()["served"] > served_at_drain[i])

    for lane in lanes:
        lane.stop()

    client_stats: dict = {}
    accepted_ids: set[int] = set()
    env_steps = 0
    dropped = 0
    for lane in lanes:
        _sum_stats(client_stats, lane.client.stats())
        accepted_ids |= lane.client.accepted_req_ids or set()
        env_steps += lane.lane.env_steps
        dropped += lane.lane.dropped_batches
        lane.close()

    retire(server)
    receiver.close()
    service.close()
    pub.close()
    time.sleep(0.3)  # conn teardown sheds settle before the trace audit

    torn_acted_on = accepted_ids & chaos.torn_req_ids
    trace_block = TRACE.latency_block()
    TRACE.disable()
    report = {
        "metric": "serving_chaos",
        "schema": 1,
        "n_lanes": cfg.n_lanes,
        "envs_per_lane": cfg.envs_per_lane,
        "duration_s": round(duration, 3),
        "server_kills": kills_done,
        "mttr_s": mttr_s,
        "env_steps": env_steps,
        "actions_per_sec": round(env_steps / duration, 1),
        "publishes": pub.publishes,
        "requests": client_stats.get("requests", 0),
        "served": client_stats.get("served", 0),
        "timeouts": client_stats.get("timeouts", 0),
        "wire_errors": client_stats.get("wire_errors", 0),
        "fallbacks": client_stats.get("fallbacks", 0),
        "warmup_fallbacks": client_stats.get("warmup_fallbacks", 0),
        "no_params": client_stats.get("no_params", 0),
        "reconnects": client_stats.get("reconnects", 0),
        "torn": {
            "injected": chaos.torn_injected,
            "rejected": client_stats.get("torn_rejected", 0),
            "accepted": len(torn_acted_on),
        },
        "server": retired_server_stats,
        "batch_occupancy": percentile_summary(all_occupancy),
        "latency_ms": percentile_summary(all_latency),
        "ingest": {
            "env_steps": service.env_steps,
            "dropped_batches": dropped,
        },
        "lanes_converged": converged,
        "hierarchy_violations": locking.violation_count() - violations_before,
        "trace": {
            "orphans": trace_block["orphans"],
            "n_traces": trace_block["n_traces"],
            "completed": trace_block["completed"],
            "shed": trace_block["shed"],
            "overflow": trace_block["overflow"],
        },
        "chaos": {"torn_prob": cfg.torn_prob},
        "device": str(device),
        "seed": cfg.seed,
    }
    TRACE.reset()
    return report
