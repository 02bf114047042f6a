"""Weight-chaos fleet harness: the broadcast plane under fire.

Counterpart of ``d4pg_tpu/fleet/weight_chaos.py``, over the port's v2
weight plane and relays; the publisher's params are CPU tensors.

The ingest harness (``fleet/harness.py``) proves the actor->learner
plane survives drops, duplication, stalls and learner kills; this module
is the mirror drill for the learner->actor weight plane
(``distributed/weight_plane.py``). One run stands up a learner publisher
behind a ``WeightPlaneServer``, a relay chain of configurable depth, and
N puller clients spread across every tier with a mix of codecs, then
injects the weight plane's fault set:

  - **stale pulls** — the server serves deliberately old frames (from
    the pre-crash stash after a kill, else the oldest window version);
    clients must fence them by (generation, version), never adopt them.
  - **torn payloads** — served frames are corrupted without fixing the
    crc; clients must detect, count, and drop every one.
  - **relay crash mid-fan-out** — a relay dies and is rebuilt on the
    same port; downstream pullers degrade stale and reconverge.
  - **learner kill during broadcast** — the learner store+server die and
    restart at ``generation+1`` on the same port with a REWOUND version
    counter; the restarted server's chaos stash carries genuine
    pre-crash frames so fencing is exercised against real bytes.

Three oracles gate the run:

  1. **ledger**: every accepted (generation, version) pair must have
     actually been published — an accepted pair outside the publish
     ledger means corrupt or fabricated weights got through (0 torn
     versions accepted). Per puller the accepted sequence must be
     monotone: generation never decreases, version strictly increases
     within a generation (no pre-crash frame adopted as current).
  2. **trace**: with the wire-to-grad recorder at sample 1.0, every
     honestly-served frame must terminate (client commit or shed, conn
     teardown sweeping in-flight frames) — 0 orphans.
  3. **locks**: the run executes under lock-hierarchy record mode
     (``core.locking.record_mode``) — 0 new violations across the
     wrelay/wserve/wstore tiers.

The delta/quantization oracles run inside the servers themselves
(``verify=True``) and their tallies surface in the report.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.distributed.weight_plane import (
    CODECS,
    WeightPlaneClient,
    WeightPlaneServer,
    WeightRelay,
    WeightWireChaos,
)
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.registry import percentile_summary
from d4pg_tpu_torch.obs.trace import RECORDER as TRACE


@dataclasses.dataclass(frozen=True)
class WeightChaosConfig:
    """One weight-chaos run. Probabilities are per served frame; the
    kill counts are scheduled at seeded-jittered instants across the
    run, so a (config, seed) pair replays the same fault script."""

    n_pullers: int = 64
    relay_depth: int = 2
    duration_s: float = 8.0
    publish_hz: float = 20.0
    pull_hz: float = 25.0
    torn_prob: float = 0.04
    stale_prob: float = 0.04
    learner_kills: int = 1
    relay_kills: int = 1
    window: int = 8
    param_dim: int = 64
    seed: int = 0

    def kill_schedule(self, kills: int, lane: int) -> list[float]:
        """Seeded kill offsets (s): nominally even across the middle
        80% of the run, each jittered +-25% of its slot."""
        if kills <= 0:
            return []
        rng = np.random.default_rng(
            np.random.SeedSequence(self.seed, spawn_key=(0xD4C4, lane)))
        span = 0.8 * self.duration_s
        slot = span / kills
        return sorted(0.1 * self.duration_s + (i + 0.5) * slot
                      + float(rng.uniform(-0.25, 0.25)) * slot
                      for i in range(kills))


class _Publisher:
    """The synthetic learner: publishes seeded param mutations at
    ``publish_hz`` into whatever store currently backs the learner port,
    and keeps the ledger of every (generation, version) ever published
    — the harness's accepted-frames oracle checks against it."""

    def __init__(self, cfg: WeightChaosConfig):
        self._cfg = cfg
        rng = np.random.default_rng(
            np.random.SeedSequence(cfg.seed, spawn_key=(0xD4C5,)))
        d = cfg.param_dim
        self._rng = rng

        def draw(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

        # the reference's actor tree {w0, b0, w1} under torch names (the
        # port's weight frames carry a module's state_dict); fc1's bias is
        # the zeros a Dense kernel needs beside it, drawing nothing
        self._params = {"fc0.weight": draw(d, d), "fc0.bias": draw(d),
                        "fc1.weight": draw(d, d),
                        "fc1.bias": torch.zeros(d)}
        self.store = WeightStore()
        self.published: set[tuple[int, int]] = set()
        self.publishes = 0
        self._pub_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _mutate(self) -> None:
        # sparse mutation most publishes (exercises the sparse-XOR delta
        # arm), occasional full refresh (the full-tensor arm)
        w = self._params["fc0.weight"]
        if self._rng.random() < 0.15:
            self._params["fc0.weight"] = torch.from_numpy(self._rng.normal(
                size=tuple(w.shape)).astype(np.float32))
        else:
            i = int(self._rng.integers(0, w.shape[0]))
            w[i] += torch.from_numpy(
                self._rng.normal(size=w.shape[1]).astype(np.float32))
        self._params["fc0.bias"] += np.float32(0.001)

    def publish_once(self) -> None:
        with self._pub_lock:
            self._mutate()
            store = self.store
            version = store.publish(self._params, step=self.publishes,
                                    to_host=False)
            self.published.add((store.generation, version))
            self.publishes += 1

    def swap_store(self, store: WeightStore) -> None:
        with self._pub_lock:
            self.store = store

    def _run(self) -> None:
        try:
            interval = 1.0 / self._cfg.publish_hz
            while not self._stop.is_set():
                self.publish_once()
                self._stop.wait(interval)
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("chaos.weight_publisher", e)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class _Puller:
    """One actor-side puller lane: pulls at ``pull_hz``, records every
    accepted (generation, version) + its end-to-end adopt lag."""

    def __init__(self, index: int, port: int, codec: str,
                 cfg: WeightChaosConfig):
        self.index = index
        self.client = WeightPlaneClient(
            "127.0.0.1", port, codec=codec, delta=True,
            down_timeout=10 * cfg.duration_s, reconnect_interval=0.05)
        self.accepted: list[tuple[int, int]] = []
        self.lag_ms: list[float] = []
        self.errors = 0
        self._cfg = cfg
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            interval = 1.0 / self._cfg.pull_hz
            while not self._stop.is_set():
                self.pull_once()
                self._stop.wait(interval)
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("chaos.weight_puller", e)

    def pull_once(self) -> bool:
        try:
            res = self.client.get_if_newer()
        except (ConnectionError, OSError) as exc:
            self.errors += 1
            record_event("weight_puller_error", puller=self.index,
                         error=type(exc).__name__)
            return False
        if res is None:
            return False
        self.accepted.append((self.client.generation, self.client.version))
        self.lag_ms.append(
            1e3 * max(0.0, time.monotonic() - self.client.last_pub_ts))
        return True

    def monotone(self) -> bool:
        prev = (0, 0)
        for gen, version in self.accepted:
            if gen < prev[0] or (gen == prev[0] and version <= prev[1]):
                return False
            prev = (gen, version)
        return True

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.client.close()


def _sum_stats(total: dict, part: dict) -> None:
    for k, v in part.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            total[k] = total.get(k, 0) + v


def run_weight_chaos(cfg: WeightChaosConfig | None = None, **overrides
                     ) -> dict:
    """Execute one weight-chaos run and return the artifact block."""
    cfg = dataclasses.replace(cfg or WeightChaosConfig(), **overrides)
    with locking.record_mode():
        return _run(cfg)


def _run(cfg: WeightChaosConfig) -> dict:
    violations_before = locking.violation_count()
    TRACE.reset()
    TRACE.enable(sample_rate=1.0)

    pub = _Publisher(cfg)
    chaos_objs: list[WeightWireChaos] = []

    def mk_chaos(lane: int) -> WeightWireChaos:
        c = WeightWireChaos(torn_prob=cfg.torn_prob,
                            stale_prob=cfg.stale_prob,
                            seed=cfg.seed * 1000 + lane)
        chaos_objs.append(c)
        return c

    def bind_server(store: WeightStore, port: int, lane: int
                    ) -> WeightPlaneServer:
        deadline = time.monotonic() + 10.0
        while True:  # the restarted incarnation re-binds the SAME port
            try:
                return WeightPlaneServer(store, port=port, window=cfg.window,
                                         chaos=mk_chaos(lane))
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    learner = {"server": bind_server(pub.store, 0, 0)}
    learner_port = learner["server"].port
    pub.publish_once()  # at least one version before anyone pulls
    pub.start()

    relays: list[dict] = []
    upstream_port = learner_port
    for depth in range(cfg.relay_depth):
        relay = WeightRelay("127.0.0.1", upstream_port,
                            poll_interval=0.01, window=cfg.window,
                            down_timeout=10 * cfg.duration_s,
                            chaos=mk_chaos(10 + depth))
        relays.append({"relay": relay, "upstream": upstream_port,
                       "port": relay.port, "depth": depth})
        upstream_port = relay.port

    # pullers round-robin across every tier (learner + each relay) and
    # across codecs, so fencing/deltas/quantization all see every hop
    tier_ports = [learner_port] + [r["port"] for r in relays]
    pullers = [
        _Puller(i, tier_ports[i % len(tier_ports)],
                CODECS[i % len(CODECS)], cfg)
        for i in range(cfg.n_pullers)
    ]

    retired_server_stats: dict = {}
    retired_client_counters: dict = {}
    learner_kill_times = cfg.kill_schedule(cfg.learner_kills, lane=1)
    relay_kill_times = cfg.kill_schedule(
        cfg.relay_kills if relays else 0, lane=2)
    learner_kills = relay_kills = 0
    rng = np.random.default_rng(
        np.random.SeedSequence(cfg.seed, spawn_key=(0xD4C6,)))

    start = time.monotonic()
    while True:
        now = time.monotonic() - start
        if now >= cfg.duration_s:
            break
        if learner_kill_times and now >= learner_kill_times[0]:
            learner_kill_times.pop(0)
            old = learner["server"]
            stash = old.latest_full_payload()  # genuine pre-crash bytes
            old_gen = pub.store.generation
            old.close()
            store = WeightStore(generation=old_gen + 1)
            pub.swap_store(store)
            server = bind_server(store, learner_port, lane=20 + learner_kills)
            if stash is not None:
                server.chaos.stash.append(stash)
            _sum_stats(retired_server_stats, old.weight_stats())
            learner["server"] = server
            learner_kills += 1
            record_event("weight_chaos_learner_kill", new_gen=old_gen + 1)
        if relay_kill_times and now >= relay_kill_times[0]:
            relay_kill_times.pop(0)
            slot = relays[int(rng.integers(0, len(relays)))]
            old_relay = slot["relay"]
            _sum_stats(retired_server_stats, old_relay.weight_stats())
            _sum_stats(retired_client_counters, old_relay._client.counters)
            old_relay.close()
            deadline = time.monotonic() + 10.0
            while True:
                try:
                    slot["relay"] = WeightRelay(
                        "127.0.0.1", slot["upstream"], port=slot["port"],
                        poll_interval=0.01, window=cfg.window,
                        down_timeout=10 * cfg.duration_s,
                        chaos=mk_chaos(30 + relay_kills))
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            relay_kills += 1
            record_event("weight_chaos_relay_kill", depth=slot["depth"])
        time.sleep(0.01)
    duration = time.monotonic() - start

    # drain: stop publishing and injecting, give every puller a last
    # window to converge on the final (generation, version)
    pub.close()
    for c in chaos_objs:
        c.torn_prob = c.stale_prob = 0.0
    final = (pub.store.generation, pub.store.version)
    drain_deadline = time.monotonic() + max(2.0, 0.5 * cfg.duration_s)
    while time.monotonic() < drain_deadline:
        if all(p.accepted and p.accepted[-1] == final for p in pullers):
            break
        time.sleep(0.05)
    converged = sum(1 for p in pullers
                    if p.accepted and p.accepted[-1] == final)

    for p in pullers:
        p.stop()
    servers = [learner["server"]] + [r["relay"]._server for r in relays]
    server_stats = dict(retired_server_stats)
    for srv in servers:
        _sum_stats(server_stats, srv.weight_stats())
    client_counters = dict(retired_client_counters)
    for r in relays:
        _sum_stats(client_counters, r["relay"]._client.counters)
    for p in pullers:
        _sum_stats(client_counters, p.client.counters)
    for r in relays:
        r["relay"].close()
    learner["server"].close()
    time.sleep(0.3)  # serve threads notice teardown, shed in-flight traces

    accepted_pairs = [pair for p in pullers for pair in p.accepted]
    unpublished = [pair for pair in accepted_pairs
                   if pair not in pub.published]
    lag = [v for p in pullers for v in p.lag_ms]
    served = server_stats.get("frames_full", 0) + server_stats.get(
        "frames_delta", 0)
    trace_block = TRACE.latency_block()
    TRACE.disable()
    report = {
        "metric": "weight_chaos",
        "schema": 1,
        "n_pullers": cfg.n_pullers,
        "relay_depth": cfg.relay_depth,
        "duration_s": round(duration, 3),
        "window": cfg.window,
        "publishes": pub.publishes,
        "final_generation": final[0],
        "learner_kills": learner_kills,
        "relay_kills": relay_kills,
        "snapshots_per_sec": round(
            client_counters.get("accepts", 0) / duration, 1),
        "frames_served": served,
        "frames_full": server_stats.get("frames_full", 0),
        "frames_delta": server_stats.get("frames_delta", 0),
        "delta_hit_rate": round(server_stats.get("frames_delta", 0)
                                / served, 4) if served else None,
        "bytes_per_sec": round(server_stats.get("bytes_sent", 0) / duration),
        "staleness_ms": percentile_summary(lag),
        "torn": {
            "injected": server_stats.get("torn_injected", 0),
            "rejected": client_counters.get("torn_rejected", 0),
            "accepted": len(unpublished),
        },
        "stale_injected": server_stats.get("stale_injected", 0),
        "fenced_rejected": client_counters.get("fenced_rejected", 0),
        "stale_rejected": client_counters.get("stale_rejected", 0),
        "delta_base_misses": client_counters.get("delta_base_misses", 0),
        "oracle": {
            "delta_checks": server_stats.get("oracle_delta_checks", 0),
            "delta_failures": server_stats.get("oracle_delta_failures", 0),
            "quant_checks": server_stats.get("oracle_quant_checks", 0),
            "quant_failures": server_stats.get("oracle_quant_failures", 0),
        },
        "ledger": {
            "published": len(pub.published),
            "accepted": len(accepted_pairs),
            "unpublished_accepted": len(unpublished),
            "monotone": all(p.monotone() for p in pullers),
        },
        "pullers_converged": converged,
        "puller_errors": sum(p.errors for p in pullers),
        "hierarchy_violations": locking.violation_count() - violations_before,
        "trace": {
            "orphans": trace_block["orphans"],
            "n_traces": trace_block["n_traces"],
            "completed": trace_block["completed"],
            "shed": trace_block["shed"],
            "overflow": trace_block["overflow"],
        },
        "chaos": {"torn_prob": cfg.torn_prob, "stale_prob": cfg.stale_prob},
        "seed": cfg.seed,
    }
    TRACE.reset()
    return report
