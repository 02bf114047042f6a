"""Learner-replica chaos: the multi-learner plane under fire.

Counterpart of ``d4pg_tpu/fleet/learner_chaos.py``. One run stands up a
real ``learner/aggregator.Aggregator`` over a real ``WeightStore``
behind a real ``distributed/update_plane.AggregatorServer`` on loopback,
with N synthetic replica lanes (numpy parameter perturbations: the merge,
the fences and the transport are under test, not SGD) submitting
version-stamped updates at ``submit_hz`` through real ``UpdateClient``
sockets. Registration and basis pulls go in-process, as a driver's
replicas would; only submissions ride the wire.

Faults:

  - **a replica killed mid-update**: a lane is stopped, its id fenced
    (``Aggregator.fence_replica``), and its last wire frame, the bytes
    that were in flight, is replayed as it is: it must bounce off the
    header check (``fenced``), its payload never merged. The replica then
    registers at its next epoch and goes on from its params;
  - **torn payloads**: a submission's last byte flipped, the crc left as
    it was: the server must answer ``torn`` and merge nothing.

Oracles (the report's keys):

  1. **ledger**: the aggregator's published (generation, version) stream
     never rewinds across the kills (``ledger.monotone``);
  2. **fencing**: every replayed in-flight frame was rejected and the
     victim's applied submissions did not move
     (``replayed_fenced == replayed_inflight``; the reference compares
     the global version, which the live lanes move meanwhile);
  3. **locks**: no hierarchy violation in the run, the lock plane in
     record mode (``hierarchy_violations``, from
     ``core.locking.violation_count``);
  4. **trace**: with the recorder sampling every frame, each submitted
     frame ends (commit on a merge, shed on a fence or a tear): 0
     orphans.

The kill instants and the victims, the perturbations and the torn
choices come from seeded streams: ``(config, seed)`` replays the same
fault script.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.distributed.update_plane import (
    AggregatorServer,
    UpdateClient,
    encode_update,
)
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.learner.aggregator import Aggregator
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.registry import percentile_summary
from d4pg_tpu_torch.obs.trace import RECORDER as TRACE


@dataclasses.dataclass(frozen=True)
class LearnerChaosConfig:
    """One learner-chaos run."""

    n_replicas: int = 4
    duration_s: float = 6.0
    submit_hz: float = 30.0
    replica_kills: int = 2
    torn_prob: float = 0.03
    mode: str = "async"
    clip: float = 8.0
    param_dim: int = 32
    seed: int = 0

    def kill_schedule(self, kills: int, lane: int) -> list[float]:
        """Seeded kill offsets (s): even across the middle 80% of the run,
        each jittered by up to a quarter of its slot."""
        if kills <= 0:
            return []
        rng = np.random.default_rng(
            np.random.SeedSequence(self.seed, spawn_key=(0xD4AB, lane)))
        span = 0.8 * self.duration_s
        slot = span / kills
        return sorted(0.1 * self.duration_s + (i + 0.5) * slot
                      + float(rng.uniform(-0.25, 0.25)) * slot
                      for i in range(kills))


def _tensors(params: dict) -> dict:
    """Numpy leaves as CPU tensors (the port's aggregator's leaves)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


class _ReplicaLane:
    """One synthetic replica: adopts the aggregator's basis, perturbs it
    (a stand-in for a grad step) and submits it over its own socket."""

    def __init__(self, replica_id: int, agg: Aggregator, port: int,
                 cfg: LearnerChaosConfig, epoch: int, params: dict):
        self.replica_id = replica_id
        self.epoch = epoch
        self._agg = agg
        self._cfg = cfg
        self.params = params
        self._rng = np.random.default_rng(np.random.SeedSequence(
            cfg.seed, spawn_key=(0xD4AC, replica_id, epoch)))
        self.client = UpdateClient("127.0.0.1", port)
        self.results: dict[str, int] = {}
        self.lags: list[int] = []
        self.torn_injected = 0
        self.torn_detected = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit_once(self) -> None:
        basis_version, basis = self._agg.basis(self.replica_id)
        if basis is not None:
            self.params = {k: np.array(v) for k, v in basis.items()}
        for v in self.params.values():
            v += self._rng.normal(scale=0.01, size=v.shape).astype(v.dtype)
        torn = self._rng.random() < self._cfg.torn_prob
        try:
            if torn:
                frame = bytearray(encode_update(
                    self.params, replica_id=self.replica_id,
                    epoch=self.epoch, generation=self._agg.generation,
                    basis_version=basis_version))
                frame[-1] ^= 0xFF  # the payload torn, the crc as it was
                self.torn_injected += 1
                res = self.client.submit_frame(bytes(frame))
            else:
                res = self.client.submit(
                    self.replica_id, self.epoch, self.params, basis_version,
                    generation=self._agg.generation)
        except (ConnectionError, OSError) as exc:
            self.errors += 1
            record_event("learner_lane_error", replica=self.replica_id,
                         error=type(exc).__name__)
            return
        status = res["status"]
        self.results[status] = self.results.get(status, 0) + 1
        if status == "torn":
            self.torn_detected += 1
        if status == "applied" and res["lag"] is not None:
            self.lags.append(res["lag"])

    def _run(self) -> None:
        try:
            interval = 1.0 / self._cfg.submit_hz
            while not self._stop.is_set():
                self.submit_once()
                self._stop.wait(interval)
        except Exception as e:  # noqa: BLE001 — counted: the lane's top frame
            contained_crash("chaos.learner_lane", e)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.client.close()


def _merged(agg: Aggregator, replica_id: int) -> int:
    """Submissions of ``replica_id`` the aggregator has applied. The
    fencing oracle counts the victim's merges, not the global version:
    the live lanes move the version while the replay is in flight."""
    return agg._snapshot()["replicas"].get(
        str(replica_id), {}).get("submits", 0)


def _merge_counts(total: dict, lane: _ReplicaLane) -> None:
    for k, v in lane.results.items():
        total[k] = total.get(k, 0) + v


def run_learner_chaos(cfg: LearnerChaosConfig | None = None,
                      **overrides) -> dict:
    """One learner-chaos run; returns its report (see the module
    docstring)."""
    cfg = dataclasses.replace(cfg or LearnerChaosConfig(), **overrides)
    with locking.record_mode():
        return _run(cfg)


def _run(cfg: LearnerChaosConfig) -> dict:
    violations_before = locking.violation_count()
    TRACE.reset()
    TRACE.enable(sample_rate=1.0)

    store = WeightStore()
    agg = Aggregator(store, mode=cfg.mode, clip=cfg.clip)
    server = AggregatorServer(agg)
    rng = np.random.default_rng(
        np.random.SeedSequence(cfg.seed, spawn_key=(0xD4AD,)))
    init = {"w0": rng.normal(size=(cfg.param_dim, cfg.param_dim)
                             ).astype(np.float32),
            "b0": rng.normal(size=(cfg.param_dim,)).astype(np.float32)}

    lanes: dict[int, _ReplicaLane] = {}
    for i in range(cfg.n_replicas):
        epoch = agg.register(i, params=_tensors(init))
        lanes[i] = _ReplicaLane(i, agg, server.port, cfg, epoch,
                                {k: v.copy() for k, v in init.items()})

    retired: dict[str, int] = {}
    retired_lags: list[int] = []
    retired_torn = 0
    retired_errors = 0
    kill_times = cfg.kill_schedule(cfg.replica_kills, lane=1)
    kills = 0
    replay_attempts = 0
    replay_fenced = 0

    start = time.monotonic()
    while True:
        now = time.monotonic() - start
        if now >= cfg.duration_s:
            break
        if kill_times and now >= kill_times[0]:
            kill_times.pop(0)
            victim_id = int(rng.integers(0, cfg.n_replicas))
            lane = lanes[victim_id]
            lane.stop()  # the kill: thread gone, socket dropped
            _merge_counts(retired, lane)
            retired_lags.extend(lane.lags)
            retired_torn += lane.torn_injected
            retired_errors += lane.errors
            agg.fence_replica(victim_id)
            merged_before = _merged(agg, victim_id)
            # the dead lane's in-flight bytes must bounce off its epoch
            if lane.client.last_frame is not None:
                replay_attempts += 1
                probe = UpdateClient("127.0.0.1", server.port)
                res = probe.submit_frame(lane.client.last_frame)
                probe.close()
                if (res["status"] in ("fenced", "torn")
                        and _merged(agg, victim_id) == merged_before):
                    replay_fenced += 1
            # respawn at the next epoch, from the dead lane's params
            epoch = agg.register(victim_id)
            lanes[victim_id] = _ReplicaLane(
                victim_id, agg, server.port, cfg, epoch,
                {k: np.array(v) for k, v in lane.params.items()})
            kills += 1
            record_event("learner_chaos_kill", replica=victim_id,
                         new_epoch=epoch)
        time.sleep(0.01)
    duration = time.monotonic() - start

    for lane in lanes.values():
        lane.stop()
        _merge_counts(retired, lane)
        retired_lags.extend(lane.lags)
    server.close()
    time.sleep(0.3)  # serve threads see the teardown and shed their traces

    counters = agg.counters()
    snapshot = agg._snapshot()
    trace_block = TRACE.latency_block()
    TRACE.disable()
    report = {
        "metric": "learner_chaos",
        "schema": 1,
        "n_replicas": cfg.n_replicas,
        "mode": cfg.mode,
        "clip": cfg.clip,
        "duration_s": round(duration, 3),
        "submits": dict(retired),
        "server": server.stats(),
        "replica_kills": kills,
        "replayed_inflight": replay_attempts,
        "replayed_fenced": replay_fenced,
        "updates_applied": counters["applied"],
        "updates_fenced": counters["fenced"],
        "updates_per_sec": round(counters["applied"] / duration, 1),
        "final_version": agg.version,
        "staleness": percentile_summary([float(v) for v in retired_lags]),
        "clip_rate": snapshot["clip_rate"],
        "torn": {
            "injected": retired_torn
            + sum(lane.torn_injected for lane in lanes.values()),
            "detected": server.torn,
        },
        "lane_errors": retired_errors
        + sum(lane.errors for lane in lanes.values()),
        "ledger": {
            "published": counters["published"],
            "monotone": agg.ledger_monotone(),
        },
        "hierarchy_violations":
            locking.violation_count() - violations_before,
        "trace": {
            "orphans": trace_block["orphans"],
            "n_traces": trace_block["n_traces"],
            "completed": trace_block["completed"],
            "shed": trace_block["shed"],
            "overflow": trace_block["overflow"],
        },
        "seed": cfg.seed,
    }
    agg.close()
    TRACE.reset()
    return report
