"""Sample-on-ingest chaos: the dealer plane vs the host-sample plane.

Counterpart of ``d4pg_tpu/fleet/sampler_chaos.py``.

One run stands up the full fleet ingest rig (``fleet/harness.py`` — N
chaos-wrapped sender lanes over real TCP into a sharded
``ReplayService``) over a **prioritized** buffer, and bolts a consumer
lane onto it that trains the way a learner replica would:

  - ``sample_path='host'``: the host-sampled path — ``weight_base`` +
    ``sample_chunk`` + ``update_priorities`` per block, every call an
    acquisition of the service's buffer lock (counted per call as
    ``sample_path_buffer_acqs``).
  - ``sample_path='dealer'``: the sample-on-ingest path
    (``replay/sampler.py``) — a ``SampleDealer`` rides the commit
    thread, the consumer pops ready-to-train blocks from its
    ``DealtBlockRing`` and feeds priorities back through
    ``queue_writeback``. ZERO buffer-lock acquisitions on the consume
    path, by construction — the counter stays 0 because no call on the
    path can take that lock, not because we remembered not to.
  - ``sample_path='device'``: the device-dealt variant
    (``replay/device_sampler.py``) — the service's buffer is a
    gen-tracked ``FusedDeviceReplay`` on ``SamplerChaosConfig.device``
    (``cuda`` by default, raising without a card) and a
    ``DeviceSampleDealer`` with the reference's ``arm='scan'`` descends
    on that device behind the commit; blocks arrive device-resident in a
    plain ``DealtBlockRing`` (a dropped block's tensors go back to the
    allocator when the ring lets go of them). Same zero-buffer-lock
    consume contract and the same audit oracles; single ingest shard by
    construction (the gen-tracked ring pre-assigns slots under one
    commit thread). The consumer copies each block's slots and
    generations to the host for the write-back.

Fault set on top of the harness's seeded sender chaos:

  - **learner kill** — the consumer thread is stopped mid-stream and
    respawned; in dealer mode its ring is cleared at the kill instant
    (blocks dealt to the corpse must not train), and the dealer keeps
    dealing to the successor.
  - **shed pressure** — a small ingest ring + low watermark forces
    oldest-batch sheds under load; shed tickets are marked dead.
  - **stale-generation frames** — raw frames stamped with a
    pre-restart generation are injected straight into ``add_payload``;
    they must fence at admission and never reach the dealer.

Oracles gating the run: 0 deadlocks, 0 lock-hierarchy violations, 0 trace
orphans (every dealt block's ``deal`` span hangs off a committed frame), and
``dealt_dead_tickets == 0`` — the dealer, running in audit mode, never
dealt a row whose source ticket was shed, tombstoned or fenced.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from d4pg_tpu_torch.distributed import transport
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.fleet.chaos import ChaosConfig
from d4pg_tpu_torch.fleet.harness import FleetConfig, FleetHarness
from d4pg_tpu_torch.fleet.sender import synthetic_block
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.draw_ledger import LEDGER
from d4pg_tpu_torch.obs.flight import record_event
from d4pg_tpu_torch.obs.trace import RECORDER as TRACE
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.sampler import SampleDealer
from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
from d4pg_tpu_torch.replay.staging import DealtBlockRing


@dataclasses.dataclass(frozen=True)
class SamplerChaosConfig:
    """One sampler-chaos run. ``(config, seed)`` replays the same fault
    script (harness sender chaos + seeded consumer kills + fixed stale
    injection instants)."""

    sample_path: str = "dealer"  # 'dealer' | 'host' | 'device'
    n_actors: int = 16
    duration_s: float = 6.0
    rows_per_sec: float = 40.0
    block_rows: int = 16
    obs_dim: int = 24
    act_dim: int = 6
    capacity: int = 4096
    ingest_capacity: int = 24
    shed_watermark: float = 0.75
    ingest_shards: int = 2
    k: int = 4
    batch_size: int = 32
    alpha: float = 0.6
    beta0: float = 0.4
    beta_steps: int = 100_000
    consume_hz: float = 200.0
    learner_kills: int = 0
    stale_frames: int = 0
    device: str = "cuda"  # the device arm's buffer and dealer
    flight_dir: str | None = None  # the harness's (None: its default)
    seed: int = 0

    def __post_init__(self):
        if self.sample_path not in ("dealer", "host", "device"):
            raise ValueError(f"unknown sample_path {self.sample_path!r}")
        if self.sample_path == "device" and self.ingest_shards != 1:
            # the gen-tracked ring pre-assigns slots under ONE commit
            # thread; coerce rather than raise so the sweep's A/B loop
            # can run the same config across all three arms (the shard
            # count difference is structural, not a knob)
            object.__setattr__(self, "ingest_shards", 1)

    def kill_schedule(self) -> list[float]:
        """Seeded consumer-kill offsets (s): even across the middle 80%
        of the run, each jittered +-25% of its slot."""
        if self.learner_kills <= 0:
            return []
        rng = LEDGER.wrap("schedule.sampler_kill", np.random.default_rng(
            np.random.SeedSequence(self.seed, spawn_key=(0xD4B0,))))
        span = 0.8 * self.duration_s
        slot = span / self.learner_kills
        return sorted(0.1 * self.duration_s + (i + 0.5) * slot
                      + float(rng.uniform(-0.25, 0.25)) * slot
                      for i in range(self.learner_kills))

    def stale_schedule(self) -> list[float]:
        """Fixed injection instants for the stale-generation frames,
        even across the middle 60% of the run."""
        if self.stale_frames <= 0:
            return []
        return [0.2 * self.duration_s
                + (i + 0.5) * 0.6 * self.duration_s / self.stale_frames
                for i in range(self.stale_frames)]


class _SamplerHarness(FleetHarness):
    """The fleet ingest rig over a PER buffer, with the dealer (dealer
    mode) attached inside ``_make_service`` and the learner consumer
    supervised for seeded kills inside ``_start_consumer``."""

    def __init__(self, config: FleetConfig, scfg: SamplerChaosConfig):
        super().__init__(config)
        self.scfg = scfg
        self._dealer: SampleDealer | None = None
        self._ring: DealtBlockRing | None = None
        self._beta = SharedBetaSchedule(beta0=scfg.beta0,
                                        beta_steps=scfg.beta_steps)
        self._service_stats: dict = {}
        self.buffer_device = None  # the device arm's, once built
        self.cstats = {
            "blocks_consumed": 0,
            "steps_consumed": 0,
            "sample_path_buffer_acqs": 0,
            "consumer_kills": 0,
            "blocks_cleared_on_kill": 0,
            "stale_frames_injected": 0,
            "sample_errors": 0,
        }

    # -- service over a PER buffer, dealer attached in dealer mode ----------
    def _make_service(self, obs_dim=None, act_dim=None,
                      generation: int = 0) -> ReplayService:
        cfg, scfg = self.config, self.scfg
        # generation floor 1: injected frames stamped with generation 0
        # are "pre-restart" retries and must fence at admission (lanes
        # send generation-less frames — they admit as always)
        if scfg.sample_path == "device":
            from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

            buffer = FusedDeviceReplay(
                cfg.capacity, cfg.obs_dim, cfg.act_dim, alpha=scfg.alpha,
                prioritized=True, device=scfg.device, ingest_shards=1,
                gen_tracked=True)
            self.buffer_device = buffer.device
        else:
            buffer = PrioritizedReplayBuffer(
                cfg.capacity, cfg.obs_dim, cfg.act_dim,
                alpha=scfg.alpha, seed=scfg.seed)
        service = ReplayService(
            buffer,
            ingest_capacity=cfg.ingest_capacity,
            heartbeat_timeout=cfg.heartbeat_timeout,
            shed_watermark=cfg.shed_watermark,
            num_ingest_shards=cfg.ingest_shards,
            generation=max(1, generation),
        )
        if scfg.sample_path == "dealer":
            self._ring = DealtBlockRing(4)
            self._dealer = SampleDealer(
                cfg.capacity, [self._ring],
                n_shards=cfg.ingest_shards, k=scfg.k,
                batch_size=scfg.batch_size, alpha=scfg.alpha,
                beta_schedule=self._beta,
                min_size=max(1, scfg.batch_size), seed=scfg.seed,
                audit=True)
            service.attach_dealer(self._dealer)
        elif scfg.sample_path == "device":
            from d4pg_tpu_torch.replay.device_sampler import DeviceSampleDealer

            self._ring = DealtBlockRing(4)
            self._dealer = DeviceSampleDealer(
                cfg.capacity, [self._ring], k=scfg.k,
                batch_size=scfg.batch_size, alpha=scfg.alpha,
                beta_schedule=self._beta,
                min_size=max(1, scfg.batch_size), seed=scfg.seed,
                audit=True, arm="scan")
            service.attach_dealer(self._dealer)
        return service

    # -- the supervised learner consumer ------------------------------------
    def _start_consumer(self, service_ref,
                        stop: threading.Event) -> threading.Thread | None:
        t = threading.Thread(target=self._consume_supervise,
                             args=(service_ref, stop), daemon=True,
                             name="sampler-consumer-supervisor")
        t.start()
        return t

    def _consume_supervise(self, service_ref, stop: threading.Event) -> None:
        """Run the consumer thread, killing + respawning it on the seeded
        schedule, and inject the stale-generation frames."""
        try:
            self._supervise_consumers(service_ref, stop)
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("chaos.sampler_supervisor", e)

    def _supervise_consumers(self, service_ref,
                             stop: threading.Event) -> None:
        scfg = self.scfg
        kills = scfg.kill_schedule()
        stales = scfg.stale_schedule()
        stale_block = synthetic_block(
            self.config.block_rows, self.config.obs_dim,
            self.config.act_dim, seed=scfg.seed + 7919)
        t0 = time.monotonic()
        inner_stop = threading.Event()
        worker = self._spawn_consumer(service_ref, stop, inner_stop)
        while not stop.is_set():
            now = time.monotonic() - t0
            if kills and now >= kills[0]:
                kills.pop(0)
                inner_stop.set()
                worker.join(timeout=5.0)
                self.cstats["consumer_kills"] += 1
                if self._ring is not None:
                    # the corpse's undelivered blocks must not train
                    self.cstats["blocks_cleared_on_kill"] += \
                        self._ring.clear()
                record_event("sampler_consumer_kill",
                             kills=self.cstats["consumer_kills"])
                inner_stop = threading.Event()
                worker = self._spawn_consumer(service_ref, stop, inner_stop)
            if stales and now >= stales[0]:
                stales.pop(0)
                i = self.cstats["stale_frames_injected"]
                # encode_raw returns length-prefixed wire bytes; admission
                # takes the bare payload the receiver would hand it
                frame = transport.encode_raw(
                    f"stale-{i}", stale_block, True, generation=0)
                service_ref().add_payload(
                    frame[transport._HEADER.size:],
                    shard=i % self.config.ingest_shards, codec="raw")
                self.cstats["stale_frames_injected"] += 1
            stop.wait(0.01)
        inner_stop.set()
        worker.join(timeout=5.0)

    def _spawn_consumer(self, service_ref, stop: threading.Event,
                        inner_stop: threading.Event) -> threading.Thread:
        # 'device' blocks ride the same dealt consume lane — the lane is
        # arm-agnostic (pop + write-back), only the block residency
        # differs (the lane copies idx/gen to the host)
        target = (self._consume_host if self.scfg.sample_path == "host"
                  else self._consume_dealt)
        t = threading.Thread(target=target,
                             args=(service_ref, stop, inner_stop),
                             daemon=True, name="sampler-consumer")
        t.start()
        return t

    def _consume_dealt(self, service_ref, stop, inner_stop) -> None:
        """The dealt lane: ring pop -> (stand-in) grad -> write-back.
        NOTHING on this path can acquire the buffer lock — pop waits on
        the ``ring`` leaf tier, ``queue_writeback`` enqueues under the
        ``sampler`` tier. Paced at ``consume_hz`` like the host lane so
        the A/B arms model the SAME per-block grad time — what differs
        is only how the block is obtained (an unpaced pop loop would
        compare a zero-grad-time learner against a 200 Hz one)."""
        try:
            self._consume_dealt_loop(service_ref, stop, inner_stop)
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("chaos.sampler_dealt", e)

    def _consume_dealt_loop(self, service_ref, stop, inner_stop) -> None:
        scfg = self.scfg
        rng = np.random.default_rng(np.random.SeedSequence(
            scfg.seed, spawn_key=(0xD4B1, self.cstats["consumer_kills"])))
        ring = self._ring
        period = 1.0 / max(1.0, scfg.consume_hz)
        while not (stop.is_set() or inner_stop.is_set()):
            block = ring.pop(timeout=0.1)
            if block is None:
                if ring.closed:
                    return
                continue
            # stand-in TD magnitudes: the priority write-back machinery
            # is the system under test, not SGD
            idx = np.asarray(torch.as_tensor(block.idx).cpu())
            gen = np.asarray(torch.as_tensor(block.gen).cpu())
            td = rng.uniform(0.1, 2.0, size=idx.shape)
            service_ref().queue_writeback(idx, td, gen)
            TRACE.mark_grad()
            self.cstats["blocks_consumed"] += 1
            self.cstats["steps_consumed"] += int(idx.shape[0])
            inner_stop.wait(period)

    def _consume_host(self, service_ref, stop, inner_stop) -> None:
        """The host lane: every consumed block is weight_base +
        sample_chunk + update_priorities — three buffer-lock
        acquisitions, counted."""
        try:
            self._consume_host_loop(service_ref, stop, inner_stop)
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("chaos.sampler_host", e)

    def _consume_host_loop(self, service_ref, stop, inner_stop) -> None:
        scfg = self.scfg
        rng = np.random.default_rng(np.random.SeedSequence(
            scfg.seed, spawn_key=(0xD4B2, self.cstats["consumer_kills"])))
        period = 1.0 / max(1.0, scfg.consume_hz)
        while not (stop.is_set() or inner_stop.is_set()):
            svc = service_ref()
            if len(svc) >= scfg.batch_size:
                beta = self._beta.beta_at(self._beta.current_step())
                try:
                    _b, _w, idx, gen = svc.sample_chunk(
                        scfg.k, scfg.batch_size, beta=beta,
                        weight_base=svc.weight_base())
                    td = rng.uniform(0.1, 2.0, size=idx.shape)
                    svc.update_priorities(idx, td, generation=gen)
                except (ValueError, RuntimeError):
                    self.cstats["sample_errors"] += 1
                    continue
                self.cstats["sample_path_buffer_acqs"] += 3
                self._beta.advance(scfg.k)
                TRACE.mark_grad()
                self.cstats["blocks_consumed"] += 1
                self.cstats["steps_consumed"] += scfg.k
            inner_stop.wait(period)

    def _report(self, **kwargs) -> dict:
        self._service_stats = dict(kwargs.get("service_stats") or {})
        return super()._report(**kwargs)


def run_sampler_chaos(cfg: SamplerChaosConfig | None = None,
                      chaos: ChaosConfig | None = None,
                      **overrides) -> dict:
    """Execute one sampler-chaos run and return the artifact block."""
    cfg = dataclasses.replace(cfg or SamplerChaosConfig(), **overrides)
    fleet_cfg = FleetConfig(
        n_actors=cfg.n_actors, duration_s=cfg.duration_s,
        rows_per_sec=cfg.rows_per_sec, block_rows=cfg.block_rows,
        obs_dim=cfg.obs_dim, act_dim=cfg.act_dim, capacity=cfg.capacity,
        ingest_capacity=cfg.ingest_capacity,
        shed_watermark=cfg.shed_watermark,
        ingest_shards=cfg.ingest_shards, codec="raw",
        trace_sample=1.0, consume_hz=cfg.consume_hz,
        flight_dir=cfg.flight_dir,
        chaos=chaos if chaos is not None else ChaosConfig(seed=cfg.seed))
    harness = _SamplerHarness(fleet_cfg, cfg)
    result = harness.run()
    result.pop("chaos_log", None)
    locks = result.get("locks")
    lat = result.get("latency") or {}
    stages = lat.get("stages") or {}
    dealer = harness._dealer
    report = {
        "metric": "sampler_chaos",
        "schema": 1,
        "sample_path": cfg.sample_path,
        "device": (str(harness.buffer_device)
                   if harness.buffer_device is not None else None),
        "n_actors": cfg.n_actors,
        "ingest_shards": cfg.ingest_shards,
        "duration_s": result["duration_s"],
        "rows_inserted": result["rows_inserted"],
        "sheds": result["drops"]["shed_batches"],
        "shed_rows": result["drops"]["shed_rows"],
        "fenced_frames": harness._service_stats.get("fenced_frames", 0),
        "fenced_rows": harness._service_stats.get("fenced_rows", 0),
        "wire_to_grad_p95_ms": (stages.get("wire_to_grad") or {}).get("p95"),
        "commit_to_deal_p95_ms": (stages.get("commit_to_deal")
                                  or {}).get("p95"),
        "deal_to_grad_p95_ms": (stages.get("deal_to_grad") or {}).get("p95"),
        "consumer": dict(harness.cstats),
        "sampler": dealer.sampler_stats() if dealer is not None else None,
        "deadlocks": result["deadlocks"],
        "hierarchy_violations": (locks["hierarchy_violations"]
                                 if locks else None),
        "trace_orphans": lat.get("orphans"),
        # schedule_digest is config-deterministic: two arms at the same
        # seed/config must report the same value (the A/B equal-load pin)
        "draw_ledger": result["draw_ledger"],
        "seed": cfg.seed,
    }
    return report
