"""Seeded fault injection for the fleet plane.

Counterpart of ``d4pg_tpu/fleet/chaos.py``: the same configuration, the
same per-actor draw order and the same schedules, so a seed gives the
port the reference's fault script. At a fleet of 256 actors transient
failures are the steady state, so the harness injects them on purpose,
from a seeded policy:

  - ``drop``: a block vanishes at the transport boundary;
  - ``delay``: a block is delivered late with uniform jitter;
  - ``crash``: the actor dies abruptly (no flush, no goodbye) and
    restarts after a fixed downtime;
  - receiver stalls: the ingest callback freezes for a window;
  - service kills: the whole replay service is torn down and restored
    from its last snapshot by the harness's supervisor.

Determinism: decision ``i`` of actor ``k`` depends only on
``(ChaosConfig.seed, k, i)``, never on the wall clock or the thread
interleaving. Each decision consumes exactly ``DRAWS_PER_EVENT``
uniforms from a ``SeedSequence``-derived per-actor stream, which keeps
the event index aligned with the RNG state whichever faults fire.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple

import numpy as np

from d4pg_tpu_torch.obs.draw_ledger import LEDGER


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault probabilities are PER DECISION POINT (one sender block)."""

    drop_prob: float = 0.0
    delay_prob: float = 0.0
    delay_min_s: float = 0.0
    delay_max_s: float = 0.05
    crash_prob: float = 0.0
    restart_delay_s: float = 0.5
    # Receiver stalls run on a fixed schedule rather than a probability:
    # every ``stall_every_s`` of harness time the ingest callback freezes
    # for ``receiver_stall_s`` (0 for either disables stalls).
    receiver_stall_s: float = 0.0
    stall_every_s: float = 0.0
    # Learner-kill chaos (the crash-recovery plane's fault): the harness
    # SIGKILL-equivalently tears down the WHOLE replay service (receiver
    # + ingest + buffer) ``service_kill_count`` times, roughly every
    # ``service_kill_every_s`` of harness time (seeded jitter spreads the
    # kill instants so they never phase-lock with the stall script), and
    # a supervisor restarts it from the last durable snapshot — bounded
    # by ``service_restart_max`` attempts with ``service_restart_backoff_s``
    # exponential backoff between them.
    service_kill_every_s: float = 0.0
    service_kill_count: int = 0
    service_restart_max: int = 3
    service_restart_backoff_s: float = 0.25
    # Snapshot cadence for the supervisor (the "checkpoint interval"):
    # rows committed after the latest snapshot die with the service —
    # the declared crash loss the recovery report accounts for.
    service_snapshot_every_s: float = 1.0
    seed: int = 0

    def __post_init__(self):
        for name in ("drop_prob", "delay_prob", "crash_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} outside [0, 1]")
        if self.delay_max_s < self.delay_min_s:
            raise ValueError("delay_max_s < delay_min_s")
        if self.service_kill_count < 0:
            raise ValueError("service_kill_count must be >= 0")
        if self.service_kill_count > 0 and self.service_kill_every_s <= 0:
            raise ValueError(
                "service_kill_count > 0 needs service_kill_every_s > 0")

    def enabled(self) -> bool:
        return (self.drop_prob > 0 or self.delay_prob > 0
                or self.crash_prob > 0
                or (self.receiver_stall_s > 0 and self.stall_every_s > 0)
                or self.service_chaos_enabled())

    def service_chaos_enabled(self) -> bool:
        return self.service_kill_count > 0 and self.service_kill_every_s > 0


class ChaosEvent(NamedTuple):
    actor_id: str
    index: int
    kind: str  # 'ok' | 'drop' | 'delay' | 'crash'
    arg: float  # delay seconds / restart downtime; 0.0 otherwise


# Uniforms consumed per decision: (crash, drop, delay, delay-jitter). A
# FIXED draw count per event keeps actor streams index-stable: event i is
# the same regardless of which faults fired before it.
DRAWS_PER_EVENT = 4


class ActorChaos:
    """One actor's deterministic fault stream (+ its event log)."""

    def __init__(self, config: ChaosConfig, actor_index: int, actor_id: str):
        self.config = config
        self.actor_id = actor_id
        # ledger-wrapped so every chaos run reports per-actor draw
        # counts (obs.draw_ledger)
        self._rng = LEDGER.wrap(f"chaos.{actor_id}", np.random.default_rng(
            np.random.SeedSequence(config.seed, spawn_key=(actor_index,))))
        self.log: list[ChaosEvent] = []
        self._i = 0

    def next(self) -> ChaosEvent:
        u_crash, u_drop, u_delay, u_jit = self._rng.random(DRAWS_PER_EVENT)
        cfg = self.config
        if u_crash < cfg.crash_prob:
            kind, arg = "crash", cfg.restart_delay_s
        elif u_drop < cfg.drop_prob:
            kind, arg = "drop", 0.0
        elif u_delay < cfg.delay_prob:
            kind = "delay"
            arg = cfg.delay_min_s + u_jit * (cfg.delay_max_s - cfg.delay_min_s)
        else:
            kind, arg = "ok", 0.0
        ev = ChaosEvent(self.actor_id, self._i, kind, float(arg))
        self._i += 1
        self.log.append(ev)
        return ev


class ChaosPolicy:
    """Factory for per-actor fault streams and the receiver-stall script."""

    def __init__(self, config: ChaosConfig):
        self.config = config

    def actor_stream(self, actor_index: int, actor_id: str) -> ActorChaos:
        return ActorChaos(self.config, actor_index, actor_id)

    def stall_schedule(self, horizon_s: float) -> list[tuple[float, float]]:
        """Deterministic ``(start_offset_s, duration_s)`` receiver stalls
        within ``horizon_s`` of harness time."""
        cfg = self.config
        if cfg.stall_every_s <= 0 or cfg.receiver_stall_s <= 0:
            return []
        out, t = [], cfg.stall_every_s
        while t < horizon_s:
            out.append((t, cfg.receiver_stall_s))
            t += cfg.stall_every_s + cfg.receiver_stall_s
        return out

    def service_kill_schedule(self, horizon_s: float) -> list[float]:
        """Seeded kill instants (offsets into harness time) for the
        learner-kill supervisor: ``service_kill_count`` kills, nominally
        ``service_kill_every_s`` apart, each jittered by a seeded uniform
        in ±25% of the interval so kills never phase-lock with the stall
        script (a kill landing INSIDE a stall is a legal — and nastier —
        schedule, it just should not be the only one a seed can produce).
        Deterministic from ``ChaosConfig.seed`` alone, like every other
        fault stream; kills past ``horizon_s`` are clipped."""
        cfg = self.config
        if not cfg.service_chaos_enabled():
            return []
        rng = LEDGER.wrap("schedule.service_kill", np.random.default_rng(
            np.random.SeedSequence(cfg.seed, spawn_key=(0x5E11,))))
        out = []
        for i in range(cfg.service_kill_count):
            base = (i + 1) * cfg.service_kill_every_s
            jit = (rng.random() - 0.5) * 0.5 * cfg.service_kill_every_s
            t = max(0.1, base + jit)
            if t < horizon_s:
                out.append(round(float(t), 3))
        return out


class StallGate:
    """The receiver-stall injection point: the ingest callback passes
    through ``wait()``; the stall controller closes/opens the gate. Waits
    are BOUNDED so a stall can never be mistaken for a receiver deadlock
    — a gated callback resumes the moment the gate opens or the bound
    elapses."""

    def __init__(self):
        self._open = threading.Event()
        self._open.set()
        self.stalls = 0

    def stall(self) -> None:
        self.stalls += 1
        self._open.clear()

    def resume(self) -> None:
        self._open.set()

    def wait(self, timeout: float = 30.0) -> bool:
        return self._open.wait(timeout)
