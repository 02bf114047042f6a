"""Seeded offered-load model for the elastic plane.

Counterpart of ``d4pg_tpu/elastic/traffic.py``. ``rate(actor, t)`` is the
offered load of one lane at model time ``t`` (rows/s): a base rate times
the lane's Pareto weight (a heavy tail over the lanes, normalized to mean
1), a diurnal curve and the flash-crowd multiplier. It is a pure function
of ``TrafficConfig`` (seed included), so two models from one config give
the same trace bit for bit, in this package and in the reference: the
numpy draw order and every ``math`` and ``np`` call are the reference's
(a ``math.sin`` that became ``np.sin`` could move the last bit).

Determinism rules, as the reference states them:

- each stochastic component draws from its own ``SeedSequence`` branch
  (disjoint ``spawn_key`` tags), so adding one never shifts another;
- the renewal flash stream draws a fixed number of variates per event
  (gap, duration, amplitude);
- the schedule is built eagerly up to ``horizon_s``; after construction
  the model is immutable, so lanes on other threads read it without a
  lock.

The construction draws are counted in ``obs.draw_ledger.LEDGER`` under
``schedule.traffic.*``: their counts depend on the config alone, so an
A/B drill pins the ``schedule.*`` digest as its equal-load oracle.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from d4pg_tpu_torch.obs.draw_ledger import LEDGER

# SeedSequence spawn-key tags: diurnal phase, flash-crowd stream,
# per-actor Pareto weights (the reference's values)
_TAG_DIURNAL = 0xE7A0
_TAG_FLASH = 0xE7A1
_TAG_PARETO = 0xE7A2

# draws per flash event (gap, duration, amplitude)
_DRAWS_PER_FLASH = 3


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Everything the offered load depends on; frozen: the config is the
    trace's identity."""

    seed: int = 0
    n_actors: int = 4
    # fleet-mean per-lane rate at multiplier 1.0 (rows/s)
    base_rows_per_sec: float = 256.0
    # 1 + amp * sin(2 pi (t / period + phase)), the phase seeded; amp 0
    # disables it. The period is in model seconds.
    diurnal_amp: float = 0.3
    diurnal_period_s: float = 60.0
    # flash crowds: a scripted tuple of (start_s, duration_s, amplitude),
    # or (None) a seeded renewal process: exponential gaps at
    # ``flash_rate_per_s``, uniform durations and amplitudes, out to
    # ``horizon_s``
    flash_schedule: tuple[tuple[float, float, float], ...] | None = None
    flash_rate_per_s: float = 0.02
    flash_duration_s: tuple[float, float] = (2.0, 6.0)
    flash_amp: tuple[float, float] = (4.0, 10.0)
    # Pareto(alpha) lane weights normalized to mean 1 (the fleet's offered
    # load stays n_actors * base whatever the draw)
    pareto_alpha: float = 1.5
    # floor under the composed rate (a zero rate would divide the period)
    min_rows_per_sec: float = 1.0
    # flash events are built out to here; past it the multiplier is 1
    horizon_s: float = 3600.0


class TrafficModel:
    """Immutable seeded offered-load surface (see the module docstring)."""

    def __init__(self, cfg: TrafficConfig):
        self.cfg = cfg
        # diurnal phase: one uniform draw on its own branch
        d_rng = LEDGER.wrap("schedule.traffic.diurnal", np.random.default_rng(
            np.random.SeedSequence(cfg.seed, spawn_key=(_TAG_DIURNAL, 0))))
        self._diurnal_phase = float(d_rng.random())
        # Pareto weights, one branch per actor (more lanes extend the
        # vector without moving the others' draws), normalized to mean 1
        raw = np.empty(max(1, cfg.n_actors), np.float64)
        for i in range(raw.shape[0]):
            rng = LEDGER.wrap(
                "schedule.traffic.pareto", np.random.default_rng(
                    np.random.SeedSequence(cfg.seed, spawn_key=(_TAG_PARETO, i))))
            u = rng.random()
            raw[i] = (1.0 - u) ** (-1.0 / cfg.pareto_alpha)
        self._weights = raw / raw.mean()
        # flash crowds: scripted, or the renewal stream at fixed draws
        # per event
        if cfg.flash_schedule is not None:
            self._flash = [(float(s), float(d), float(a))
                           for s, d, a in cfg.flash_schedule]
        else:
            f_rng = LEDGER.wrap(
                "schedule.traffic.flash", np.random.default_rng(
                    np.random.SeedSequence(cfg.seed, spawn_key=(_TAG_FLASH, 0))))
            events = []
            t = 0.0
            rate = max(1e-9, cfg.flash_rate_per_s)
            while True:
                gap = f_rng.exponential(1.0 / rate)
                dur = f_rng.uniform(*cfg.flash_duration_s)
                amp = f_rng.uniform(*cfg.flash_amp)
                t += gap
                if t >= cfg.horizon_s:
                    break
                events.append((t, dur, amp))
            self._flash = events

    # -- components ---------------------------------------------------------
    def pareto_weight(self, actor: int) -> float:
        return float(self._weights[actor % self._weights.shape[0]])

    def diurnal(self, t: float) -> float:
        c = self.cfg
        if c.diurnal_amp == 0.0:
            return 1.0
        m = 1.0 + c.diurnal_amp * math.sin(
            2.0 * math.pi * (t / c.diurnal_period_s + self._diurnal_phase))
        return max(0.0, m)

    def flash(self, t: float) -> float:
        """The multiplier of the crowds active at ``t``: overlapping
        crowds take the max, not the product."""
        m = 1.0
        for start, dur, amp in self._flash:
            if start <= t < start + dur:
                m = max(m, amp)
        return m

    def flash_events(self) -> list[tuple[float, float, float]]:
        return list(self._flash)

    # -- the surface --------------------------------------------------------
    def rate(self, actor: int, t: float) -> float:
        """Offered load of ``actor`` at model time ``t`` (rows/s)."""
        c = self.cfg
        r = (c.base_rows_per_sec * self.pareto_weight(actor)
             * self.diurnal(t) * self.flash(t))
        return max(c.min_rows_per_sec, r)

    def rate_fn(self, actor: int):
        """The lane's rate as a function of its own model clock: the
        offered schedule is a recurrence over that clock, independent of
        wall-clock jitter."""
        return lambda t: self.rate(actor, t)

    def trace(self, actor: int, horizon_s: float, dt: float) -> np.ndarray:
        """The lane's offered load on a fixed grid (the determinism
        oracle's array)."""
        ts = np.arange(0.0, horizon_s, dt, dtype=np.float64)
        return np.array([self.rate(actor, float(t)) for t in ts],
                        np.float64)

    def fleet_trace(self, horizon_s: float, dt: float) -> np.ndarray:
        """The summed offered load of every lane on the same grid."""
        total = np.zeros(int(math.ceil(horizon_s / dt)), np.float64)
        for a in range(self.cfg.n_actors):
            total += self.trace(a, horizon_s, dt)[: total.shape[0]]
        return total
