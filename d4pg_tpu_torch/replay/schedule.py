"""Annealing schedules.

Counterpart of ``d4pg_tpu/replay/schedule.py``. ``LinearSchedule`` is a
pure function of an explicit step ``t`` (the learner's step counter), so
it resumes exactly from a checkpointed step. ``SharedBetaSchedule`` is
the one PER-beta anneal clock of every sampler in a process (the
learner replicas, the dealer): replicas at the same global step use the
same beta, so the anneal rate does not grow with their number.
"""

from __future__ import annotations

import dataclasses
import itertools


@dataclasses.dataclass(frozen=True)
class LinearSchedule:
    schedule_timesteps: int
    final_p: float
    initial_p: float = 1.0

    def value(self, t: int | float):
        """Linear interpolation initial_p -> final_p, clamped after T."""
        frac = min(float(t) / float(self.schedule_timesteps), 1.0)
        return self.initial_p + frac * (self.final_p - self.initial_p)


class SharedBetaSchedule:
    """A shared anneal clock: ``advance`` claims ticks from one
    ``itertools.count`` (one ``next()`` is atomic under the GIL, so
    concurrent claimers never take a tick twice), and :meth:`beta_at` is
    a pure function of an explicit step, so two callers holding the same
    step compute the same beta however their claims interleave.
    ``current_step`` is an advisory read of the progress."""

    def __init__(self, beta0: float = 0.4, beta_steps: int = 100_000,
                 start_step: int = 0):
        self.beta0 = float(beta0)
        self.beta_steps = int(beta_steps)
        self._steps = itertools.count(int(start_step))
        self._completed = int(start_step)

    def current_step(self) -> int:
        """The step the next claimer would get, without claiming it;
        callers read it once per chunk so beta is constant within it."""
        return self._completed

    def beta_at(self, t: int) -> float:
        """Linear anneal beta0 -> 1.0 over ``beta_steps``, then clamped
        (the reference's expression, in Python floats)."""
        frac = min(1.0, t / max(1, self.beta_steps))
        return self.beta0 + (1.0 - self.beta0) * frac

    def advance(self, n: int) -> int:
        """Claim ``n`` ticks; returns the first one claimed."""
        first = next(self._steps)
        for _ in range(int(n) - 1):
            next(self._steps)
        self._completed = first + int(n)
        return first
