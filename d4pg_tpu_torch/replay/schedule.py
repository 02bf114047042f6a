"""Annealing schedules.

Counterpart of ``LinearSchedule`` in ``d4pg_tpu/replay/schedule.py``: a
pure function of an explicit step ``t`` (the learner's step counter), so
it resumes exactly from a checkpointed step. The process-wide
``SharedBetaSchedule`` of the multi-learner plane waits for that slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinearSchedule:
    schedule_timesteps: int
    final_p: float
    initial_p: float = 1.0

    def value(self, t: int | float):
        """Linear interpolation initial_p -> final_p, clamped after T."""
        frac = min(float(t) / float(self.schedule_timesteps), 1.0)
        return self.initial_p + frac * (self.final_p - self.initial_p)
