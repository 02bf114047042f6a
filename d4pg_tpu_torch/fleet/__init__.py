"""The fleet plane's drills.

Counterpart of ``d4pg_tpu/fleet/``, ported one drill at a time:
``learner_chaos`` (replica kills against the update plane) is here; the
fan-out harness, the fault policy, the sweeps and the other drills wait
for ROADMAP Queue 1 item 17c.
"""

from d4pg_tpu_torch.fleet.learner_chaos import (
    LearnerChaosConfig,
    run_learner_chaos,
)

__all__ = ["LearnerChaosConfig", "run_learner_chaos"]
