"""The fleet plane's drills.

Counterpart of ``d4pg_tpu/fleet/``, ported one drill at a time:
``learner_chaos`` (replica kills against the update plane) and
``elastic_chaos`` (a flash crowd against the autoscaler, A/B) are here;
the fan-out harness, the fault policy, the sweeps and the other drills
wait for ROADMAP Queue 1 item 17c.
"""

from d4pg_tpu_torch.fleet.elastic_chaos import (
    ElasticChaosConfig,
    run_elastic_chaos,
)
from d4pg_tpu_torch.fleet.learner_chaos import (
    LearnerChaosConfig,
    run_learner_chaos,
)

__all__ = ["ElasticChaosConfig", "LearnerChaosConfig", "run_elastic_chaos",
           "run_learner_chaos"]
