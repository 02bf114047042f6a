"""The fleet plane's drills.

Counterpart of ``d4pg_tpu/fleet/``, ported one drill at a time:
``learner_chaos`` (replica kills against the update plane),
``elastic_chaos`` (a flash crowd against the autoscaler, A/B) and
``mesh_ab`` (socket against collective aggregation, A/B) are here; the
fan-out harness, the fault policy, the sweeps and the other drills wait
for ROADMAP Queue 1 item 17c.
"""

from d4pg_tpu_torch.fleet.elastic_chaos import (
    ElasticChaosConfig,
    run_elastic_chaos,
)
from d4pg_tpu_torch.fleet.learner_chaos import (
    LearnerChaosConfig,
    run_learner_chaos,
)
from d4pg_tpu_torch.fleet.mesh_ab import MeshABConfig, run_mesh_ab

__all__ = ["ElasticChaosConfig", "LearnerChaosConfig", "MeshABConfig",
           "run_elastic_chaos", "run_learner_chaos", "run_mesh_ab"]
