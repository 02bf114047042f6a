"""The fleet plane: fan-out stress harness with seeded fault injection.

Counterpart of ``d4pg_tpu/fleet/``. ``FleetHarness`` runs N throttled
sender lanes against one ``ReplayService`` receiver over real TCP, a
seeded ``ChaosPolicy`` injects drops, delays, crashes, receiver stalls
and service kills at the transport boundary, and the harness reports
what survived: rows/s, latency percentiles, every counted loss and the
recovery times. ``sweep`` walks N and K and runs the drills:
``learner_chaos`` (replica kills against the update plane),
``elastic_chaos`` (a flash crowd against the autoscaler, A/B),
``mesh_ab`` (socket against collective aggregation, A/B),
``weight_chaos`` (the broadcast plane), ``serving_chaos`` (the action
path, its server on the card) and ``sampler_chaos`` (the dealt sample
paths, host, dealer and device). Every drill runs the lock plane in
record mode (``core.locking.record_mode``) and reports its violations.
"""

from d4pg_tpu_torch.fleet.chaos import (
    ActorChaos,
    ChaosConfig,
    ChaosEvent,
    ChaosPolicy,
    StallGate,
)
from d4pg_tpu_torch.fleet.elastic_chaos import (
    ElasticChaosConfig,
    run_elastic_chaos,
)
from d4pg_tpu_torch.fleet.harness import FleetConfig, FleetHarness
from d4pg_tpu_torch.fleet.learner_chaos import (
    LearnerChaosConfig,
    run_learner_chaos,
)
from d4pg_tpu_torch.fleet.mesh_ab import MeshABConfig, run_mesh_ab
from d4pg_tpu_torch.fleet.sender import ThrottledSender, synthetic_block
from d4pg_tpu_torch.fleet.sweep import (
    SWEEP_NS,
    default_chaos,
    run_sweep,
    shard_sweep,
)

__all__ = [
    "ActorChaos",
    "ChaosConfig",
    "ChaosEvent",
    "ChaosPolicy",
    "StallGate",
    "FleetConfig",
    "FleetHarness",
    "ThrottledSender",
    "synthetic_block",
    "SWEEP_NS",
    "default_chaos",
    "run_sweep",
    "shard_sweep",
    "ElasticChaosConfig",
    "LearnerChaosConfig",
    "MeshABConfig",
    "run_elastic_chaos",
    "run_learner_chaos",
    "run_mesh_ab",
]
