"""The elastic traffic plane: a seeded load model, the obs-driven
autoscaler and its decision ledger, and SLO admission control.

Counterpart of ``d4pg_tpu/elastic``. Numpy and the stdlib only:

- ``traffic``: the seeded offered-load model (diurnal curve, flash
  crowds, per-lane Pareto rates), every trace bit for bit replayable
  from its seed;
- ``admission``: priority classes over actor and lane identity, and the
  per-class shed and budget policy that ``ReplayService`` and
  ``PolicyInferenceServer`` enforce at admission;
- ``autoscaler`` and ``ledger``: the control loop (sense the registry's
  providers, decide with hysteresis, actuate live knobs) and the
  journal that makes every run's decision stream replayable.
"""

from d4pg_tpu_torch.elastic.admission import AdmissionPolicy
from d4pg_tpu_torch.elastic.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    ControlPolicy,
    extract_signals,
)
from d4pg_tpu_torch.elastic.ledger import ScalingLedger
from d4pg_tpu_torch.elastic.traffic import TrafficConfig, TrafficModel

__all__ = [
    "AdmissionPolicy",
    "Autoscaler",
    "AutoscalerConfig",
    "ControlPolicy",
    "ScalingLedger",
    "TrafficConfig",
    "TrafficModel",
    "extract_signals",
]
