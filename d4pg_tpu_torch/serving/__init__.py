"""The serving plane of the PyTorch port (counterpart of
``d4pg_tpu/serving``).

- ``protocol``: the CRC-framed request/response frames (0xD4E2/0xD4E3),
  byte-equal to the reference's.
- ``client``: ``ActorConfig``, the acting-device helper,
  ``LocalPolicyClient`` (in-process inference) and ``RemotePolicyClient``
  (wire round trips with a counted degradation ladder).
- ``server``: ``PolicyInferenceServer`` (windowed batching into padded
  power-of-two buckets, fenced adoption, the ``serving`` provider) and
  ``ServingChaos`` (torn-response injection).
- ``lane``: ``VectorActorLane``, the env-stepping half of acting.
"""

from d4pg_tpu_torch.serving.client import (  # noqa: F401
    ActorConfig,
    LocalPolicyClient,
    RemotePolicyClient,
)
from d4pg_tpu_torch.serving.lane import VectorActorLane  # noqa: F401
from d4pg_tpu_torch.serving.server import (  # noqa: F401
    PolicyInferenceServer,
    ServingChaos,
)
