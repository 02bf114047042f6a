"""Actor workers: env stepping, exploration, transition streaming.

Counterpart of ``ActorWorker`` in ``d4pg_tpu/distributed/actor.py``: a
composition of a policy client (``serving/client.LocalPolicyClient``:
weight pulls, noise, epsilon) and a lane (``serving/lane.VectorActorLane``:
the pool, the n-step folder and the sends), sharing one stop event.
Actors are stateless-restartable: everything one owns is rebuilt on
restart; replay and weights live with the learner. The goal-conditioned
HER worker waits for the HER slice of the port.
"""

from __future__ import annotations

import threading

from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.serving.client import ActorConfig, LocalPolicyClient
from d4pg_tpu_torch.serving.lane import VectorActorLane


class ActorWorker:
    """Acting loop over a vectorized EnvPool with n-step folding; ``run``
    is resumable (see ``VectorActorLane``)."""

    def __init__(
        self,
        actor_id: str,
        config: D4PGConfig,
        actor_cfg: ActorConfig,
        pool: EnvPool,
        service,
        weights,
        seed: int = 0,
        learner_device=None,
        obs_dtype=None,
    ):
        self.actor_id = actor_id
        self.config = config
        self.cfg = actor_cfg
        self.service = service
        self.weights = weights
        self.policy = LocalPolicyClient(config, actor_cfg, weights, seed=seed,
                                        learner_device=learner_device)
        self.pool = pool
        self._stop = threading.Event()
        self._lane = VectorActorLane(actor_id, config, actor_cfg, pool,
                                     service, self.policy, stop=self._stop,
                                     obs_dtype=obs_dtype)

    def run(self, max_steps: int) -> int:
        """Collect ``max_steps`` pool ticks (E transitions per tick)."""
        return self._lane.run(max_steps)

    @property
    def env_steps(self) -> int:
        return self._lane.env_steps

    @property
    def dropped_batches(self) -> int:
        return self._lane.dropped_batches

    def stop(self) -> None:
        self._stop.set()
