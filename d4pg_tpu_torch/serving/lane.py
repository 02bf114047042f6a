"""VectorActorLane: the env-stepping half of acting.

Counterpart of ``d4pg_tpu/serving/lane.py``. One lane owns an ``EnvPool``
(E envs stepping in lockstep), an n-step folder and a transition sink (a
``ReplayService``); the policy queries go through an injected policy
client (``serving/client.LocalPolicyClient``). The tick order
is the reference's: poll gate -> act -> step -> fold -> send -> noise
reset -> epsilon decay. ``run`` is resumable: the pool is reset once, and
the episode state and the n-step window persist across calls, so a cycle
boundary never restarts episodes or drops pending window entries.
"""

from __future__ import annotations

import threading

from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.replay.nstep import NStepFolder
from d4pg_tpu_torch.serving.client import ActorConfig, LocalPolicyClient


class VectorActorLane:
    """Batched acting loop over a vectorized EnvPool with n-step folding."""

    def __init__(
        self,
        lane_id: str,
        config: D4PGConfig,
        actor_cfg: ActorConfig,
        pool: EnvPool,
        service,
        policy: LocalPolicyClient,
        stop: threading.Event | None = None,
        obs_dtype=None,
    ):
        self.lane_id = lane_id
        self.config = config
        self.cfg = actor_cfg
        self.pool = pool
        self.service = service
        self.policy = policy
        # pixel rows fold as [H, W, C] frames of their own dtype
        self._folder = NStepFolder(
            actor_cfg.n_step, actor_cfg.gamma, pool.num_envs,
            config.obs_spec, config.act_dim, obs_dtype=obs_dtype)
        self._obs = None
        self._stop = stop if stop is not None else threading.Event()
        self.env_steps = 0
        # ``service.add`` returning False (its shard deque stayed full past
        # the timeout) means rows were lost: counted, never silent
        self.dropped_batches = 0

    def run(self, max_steps: int) -> int:
        """Collect ``max_steps`` pool ticks (E transitions per tick)."""
        if self._obs is None:
            self._obs = self.pool.reset()
            self._folder.reset()
        obs = self._obs
        policy = self.policy
        policy.pull()
        for tick in range(max_steps):
            if self._stop.is_set():
                break
            if tick % self.cfg.weight_poll_every == 0:
                policy.pull()
            actions = policy.actions(obs)
            out = self.pool.step(actions)
            folded = self._folder.step(
                obs, actions, out.reward * self.cfg.reward_scale,
                out.final_obs, out.terminated, out.truncated)
            if not self.service.add(folded, actor_id=self.lane_id):
                self.dropped_batches += 1
            done_any = out.terminated | out.truncated
            policy.reset_noise(done_any)
            for _ in range(int(done_any.sum())):
                policy.decay_epsilon()
            obs = out.obs
            self.env_steps += self.pool.num_envs
        self._obs = obs
        return self.env_steps

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.policy.close()
        self.pool.close()
