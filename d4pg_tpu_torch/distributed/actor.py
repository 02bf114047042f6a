"""Actor workers: env stepping, exploration, transition streaming.

Counterpart of ``ActorWorker`` and ``GoalActorWorker`` in
``d4pg_tpu/distributed/actor.py``. ``ActorWorker`` composes a policy
client (``serving/client.LocalPolicyClient``: weight pulls, noise,
epsilon) and a lane (``serving/lane.VectorActorLane``: the pool, the
n-step folder and the sends), sharing one stop event.
``policy=`` puts another client in place of the local one (the remote
actor's ``serving/client.RemotePolicyClient``, ``actor_main
--policy_port``). ``GoalActorWorker`` drives the local client through
whole episodes of a
goal-conditioned dict-obs env and streams the originals plus their HER
relabels (``envs/her.her_relabel``). Both stream raw observations: the
replay service normalizes at insert, and the policy input goes through
the client's read-only ``obs_norm`` when there is one. Actors are
stateless-restartable: everything one owns is rebuilt on restart; replay
and weights live with the learner.
"""

from __future__ import annotations

import threading

import numpy as np

from d4pg_tpu_torch.envs.her import her_relabel
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.envs.wrappers import flatten_goal_obs, rescale_action
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.replay.uniform import TransitionBatch
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
        obs_norm=None,
        policy=None,
    ):
        self.actor_id = actor_id
        self.config = config
        self.cfg = actor_cfg
        self.service = service
        self.weights = weights
        self.policy = policy if policy is not None else LocalPolicyClient(
            config, actor_cfg, weights, seed=seed,
            learner_device=learner_device, obs_norm=obs_norm)
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

    def close(self) -> None:
        self.pool.close()


class GoalActorWorker:
    """Actor for goal-conditioned dict-obs envs with HER relabeling: whole
    episodes on one env, the original 1-step transitions plus their
    future-strategy relabels.

    As in the reference: the policy's tanh-range action is rescaled to the
    env's box for the step and stored in tanh range; ``compute_reward``
    comes from ``env.unwrapped`` when the handle is a wrapper that does
    not forward it (gymnasium 1.x); ``done`` is ``info['is_success']``
    (the env's ``terminated`` when absent); relabels are added with
    ``count_env_steps=False`` (synthetic rows, not env interaction); the
    OU state resets and epsilon decays at each episode's end."""

    def __init__(
        self,
        actor_id: str,
        config: D4PGConfig,
        actor_cfg: ActorConfig,
        env,
        service,
        weights,
        her_ratio: float = 0.8,
        rng_seed: int = 0,
        seed: int = 0,
        obs_norm=None,
        learner_device=None,
    ):
        self.actor_id = actor_id
        self.config = config
        self.cfg = actor_cfg
        self.service = service
        self.weights = weights
        self.policy = LocalPolicyClient(config, actor_cfg, weights, seed=seed,
                                        learner_device=learner_device,
                                        obs_norm=obs_norm)
        self.env = env
        self.her_ratio = her_ratio
        self._np_rng = np.random.default_rng(rng_seed)
        self.env_steps = 0
        # service.add returning False (backpressure past its timeout, or a
        # shed frame on a drop_on_timeout wire) lost rows: counted
        self.dropped_batches = 0
        self._act_low = np.asarray(env.action_space.low, np.float32)
        self._act_high = np.asarray(env.action_space.high, np.float32)
        self._compute_reward = (
            env.compute_reward if hasattr(env, "compute_reward")
            else env.unwrapped.compute_reward)

    @property
    def obs_norm(self):
        return self.policy.obs_norm

    def run_episode(self, max_steps: int) -> int:
        """Roll one episode of at most ``max_steps`` steps, stream its
        originals and relabels; returns its length T."""
        env = self.env
        self.policy.pull()
        obs_dict, _ = env.reset()
        raw_obs, achieved, actions, next_raw, rewards, dones = (
            [], [], [], [], [], [])
        achieved.append(
            np.asarray(obs_dict["achieved_goal"], np.float32).copy())
        for _ in range(max_steps):
            flat = flatten_goal_obs(obs_dict)
            if self.obs_norm is not None:
                flat = self.obs_norm.normalize(flat)
            a = self.policy.actions(flat[None])[0]
            nobs_dict, r, term, trunc, info = env.step(
                rescale_action(a, self._act_low, self._act_high))
            raw_obs.append(
                np.asarray(obs_dict["observation"], np.float32).copy())
            actions.append(a)
            next_raw.append(
                np.asarray(nobs_dict["observation"], np.float32).copy())
            rewards.append(r)
            done = bool(info.get("is_success", term))
            dones.append(float(done))
            achieved.append(
                np.asarray(nobs_dict["achieved_goal"], np.float32).copy())
            obs_dict = nobs_dict
            self.env_steps += 1
            if done or term or trunc:
                break
        T = len(actions)
        goal = np.asarray(obs_dict["desired_goal"], np.float32)
        raw_obs_a = np.stack(raw_obs)
        next_raw_a = np.stack(next_raw)
        actions_a = np.stack(actions).astype(np.float32)
        dones_a = np.asarray(dones, np.float32)
        goal_tiled = np.tile(goal, (T, 1))
        originals = TransitionBatch(
            obs=np.concatenate([raw_obs_a, goal_tiled], -1).astype(np.float32),
            action=actions_a,
            reward=np.asarray(rewards, np.float32) * self.cfg.reward_scale,
            next_obs=np.concatenate([next_raw_a, goal_tiled],
                                    -1).astype(np.float32),
            done=dones_a,
            discount=(self.cfg.gamma * (1.0 - dones_a)).astype(np.float32),
        )
        relabeled = her_relabel(
            raw_obs_a, np.stack(achieved), actions_a, next_raw_a,
            self._compute_reward, self._np_rng, self.her_ratio,
            self.cfg.gamma)
        relabeled = relabeled._replace(
            reward=relabeled.reward * self.cfg.reward_scale)
        # both batches stream raw: the service folds and normalizes them
        if not self.service.add(originals, actor_id=self.actor_id):
            self.dropped_batches += 1
        if not self.service.add(relabeled, actor_id=self.actor_id,
                                count_env_steps=False):
            self.dropped_batches += 1
        self.policy.reset_noise(np.array([True]))  # zero the OU state
        self.policy.decay_epsilon()
        return T

    def close(self) -> None:
        if hasattr(self.env, "close"):
            self.env.close()
