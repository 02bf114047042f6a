"""Hindsight Experience Replay: future-strategy relabeling.

Counterpart of ``d4pg_tpu/envs/her.py``, numpy only: with probability
``her_ratio`` per transition, a goal achieved at a future step of the
same episode takes the place of the desired goal, the reward is
recomputed with the env's ``compute_reward``, and the relabeled
transition is stored beside the original. Every field is indexed by the
transition's own step ``t``, its action included (the reference's
documented fix of the original implementation, which stored the
episode's last action). The draws come from the caller's numpy
``Generator`` in the reference's order (``random(T)`` for the selection,
then ``integers(sel + 1, T + 1)`` for the future steps), so one seed gives
the same relabels in both packages.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from d4pg_tpu_torch.replay.uniform import TransitionBatch


def her_relabel(
    observation: np.ndarray,  # [T, obs_dim]   raw (goal-free) observations
    achieved_goal: np.ndarray,  # [T+1, goal_dim] achieved goals incl. final
    action: np.ndarray,  # [T, act_dim]
    next_observation: np.ndarray,  # [T, obs_dim]
    compute_reward: Callable[..., np.ndarray],  # (ag, dg, info) GoalEnv API
    rng: np.random.Generator,
    her_ratio: float = 0.8,
    gamma: float = 0.99,
) -> TransitionBatch:
    """The relabeled transitions of one episode, and only those.

    For each selected t, k is drawn uniform in [t+1, T] and
    ``achieved_goal[k]`` becomes the desired goal; the reward is
    ``compute_reward(achieved_goal[t+1], new_goal)`` and the transition is
    terminal where that reward is 0 (success under the sparse -1/0
    convention). Policy inputs come back goal-concatenated ([obs, goal])
    with ``discount = gamma * (1 - done)`` (relabels are 1-step)."""
    T = action.shape[0]
    sel = np.nonzero(rng.random(T) < her_ratio)[0]
    if sel.size == 0:
        obs_dim = observation.shape[-1] + achieved_goal.shape[-1]
        z = np.zeros((0,), np.float32)
        return TransitionBatch(
            obs=np.zeros((0, obs_dim), np.float32),
            action=np.zeros((0, action.shape[-1]), np.float32),
            reward=z,
            next_obs=np.zeros((0, obs_dim), np.float32),
            done=z,
            discount=z,
        )
    # future step k in [t+1, T] per selected t: achieved_goal has T+1 rows
    k = rng.integers(sel + 1, T + 1)
    new_goal = achieved_goal[k]  # [S, goal_dim]
    reward = np.asarray(
        compute_reward(achieved_goal[sel + 1], new_goal, None), np.float32
    ).reshape(-1)
    done = (reward == 0.0).astype(np.float32)
    return TransitionBatch(
        obs=np.concatenate([observation[sel], new_goal],
                           axis=-1).astype(np.float32),
        action=action[sel].astype(np.float32),
        reward=reward,
        next_obs=np.concatenate([next_observation[sel], new_goal],
                                axis=-1).astype(np.float32),
        done=done,
        discount=(gamma * (1.0 - done)).astype(np.float32),
    )
