"""Action rescaling between the policy's tanh range and an env's box.

Counterpart of the action half of ``d4pg_tpu/envs/wrappers.py``
(``rescale_action``, ``inverse_rescale_action``,
``RescaleActionWrapper``), copied as it is: numpy only. The goal
observations (``GoalObs``, ``flatten_goal_obs``) and ``FrameStack`` wait
for the HER and pixel slices of the port.
"""

from __future__ import annotations

import numpy as np


def rescale_action(action: np.ndarray, low: np.ndarray,
                   high: np.ndarray) -> np.ndarray:
    """tanh range (-1, 1) -> [low, high]."""
    return low + (action + 1.0) * 0.5 * (high - low)


def inverse_rescale_action(action: np.ndarray, low: np.ndarray,
                           high: np.ndarray) -> np.ndarray:
    """[low, high] -> (-1, 1)."""
    return 2.0 * (action - low) / (high - low) - 1.0


class RescaleActionWrapper:
    """gymnasium wrapper form of ``rescale_action`` for single envs."""

    def __init__(self, env):
        self.env = env
        self.low = np.asarray(env.action_space.low, np.float32)
        self.high = np.asarray(env.action_space.high, np.float32)

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action):
        return self.env.step(rescale_action(np.asarray(action), self.low,
                                            self.high))

    def __getattr__(self, name):
        return getattr(self.env, name)
