"""Action rescaling between the policy's tanh range and an env's box,
and frame stacking for pixel envs.

Counterpart of ``rescale_action``, ``inverse_rescale_action``,
``RescaleActionWrapper`` and ``FrameStack`` in
``d4pg_tpu/envs/wrappers.py``: numpy only. ``FrameStack`` advertises its
space as the port's duck-typed ``envs.fake._Box`` where the reference
builds a gymnasium ``Box`` (the card has no gymnasium). The goal
observations (``GoalObs``, ``flatten_goal_obs``) wait for the HER slice
of the port.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from d4pg_tpu_torch.envs.fake import _Box


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


class FrameStack:
    """Stack the last ``k`` pixel observations along the channel axis:
    [H, W, C] -> [H, W, C * k], the newest frame last; ``reset`` fills
    the stack with k copies of the first frame. uint8 in, uint8 out, so
    the replay ring stores stacked rows as they are. A single frame hides
    velocities; the stack restores the Markov property (DQN's 4-stack,
    DrQ's 3-stack)."""

    def __init__(self, env, k: int):
        if k < 1:
            raise ValueError(f"frame_stack must be >= 1, got {k}")
        self.env = env
        self._k = int(k)
        self._frames: deque = deque(maxlen=self._k)
        space = env.observation_space
        if len(space.shape) != 3:
            raise ValueError(
                f"FrameStack wraps pixel [H, W, C] observations, got "
                f"shape {space.shape}")
        h, w, c = space.shape
        dtype = getattr(space, "dtype", None)
        if dtype is None:
            dtype = np.asarray(space.low).dtype
        # bounds tile, not repeat: the layout is whole frames
        # concatenated [c0, c1, c2, c0, c1, c2, ...]
        self.observation_space = _Box(
            np.tile(np.asarray(space.low), (1, 1, self._k)),
            np.tile(np.asarray(space.high), (1, 1, self._k)),
            (h, w, c * self._k), dtype)
        self.action_space = env.action_space

    def _stacked(self):
        return np.concatenate(list(self._frames), axis=-1)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        for _ in range(self._k):
            self._frames.append(obs)
        return self._stacked(), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._frames.append(obs)
        return self._stacked(), reward, terminated, truncated, info

    def close(self):
        if hasattr(self.env, "close"):
            self.env.close()
