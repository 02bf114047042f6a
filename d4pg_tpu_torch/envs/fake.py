"""Fake environments for tests and the card: no MuJoCo, no gymnasium.

Counterpart of ``PointMassEnv`` and ``SlowEnv`` in
``d4pg_tpu/envs/fake.py``, copied as they are (numpy only): the same
seeds give the same trajectories in both packages. The pixel and goal
fake envs wait for the pixel and HER slices of the port.
"""

from __future__ import annotations

import time

import numpy as np


class _Box:
    def __init__(self, low, high, shape):
        self.low = np.full(shape, low, np.float32)
        self.high = np.full(shape, high, np.float32)
        self.shape = shape


class SlowEnv:
    """Wrap an env with a fixed wall-clock cost per ``step()``, emulating
    a physics-bound env (a sleep, so the CPU stays free)."""

    def __init__(self, env, step_seconds: float):
        self._env = env
        self._step_seconds = step_seconds
        self.action_space = env.action_space
        self.observation_space = env.observation_space

    def reset(self, seed=None, **kw):
        return self._env.reset(seed=seed, **kw)

    def step(self, action):
        time.sleep(self._step_seconds)
        return self._env.step(action)

    def close(self):
        self._env.close()

    def __getattr__(self, name):
        return getattr(self._env, name)


class PointMassEnv:
    """2-D point mass: action = acceleration, reward = -|pos| - 0.01|a|^2."""

    def __init__(self, horizon: int = 100, seed: int = 0):
        self.horizon = horizon
        self.action_space = _Box(-1.0, 1.0, (2,))
        self.observation_space = _Box(-np.inf, np.inf, (4,))
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._pos = np.zeros(2, np.float32)
        self._vel = np.zeros(2, np.float32)

    def reset(self, seed=None, **kw):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = self._rng.uniform(-1, 1, 2).astype(np.float32)
        self._vel = np.zeros(2, np.float32)
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        return np.concatenate([self._pos, self._vel]).astype(np.float32)

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        self._vel = 0.9 * self._vel + 0.1 * action
        self._pos = self._pos + self._vel
        self._t += 1
        reward = float(-np.linalg.norm(self._pos) - 0.01 * np.sum(action**2))
        truncated = self._t >= self.horizon
        return self._obs(), reward, False, truncated, {}

    def close(self):
        pass
