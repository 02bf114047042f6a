"""Vectorized environment pool.

Counterpart of ``d4pg_tpu/envs/vector.py``, copied as it is (numpy only).
The pool steps E envs in lockstep so the policy runs one batched forward
per tick. Autoreset: when an env terminates or truncates, the pool resets
it at once and returns the reset observation in ``obs``, with the true
final observation in ``final_obs``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from d4pg_tpu_torch.envs.wrappers import rescale_action


class PoolStep(NamedTuple):
    obs: np.ndarray  # [E, obs_dim] next obs (post-autoreset)
    reward: np.ndarray  # [E]
    terminated: np.ndarray  # [E] bool
    truncated: np.ndarray  # [E] bool
    final_obs: np.ndarray  # [E, obs_dim] pre-reset obs (== obs where not done)


class EnvPool:
    """Synchronous pool of E gymnasium-API envs with batched IO."""

    def __init__(self, env_fns: list[Callable[[], object]], seed: int = 0):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        space = self.envs[0].action_space
        self._low = np.asarray(space.low, np.float32)
        self._high = np.asarray(space.high, np.float32)
        self._seed = seed
        self._ep_return = np.zeros(self.num_envs, np.float64)
        self._ep_length = np.zeros(self.num_envs, np.int64)
        self.episode_returns: list[float] = []
        self.episode_lengths: list[int] = []

    @staticmethod
    def _stack(obs_list: list) -> np.ndarray:
        """Stack observations, downcasting floats to float32 but keeping
        integer dtypes untouched."""
        out = np.stack(obs_list)
        if np.issubdtype(out.dtype, np.floating) and out.dtype != np.float32:
            out = out.astype(np.float32)
        return out

    def reset(self) -> np.ndarray:
        obs = [e.reset(seed=self._seed + i)[0]
               for i, e in enumerate(self.envs)]
        self._ep_return[:] = 0.0
        self._ep_length[:] = 0
        return self._stack(obs)

    def step(self, actions: np.ndarray) -> PoolStep:
        """actions in tanh range (-1,1); rescaled per-env to [low, high]."""
        actions = rescale_action(np.asarray(actions), self._low, self._high)
        obs_l, rew_l, term_l, trunc_l, final_l = [], [], [], [], []
        for i, env in enumerate(self.envs):
            obs, r, term, trunc, _ = env.step(actions[i])
            self._ep_return[i] += r
            self._ep_length[i] += 1
            final_l.append(obs)
            if term or trunc:
                self.episode_returns.append(float(self._ep_return[i]))
                self.episode_lengths.append(int(self._ep_length[i]))
                self._ep_return[i] = 0.0
                self._ep_length[i] = 0
                obs, _ = env.reset()
            obs_l.append(obs)
            rew_l.append(r)
            term_l.append(term)
            trunc_l.append(trunc)
        return PoolStep(
            obs=self._stack(obs_l),
            reward=np.asarray(rew_l, np.float32),
            terminated=np.asarray(term_l, bool),
            truncated=np.asarray(trunc_l, bool),
            final_obs=self._stack(final_l),
        )

    def close(self) -> None:
        for env in self.envs:
            close = getattr(env, "close", None)
            if close:
                close()
