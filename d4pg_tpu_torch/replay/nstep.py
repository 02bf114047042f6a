"""N-step transition folding at insert time.

Counterpart of ``d4pg_tpu/replay/nstep.py``, copied as it is (numpy
only). The folder keeps a sliding window of the last n transitions per
environment and emits folded transitions

    (s_t, a_t, R_t^{(m)} = sum_{k<m} gamma^k r_{t+k}, s_{t+m}, done, disc)

with ``disc = gamma^m * (1 - done)`` baked in, so the learner's Bellman
backup is ``R + disc * Z(s')`` whatever n, truncation or episode tail:

  - a full window emits the oldest entry with m = n,
  - termination (``done``) flushes every pending entry with done=1, disc=0,
  - time-limit truncation flushes with done=0, disc=gamma^m so the value
    bootstraps.
"""

from __future__ import annotations

import numpy as np

from d4pg_tpu_torch.replay.uniform import TransitionBatch


class NStepFolder:
    def __init__(
        self, n: int, gamma: float, num_envs: int, obs_dim: int | tuple,
        act_dim: int, obs_dtype=None,
    ):
        if n < 1:
            raise ValueError(f"n-step horizon must be >= 1, got {n}")
        self.n = int(n)
        self.gamma = float(gamma)
        self.num_envs = int(num_envs)
        obs_shape = (obs_dim,) if np.isscalar(obs_dim) else tuple(obs_dim)
        if obs_dtype is None:
            obs_dtype = np.float32 if len(obs_shape) == 1 else np.uint8
        self._obs_shape = obs_shape
        self._obs = np.zeros((num_envs, n, *obs_shape), obs_dtype)
        self._act = np.zeros((num_envs, n, act_dim), np.float32)
        self._rew = np.zeros((num_envs, n), np.float32)
        self._count = np.zeros(num_envs, np.int64)
        self._pow = self.gamma ** np.arange(n, dtype=np.float32)

    def reset(self) -> None:
        """Drop all pending window entries (call when the envs reset
        outside the folder's view, so nothing is stitched across it)."""
        self._count[:] = 0

    def _fold_tail(self, e: int, next_obs_e: np.ndarray, done: float,
                   out: list):
        """Emit all pending entries of env e against next_obs_e."""
        c = int(self._count[e])
        for j in range(c):
            m = c - j
            reward = float(np.dot(self._rew[e, j:c], self._pow[:m]))
            disc = 0.0 if done else self.gamma**m
            out.append((self._obs[e, j].copy(), self._act[e, j].copy(),
                        reward, next_obs_e.copy(), done, disc))
        self._count[e] = 0

    def step(
        self,
        obs: np.ndarray,
        action: np.ndarray,
        reward: np.ndarray,
        next_obs: np.ndarray,
        done: np.ndarray,
        truncated: np.ndarray | None = None,
    ) -> TransitionBatch:
        """Feed one vector-env step ([E, ...] arrays); returns the folded
        transitions as numpy arrays (possibly 0 rows)."""
        e_ids = np.arange(self.num_envs)
        done = np.asarray(done, bool)
        truncated = (np.zeros(self.num_envs, bool) if truncated is None
                     else np.asarray(truncated, bool))
        # insert the current transition into each env's window
        c = self._count
        self._obs[e_ids, c] = obs
        self._act[e_ids, c] = action
        self._rew[e_ids, c] = reward
        self._count += 1

        rows: list[tuple] = []
        # ordinary full-window emission for live envs
        live_full = (~done) & (~truncated) & (self._count == self.n)
        for e in np.nonzero(live_full)[0]:
            reward_n = float(np.dot(self._rew[e], self._pow))
            rows.append((self._obs[e, 0].copy(), self._act[e, 0].copy(),
                         reward_n, next_obs[e].copy(), 0.0,
                         self.gamma**self.n))
            # slide the window left by one
            self._obs[e, :-1] = self._obs[e, 1:]
            self._act[e, :-1] = self._act[e, 1:]
            self._rew[e, :-1] = self._rew[e, 1:]
            self._count[e] = self.n - 1
        # episode boundaries flush everything pending
        for e in np.nonzero(done)[0]:
            self._fold_tail(e, next_obs[e], done=1.0, out=rows)
        for e in np.nonzero(truncated & ~done)[0]:
            self._fold_tail(e, next_obs[e], done=0.0, out=rows)

        if not rows:
            z = np.zeros((0,), np.float32)
            return TransitionBatch(
                obs=np.zeros((0, *self._obs_shape), self._obs.dtype),
                action=np.zeros((0, self._act.shape[-1]), np.float32),
                reward=z,
                next_obs=np.zeros((0, *self._obs_shape), self._obs.dtype),
                done=z,
                discount=z,
            )
        obs_a, act_a, rew_a, nxt_a, dn_a, dc_a = zip(*rows)
        return TransitionBatch(
            obs=np.stack(obs_a),
            action=np.stack(act_a),
            reward=np.asarray(rew_a, np.float32),
            next_obs=np.stack(nxt_a),
            done=np.asarray(dn_a, np.float32),
            discount=np.asarray(dc_a, np.float32),
        )
