"""DM-Control suite adapter: pixel observations through the gymnasium API.

Counterpart of ``d4pg_tpu/envs/dmc.py``: any ``dm_control.suite`` task
as the five-tuple env the rest of the port consumes (``EnvPool``,
``train.make_env_fn``), with

  - pixel observations rendered on the physics camera as [H, W, 3] uint8
    (what ``train.infer_dims`` routes to the conv-encoder path), or
    flattened float32 state observations when ``pixels=False``;
  - an action repeat (the policy acts every ``action_repeat`` control
    steps; rewards are summed);
  - dm_control's time-limit end reported as ``truncated`` (the suite's
    tasks never terminate early).

dm_control is imported inside ``DMControlEnv`` only; without it,
building the env raises an ``ImportError`` that names dm_control.
Rendering needs an offscreen GL backend; ``MUJOCO_GL`` defaults to EGL
before MuJoCo loads (set it to override). The spaces are the port's
duck-typed ``envs.fake._Box`` (no gymnasium needed).
"""

from __future__ import annotations

import os

import numpy as np

from d4pg_tpu_torch.envs.fake import _Box


class DMControlEnv:
    """One ``dm_control.suite`` task behind the gymnasium five-tuple API."""

    def __init__(
        self,
        domain: str,
        task: str,
        pixels: bool = True,
        height: int = 84,
        width: int = 84,
        camera_id: int = 0,
        action_repeat: int = 4,
        seed: int = 0,
    ):
        os.environ.setdefault("MUJOCO_GL", "egl")
        try:
            from dm_control import suite
        except ImportError as e:
            raise ImportError(
                f"the dm_control env {domain}-{task} needs the dm_control "
                "package, which is not installed") from e

        self._suite = suite
        self._domain, self._task = domain, task
        self._pixels = pixels
        self._height, self._width, self._camera = height, width, camera_id
        self._repeat = max(1, int(action_repeat))
        self._env = suite.load(domain, task, task_kwargs={"random": seed})

        spec = self._env.action_spec()
        self.action_space = _Box(np.asarray(spec.minimum, np.float32),
                                 np.asarray(spec.maximum, np.float32),
                                 spec.shape)
        if pixels:
            self.observation_space = _Box(0, 255, (height, width, 3),
                                          np.uint8)
        else:
            dim = sum(
                int(np.prod(v.shape)) if v.shape else 1
                for v in self._env.observation_spec().values()
            )
            self.observation_space = _Box(-np.inf, np.inf, (dim,))

    def _obs(self, timestep):
        if self._pixels:
            return self._env.physics.render(
                height=self._height, width=self._width, camera_id=self._camera
            )
        parts = [
            np.atleast_1d(np.asarray(v, np.float32)).ravel()
            for v in timestep.observation.values()
        ]
        return np.concatenate(parts).astype(np.float32)

    def reset(self, seed=None, **kw):
        if seed is not None:
            # re-seed in place (a rebuild through suite.load would leak the
            # native physics and recompile the MJCF per seeded reset); the
            # attribute is private, so a rename falls back to a rebuild
            if hasattr(self._env.task, "_random"):
                self._env.task._random = np.random.RandomState(seed)
            else:
                self._env.close()
                self._env = self._suite.load(
                    self._domain, self._task, task_kwargs={"random": seed}
                )
        ts = self._env.reset()
        return self._obs(ts), {}

    def step(self, action):
        action = np.clip(
            np.asarray(action, np.float32),
            self.action_space.low,
            self.action_space.high,
        )
        reward, ts = 0.0, None
        for _ in range(self._repeat):
            ts = self._env.step(action)
            reward += float(ts.reward or 0.0)
            if ts.last():
                break
        # suite tasks end only by time limit -> truncation, never termination
        return self._obs(ts), reward, False, bool(ts.last()), {}

    def close(self):
        self._env.close()


def parse_dmc_id(env_id: str):
    """``'dmc:cheetah-run'`` / ``'dmc:cheetah-run-pixels'`` /
    ``'cheetah-run-pixels'`` -> (domain, task, pixels), or None when the
    id is not a dm_control spec."""
    name = env_id[4:] if env_id.startswith("dmc:") else env_id
    pixels = name.endswith("-pixels")
    if pixels:
        name = name[: -len("-pixels")]
    elif not env_id.startswith("dmc:"):
        return None
    if "-" not in name:
        return None
    domain, task = name.split("-", 1)
    return domain, task, pixels
