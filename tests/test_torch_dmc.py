"""Port vs reference: the DM-Control adapter (``envs/dmc.py``).

``parse_dmc_id`` as the reference's ``tests/test_dmc.py`` pins it; the
adapter imports dm_control only when an env is built, and without it
raises an ``ImportError`` that names dm_control; the driver routes
``dmc:*`` and ``*-pixels`` ids to it. Where dm_control and an offscreen
GL backend are present, the env contracts (pixel and state) are
re-asserted on the port, and a pixel env gives the reference's frames
for one seed; without them those tests skip, as the reference's do.
"""

import sys

import numpy as np
import pytest

from d4pg_tpu.envs.dmc import DMControlEnv as JaxDMControlEnv
from d4pg_tpu_torch import train as ttrain
from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.envs.dmc import DMControlEnv, parse_dmc_id

pytestmark = pytest.mark.torchport


def test_parse_dmc_id():
    assert parse_dmc_id("cheetah-run-pixels") == ("cheetah", "run", True)
    assert parse_dmc_id("dmc:cheetah-run-pixels") == ("cheetah", "run", True)
    assert parse_dmc_id("dmc:cartpole-swingup") == ("cartpole", "swingup",
                                                     False)
    assert parse_dmc_id("dmc:ball_in_cup-catch") == ("ball_in_cup", "catch",
                                                      False)
    assert parse_dmc_id("Pendulum-v1") is None
    assert parse_dmc_id("HalfCheetah-v4") is None
    assert parse_dmc_id("point") is None
    assert parse_dmc_id("dmc:cheetah") is None


def test_without_dm_control_the_env_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "dm_control", None)
    with pytest.raises(ImportError, match="dm_control"):
        DMControlEnv("cheetah", "run")


@pytest.mark.parametrize("env,pixels,stack", [
    ("dmc:cheetah-run", False, 1), ("cheetah-run-pixels", True, 1),
    ("dmc:cartpole-swingup-pixels", True, 3)])
def test_driver_routes_dmc_ids_to_the_adapter(monkeypatch, env, pixels,
                                              stack):
    built = []

    class Fake:
        def __init__(self, domain, task, pixels, seed, height, width):
            built.append((domain, task, pixels, height))
            from d4pg_tpu_torch.envs.fake import _Box

            self.observation_space = _Box(0, 255, (height, width, 3),
                                          np.uint8) if pixels else \
                _Box(-np.inf, np.inf, (5,))
            self.action_space = _Box(-1, 1, (1,))

        def reset(self, **kw):
            return np.zeros(self.observation_space.shape,
                            self.observation_space.dtype), {}

        def close(self):
            pass

    monkeypatch.setattr(ttrain, "DMControlEnv", Fake)
    cfg = ExperimentConfig(env=env, frame_stack=stack, pixel_size=24)
    obs_dim, act_dim, dtype = ttrain.infer_dims(cfg)
    domain, task, _ = parse_dmc_id(env)
    assert built == [(domain, task, pixels, 24)]
    if pixels:
        assert obs_dim == (24, 24, 3 * stack) and dtype == np.uint8
    else:
        assert obs_dim == 5 and dtype == np.float32
    assert act_dim == 1


def test_driver_without_dm_control_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "dm_control", None)
    for env in ("dmc:cheetah-run", "cheetah-run-pixels"):
        with pytest.raises(ImportError, match="dm_control"):
            ttrain.train(ExperimentConfig(env=env, platform="cpu",
                                          log_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="requires a pixel env"):
        ttrain.make_env_fn(ExperimentConfig(env="dmc:cheetah-run",
                                            frame_stack=3), 0)


def _dmc_available() -> bool:
    try:
        env = DMControlEnv("cartpole", "swingup", pixels=True, height=16,
                           width=16, action_repeat=2, seed=0)
        obs, _ = env.reset()
        env.close()
        return obs.shape == (16, 16, 3)
    except Exception:
        return False


pixels_ready = pytest.mark.skipif(
    not _dmc_available(), reason="dm_control or offscreen GL unavailable")


@pixels_ready
def test_dmc_pixel_env_contract():
    env = DMControlEnv("cartpole", "swingup", pixels=True, height=16,
                       width=16, action_repeat=2, seed=0)
    obs, _ = env.reset()
    assert obs.dtype == np.uint8 and obs.shape == (16, 16, 3)
    assert env.observation_space.shape == (16, 16, 3)
    obs2, r, term, trunc, _ = env.step(np.zeros(env.action_space.shape,
                                                np.float32))
    assert obs2.shape == (16, 16, 3)
    assert isinstance(r, float)
    assert term is False
    env.close()


@pixels_ready
def test_dmc_state_env_contract_and_reference_frames():
    env = DMControlEnv("cartpole", "swingup", pixels=False, seed=0)
    obs, _ = env.reset()
    assert obs.dtype == np.float32 and obs.ndim == 1
    assert env.observation_space.shape == obs.shape
    env.close()
    port = DMControlEnv("cartpole", "swingup", pixels=True, height=16,
                        width=16, action_repeat=2, seed=3)
    ref = JaxDMControlEnv("cartpole", "swingup", pixels=True, height=16,
                          width=16, action_repeat=2, seed=3)
    np.testing.assert_array_equal(port.reset(seed=5)[0], ref.reset(seed=5)[0])
    a = np.full(port.action_space.shape, 0.5, np.float32)
    p, r = port.step(a), ref.step(a)
    np.testing.assert_array_equal(p[0], r[0])
    assert p[1:4] == r[1:4]
    port.close(), ref.close()
