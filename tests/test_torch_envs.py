"""Port vs reference: the env layer (``d4pg_tpu_torch/envs``).

``EnvPool`` over ``PointMassEnv``, the presets and the action rescale are
numpy code in both packages: the same seeds and the same action sequences
must give bitwise-equal observations, rewards, terminal and truncation
flags. Then the pool properties of ``tests/test_envs.py`` that need no
HER, re-asserted on the port.
"""

import dataclasses

import numpy as np
import pytest

from d4pg_tpu.envs import EnvPool as JaxPool
from d4pg_tpu.envs import PointMassEnv as JaxPoint
from d4pg_tpu.envs import presets as jpresets
from d4pg_tpu.envs.fake import SlowEnv as JaxSlow
from d4pg_tpu.envs.wrappers import (
    inverse_rescale_action as j_inverse,
    rescale_action as j_rescale,
)
from d4pg_tpu_torch.envs import presets
from d4pg_tpu_torch.envs.fake import PointMassEnv, SlowEnv
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.envs.wrappers import (
    RescaleActionWrapper,
    inverse_rescale_action,
    rescale_action,
)

pytestmark = pytest.mark.torchport


def _pools(horizons, seed):
    def fns(cls):
        return [lambda h=h, s=i: cls(horizon=h, seed=s)
                for i, h in enumerate(horizons)]

    return EnvPool(fns(PointMassEnv), seed=seed), JaxPool(fns(JaxPoint),
                                                          seed=seed)


@pytest.mark.parametrize("horizons,seed", [((7, 7, 7, 7), 0),
                                           ((5, 9, 13), 11)])
def test_pool_matches_reference_bitwise(horizons, seed):
    tpool, jpool = _pools(horizons, seed)
    rng = np.random.default_rng(seed)
    np.testing.assert_array_equal(tpool.reset(), jpool.reset())
    for _ in range(40):  # crosses every horizon at least twice
        a = rng.uniform(-1.3, 1.3, (len(horizons), 2)).astype(np.float32)
        t, j = tpool.step(a), jpool.step(a)
        for name in t._fields:
            got, want = getattr(t, name), getattr(j, name)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert tpool.episode_returns == jpool.episode_returns
    assert tpool.episode_lengths == jpool.episode_lengths
    tpool.close(), jpool.close()


def test_rescale_matches_reference_bitwise(rng):
    low = np.array([-2.0, 0.0], np.float32)
    high = np.array([2.0, 10.0], np.float32)
    a = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    np.testing.assert_array_equal(rescale_action(a, low, high),
                                  j_rescale(a, low, high))
    scaled = rescale_action(a, low, high)
    np.testing.assert_array_equal(inverse_rescale_action(scaled, low, high),
                                  j_inverse(scaled, low, high))


def test_rescale_roundtrip(rng):
    low, high = np.array([-2.0, 0.0]), np.array([2.0, 10.0])
    a = rng.uniform(-1, 1, (16, 2))
    scaled = rescale_action(a, low, high)
    assert (scaled >= low - 1e-6).all() and (scaled <= high + 1e-6).all()
    np.testing.assert_allclose(inverse_rescale_action(scaled, low, high), a,
                               atol=1e-6)
    np.testing.assert_allclose(
        rescale_action(np.array([-1.0, 1.0]), low, high),
        np.array([low[0], high[1]]))


def test_rescale_wrapper_and_slow_env_step_as_reference(rng):
    wrapped = RescaleActionWrapper(PointMassEnv(horizon=10, seed=3))
    raw = JaxPoint(horizon=10, seed=3)
    slow, jslow = SlowEnv(PointMassEnv(seed=4), 0.0), JaxSlow(JaxPoint(seed=4),
                                                              0.0)
    np.testing.assert_array_equal(wrapped.reset(seed=3)[0],
                                  raw.reset(seed=3)[0])
    np.testing.assert_array_equal(slow.reset(seed=5)[0],
                                  jslow.reset(seed=5)[0])
    for _ in range(12):
        a = rng.uniform(-1, 1, 2).astype(np.float32)
        got = wrapped.step(a)
        want = raw.step(j_rescale(a, raw.action_space.low,
                                  raw.action_space.high))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
        s, js = slow.step(a), jslow.step(a)
        np.testing.assert_array_equal(s[0], js[0])
        assert s[1:4] == js[1:4]
    assert wrapped.horizon == 10  # attribute access reaches the env


def test_presets_match_reference():
    assert presets.PRESETS.keys() == jpresets.PRESETS.keys()
    for name, preset in presets.PRESETS.items():
        assert (dataclasses.asdict(preset)
                == dataclasses.asdict(jpresets.PRESETS[name])), name
    for env_id in ("Pendulum-v1", "SomeUnknownEnv-v9", "point"):
        for strict in (False, True):
            assert (dataclasses.asdict(presets.get_preset(env_id, strict))
                    == dataclasses.asdict(jpresets.get_preset(env_id,
                                                              strict)))
            assert (presets.has_preset(env_id, strict)
                    == jpresets.has_preset(env_id, strict))


def test_presets():
    p = presets.get_preset("Pendulum-v1")
    assert p.v_max == 0.0 and p.v_min < 0
    q = presets.get_preset("SomeUnknownEnv-v9")
    assert q.v_min < 0 < q.v_max


def test_env_pool_autoreset_and_stats():
    horizon = 25
    pool = EnvPool([lambda s=i: PointMassEnv(horizon=horizon, seed=s)
                    for i in range(4)], seed=0)
    obs = pool.reset()
    assert obs.shape == (4, 4)
    for _ in range(horizon):
        out = pool.step(np.zeros((4, 2), np.float32))
    assert len(pool.episode_returns) == 4
    assert pool.episode_lengths == [horizon] * 4
    assert out.truncated.all()
    assert not np.allclose(out.obs, out.final_obs)
    pool.close()


def test_env_pool_reset_on_done_is_per_env():
    pool = EnvPool([lambda: PointMassEnv(horizon=5, seed=0),
                    lambda: PointMassEnv(horizon=9, seed=1)], seed=3)
    pool.reset()
    for _ in range(5):
        out = pool.step(np.full((2, 2), 0.3, np.float32))
    assert out.truncated.tolist() == [True, False]
    assert not np.allclose(out.obs[0], out.final_obs[0])
    np.testing.assert_array_equal(out.obs[1], out.final_obs[1])
    assert pool.episode_lengths == [5]
    pool.close()


def test_env_pool_seed_determinism():
    def build():
        return EnvPool([lambda s=i: PointMassEnv(horizon=30, seed=s)
                        for i in range(3)], seed=7)

    a, b = build(), build()
    rng = np.random.default_rng(4)
    actions = rng.uniform(-1, 1, (12, 3, 2)).astype(np.float32)
    first = a.reset()
    np.testing.assert_array_equal(first, b.reset())
    for t in range(12):
        oa, ob = a.step(actions[t]), b.step(actions[t])
        np.testing.assert_array_equal(oa.obs, ob.obs)
        np.testing.assert_array_equal(oa.reward, ob.reward)
        np.testing.assert_array_equal(oa.final_obs, ob.final_obs)
    np.testing.assert_array_equal(a.reset(), first)
    a.close(), b.close()


def test_env_pool_single_env_matches_scalar():
    pool = EnvPool([lambda: PointMassEnv(horizon=8, seed=2)], seed=13)
    env = PointMassEnv(horizon=8, seed=2)
    obs_p = pool.reset()
    obs_s, _ = env.reset(seed=13)
    np.testing.assert_array_equal(obs_p[0], np.float32(obs_s))
    rng = np.random.default_rng(1)
    low = np.asarray(env.action_space.low, np.float32)
    high = np.asarray(env.action_space.high, np.float32)
    for _ in range(10):
        a = rng.uniform(-1, 1, (1, 2)).astype(np.float32)
        out = pool.step(a)
        obs_s, r, term, trunc, _ = env.step(rescale_action(a, low, high)[0])
        np.testing.assert_array_equal(out.final_obs[0], np.float32(obs_s))
        assert out.reward[0] == np.float32(r)
        assert bool(out.terminated[0]) == term
        assert bool(out.truncated[0]) == trunc
        if term or trunc:
            obs_s, _ = env.reset()
        np.testing.assert_array_equal(out.obs[0], np.float32(obs_s))
    pool.close()
