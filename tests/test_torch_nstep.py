"""Port vs reference: n-step folding and the annealing schedule.

``NStepFolder`` and ``LinearSchedule`` are numpy/float code in both
packages: random multi-env sequences with terminals, truncations and
resets must fold to bitwise-equal batches, and the schedules must give
equal values. Then the folder and schedule properties of
``tests/test_replay.py``, re-asserted on the port.
"""

import numpy as np
import pytest

from d4pg_tpu.replay.nstep import NStepFolder as JaxFolder
from d4pg_tpu.replay.schedule import LinearSchedule as JaxSchedule
from d4pg_tpu_torch.replay.nstep import NStepFolder
from d4pg_tpu_torch.replay.schedule import LinearSchedule

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("n,gamma,num_envs,seed", [
    (1, 0.99, 1, 0), (3, 0.99, 4, 1), (5, 0.9, 3, 2), (2, 0.5, 6, 3)])
def test_folder_matches_reference_bitwise(n, gamma, num_envs, seed):
    rng = np.random.default_rng(seed)
    obs_dim, act_dim = 4, 2
    t = NStepFolder(n, gamma, num_envs, obs_dim, act_dim)
    j = JaxFolder(n, gamma, num_envs, obs_dim, act_dim)
    emitted = 0
    for tick in range(120):
        if tick == 60:  # a hard reset outside the folder's view
            t.reset(), j.reset()
        args = (
            rng.standard_normal((num_envs, obs_dim)).astype(np.float32),
            rng.uniform(-1, 1, (num_envs, act_dim)).astype(np.float32),
            rng.standard_normal(num_envs).astype(np.float32),
            rng.standard_normal((num_envs, obs_dim)).astype(np.float32),
            rng.random(num_envs) < 0.05,
            rng.random(num_envs) < 0.05,
        )
        got, want = t.step(*args), j.step(*args)
        for name in want._fields:
            g, w = np.asarray(getattr(got, name)), getattr(want, name)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=f"{name} tick {tick}")
        emitted += got.obs.shape[0]
    assert emitted > 0


@pytest.mark.parametrize("t", [0, 1, 7, 50_000, 99_999, 100_000, 10**7])
def test_linear_schedule_equals_reference(t):
    for args in ((100_000, 1.0, 0.4), (1000, 0.02, 1.0), (3, 0.0)):
        assert LinearSchedule(*args).value(t) == JaxSchedule(*args).value(t)


def test_linear_schedule_matches_reference_semantics():
    s = LinearSchedule(100_000, final_p=1.0, initial_p=0.4)
    assert s.value(0) == pytest.approx(0.4)
    assert s.value(50_000) == pytest.approx(0.7)
    assert s.value(100_000) == pytest.approx(1.0)
    assert s.value(1_000_000) == pytest.approx(1.0)


def _step(f, x, r, done=False, truncated=None):
    return f.step(obs=np.array([[float(x)]]), action=np.array([[0.0]]),
                  reward=np.array([r]), next_obs=np.array([[float(x + 1)]]),
                  done=np.array([done]),
                  truncated=None if truncated is None
                  else np.array([truncated]))


def test_nstep_one_step_passthrough():
    f = NStepFolder(n=1, gamma=0.9, num_envs=1, obs_dim=1, act_dim=1)
    out = f.step(obs=np.array([[1.0]]), action=np.array([[0.5]]),
                 reward=np.array([2.0]), next_obs=np.array([[1.5]]),
                 done=np.array([False]))
    assert out.reward[0] == pytest.approx(2.0)
    assert out.discount[0] == pytest.approx(0.9)
    assert out.done[0] == 0.0


def test_nstep_fold_and_terminal_flush():
    gamma = 0.5
    f = NStepFolder(n=3, gamma=gamma, num_envs=1, obs_dim=1, act_dim=1)
    assert _step(f, 0, 1.0).reward.size == 0
    assert _step(f, 1, 2.0).reward.size == 0
    out = _step(f, 2, 4.0)
    assert out.reward[0] == pytest.approx(1.0 + 0.5 * 2.0 + 0.25 * 4.0)
    assert out.obs[0, 0] == 0.0 and out.next_obs[0, 0] == 3.0
    assert out.discount[0] == pytest.approx(gamma**3)
    out = _step(f, 3, 8.0, done=True)
    assert out.reward.shape == (3,)
    np.testing.assert_allclose(out.reward,
                               [2.0 + 0.5 * 4 + 0.25 * 8, 4 + 0.5 * 8, 8.0])
    assert (out.done == 1.0).all() and (out.discount == 0.0).all()
    assert (out.next_obs == 4.0).all()
    assert _step(f, 0, 1.0).reward.size == 0


def test_nstep_truncation_bootstraps():
    gamma = 0.9
    f = NStepFolder(n=2, gamma=gamma, num_envs=1, obs_dim=1, act_dim=1)
    _step(f, 0, 1.0)
    out = _step(f, 1, 3.0, truncated=True)
    assert out.reward.shape == (2,)
    assert out.reward[0] == pytest.approx(1.0 + gamma * 3.0)
    assert out.discount[0] == pytest.approx(gamma**2)
    assert out.done[0] == 0.0
    assert out.reward[1] == pytest.approx(3.0)
    assert out.discount[1] == pytest.approx(gamma)


def test_nstep_multi_env_independent():
    f = NStepFolder(n=2, gamma=1.0, num_envs=2, obs_dim=1, act_dim=1)
    f.step(obs=np.zeros((2, 1)), action=np.zeros((2, 1)),
           reward=np.array([1.0, 10.0]), next_obs=np.ones((2, 1)),
           done=np.array([False, False]))
    out = f.step(obs=np.ones((2, 1)), action=np.zeros((2, 1)),
                 reward=np.array([2.0, 20.0]), next_obs=np.full((2, 1), 2.0),
                 done=np.array([False, True]))
    assert sorted(out.reward.tolist()) == pytest.approx([3.0, 20.0, 30.0])


def test_nstep_reset_drops_pending_windows():
    f = NStepFolder(n=3, gamma=0.9, num_envs=1, obs_dim=1, act_dim=1)
    for x in (1.0, 2.0):
        assert _step(f, x, x).obs.shape[0] == 0
    f.reset()
    for x in (10.0, 20.0):
        assert _step(f, x, x).obs.shape[0] == 0
    out = _step(f, 30.0, 30.0)
    assert out.obs.shape[0] == 1
    assert out.obs[0, 0] == pytest.approx(10.0)
    assert out.reward[0] == pytest.approx(10.0 + 0.9 * 20.0 + 0.81 * 30.0)
