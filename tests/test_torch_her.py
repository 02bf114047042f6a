"""Port vs reference: the HER recipe (``envs/her``, ``envs/wrappers.
flatten_goal_obs``, ``envs/fake.FakeGoalEnv``, ``distributed/actor.
GoalActorWorker``, the evaluator's goal-conditioned path).

Every draw is shared: ``her_relabel`` takes the same numpy generator
seed on both sides, and the goal actors and evaluators act through one
stub policy (actions drawn from a seeded numpy generator, the policy
inputs recorded), so episodes, relabels and eval results are compared
bitwise. The reference's own goal-actor tests (rescaled actions, a
wrapper that does not forward ``compute_reward``, relabels that add no
env steps) are re-asserted on the port.
"""

import numpy as np
import pytest

from d4pg_tpu.distributed import ReplayService as JaxService
from d4pg_tpu.distributed.actor import ActorConfig as JaxActorConfig
from d4pg_tpu.distributed.actor import GoalActorWorker as JaxGoalActor
from d4pg_tpu.distributed.evaluator import Evaluator as JaxEvaluator
from d4pg_tpu.distributed.weights import WeightStore as JaxStore
from d4pg_tpu.envs import fake as jfake
from d4pg_tpu.envs import her as jher
from d4pg_tpu.envs import wrappers as jwrappers
from d4pg_tpu.envs.normalizer import RunningMeanStd as JaxRMS
from d4pg_tpu.learner import D4PGConfig as JaxConfig
from d4pg_tpu.replay import ReplayBuffer as JaxBuffer
from d4pg_tpu_torch.distributed.actor import GoalActorWorker
from d4pg_tpu_torch.distributed.evaluator import Evaluator
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.envs import fake, her, wrappers
from d4pg_tpu_torch.envs.normalizer import RunningMeanStd
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.replay.uniform import ReplayBuffer
from d4pg_tpu_torch.serving.client import ActorConfig

pytestmark = pytest.mark.torchport

DIMS = dict(obs_dim=4, act_dim=2, v_min=-50.0, v_max=0.0, n_atoms=11,
            hidden=(16, 16))


def _episode(seed=0, T=30):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, 3)).astype(np.float32)
    ag = rng.uniform(-1, 1, (T + 1, 2)).astype(np.float32)
    act = rng.uniform(-1, 1, (T, 2)).astype(np.float32)
    nobs = rng.normal(size=(T, 3)).astype(np.float32)
    return obs, ag, act, nobs


def _assert_batches_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("her_ratio", [0.0, 0.8, 1.0])
def test_her_relabel_bitwise(her_ratio):
    obs, ag, act, nobs = _episode()
    reward = jfake.FakeGoalEnv(tol=0.5).compute_reward
    want = jher.her_relabel(obs, ag, act, nobs, reward,
                            np.random.default_rng(7), her_ratio, 0.98)
    got = her.her_relabel(obs, ag, act, nobs,
                          fake.FakeGoalEnv(tol=0.5).compute_reward,
                          np.random.default_rng(7), her_ratio, 0.98)
    _assert_batches_equal(got, want)
    if her_ratio == 0.0:
        assert got.obs.shape == (0, 5)
    if her_ratio == 1.0:
        assert got.obs.shape == (30, 5)
        # the t-indexed action, the reference's documented fix
        np.testing.assert_array_equal(got.action, act)
    assert got.done.any() or her_ratio == 0.0


def test_fake_goal_env_and_flatten_bitwise():
    ours, ref = fake.FakeGoalEnv(horizon=25, seed=3), jfake.FakeGoalEnv(
        horizon=25, seed=3)
    actions = np.random.default_rng(1).uniform(-1.5, 1.5, (25, 2))
    for reset_seed in (None, 11):
        o, _ = ours.reset(seed=reset_seed)
        r, _ = ref.reset(seed=reset_seed)
        for a in actions:
            for k in r:
                np.testing.assert_array_equal(o[k], r[k])
            np.testing.assert_array_equal(wrappers.flatten_goal_obs(o),
                                          jwrappers.flatten_goal_obs(r))
            o, rew, term, trunc, info = ours.step(a)
            r, jrew, jterm, jtrunc, jinfo = ref.step(a)
            assert (rew, term, trunc, info) == (jrew, jterm, jtrunc, jinfo)
    goal = wrappers.GoalObs(np.ones(3), np.zeros(2), np.full(2, 2.0))
    jgoal = jwrappers.GoalObs(np.ones(3), np.zeros(2), np.full(2, 2.0))
    np.testing.assert_array_equal(wrappers.flatten_goal_obs(goal),
                                  jwrappers.flatten_goal_obs(jgoal))
    plain = np.arange(4.0)
    np.testing.assert_array_equal(wrappers.flatten_goal_obs(plain), plain)


class _StubPolicy:
    """The policy-client surface a goal actor and an evaluator use: actions
    from a seeded numpy generator, the inputs it was given recorded."""

    def __init__(self, seed=0, obs_norm=None):
        self._rng = np.random.default_rng(seed)
        self.obs_norm = obs_norm
        self.inputs = []
        self.noise_resets = 0
        self.decays = 0

    def pull(self):
        return False

    def snapshot_pull(self):
        return 1, 5

    def actions(self, obs):
        self.inputs.append(np.array(obs))
        return self._rng.uniform(-1, 1, (obs.shape[0], 2)).astype(
            np.float32)

    def greedy_actions(self, obs):
        self.inputs.append(np.array(obs))
        # a fixed policy: head for the desired goal (the last two inputs)
        # from the observation (the first two)
        return np.clip(2.0 * (obs[:, -2:] - obs[:, :2]), -1, 1).astype(
            np.float32)

    def reset_noise(self, done_mask):
        self.noise_resets += 1

    def decay_epsilon(self):
        self.decays += 1


class _Sink:
    def __init__(self):
        self.adds = []

    def add(self, batch, actor_id="local", count_env_steps=True, **_):
        self.adds.append((batch, count_env_steps))
        return True


@pytest.mark.parametrize("normalize", [False, True])
def test_goal_actor_episodes_bitwise(normalize):
    """Four episodes of a goal actor with injected actions: the originals
    and relabels each side streams, the count flags, the policy inputs
    (normalized by a live RunningMeanStd when on) and env_steps agree
    bitwise."""
    acfg = dict(gamma=0.98, reward_scale=0.5)
    sides = []
    for Actor, Config, Env, Cfg, Store, RMS in (
            (GoalActorWorker, D4PGConfig, fake.FakeGoalEnv, ActorConfig,
             WeightStore, RunningMeanStd),
            (JaxGoalActor, JaxConfig, jfake.FakeGoalEnv, JaxActorConfig,
             JaxStore, JaxRMS)):
        norm = RMS(4) if normalize else None
        sink = _Sink()
        actor = Actor("g0", Config(**DIMS), Cfg(**acfg),
                      Env(horizon=20, seed=5), sink, Store(),
                      her_ratio=0.8, rng_seed=9, seed=9, obs_norm=norm)
        policy = _StubPolicy(seed=4, obs_norm=norm)
        actor.policy = policy
        lengths = []
        for _ in range(4):
            lengths.append(actor.run_episode(max_steps=20))
            if norm is not None:
                # the service folds the streamed rows: fold the originals
                for b, count in sink.adds[-2:]:
                    norm.update(b.obs)
        sides.append((sink, policy, lengths, actor))
    (sink, policy, lengths, actor), (jsink, jpolicy, jlengths, jactor) = sides
    assert lengths == jlengths
    assert actor.env_steps == jactor.env_steps == sum(lengths)
    assert len(sink.adds) == len(jsink.adds) == 8
    for (b, count), (jb, jcount) in zip(sink.adds, jsink.adds):
        _assert_batches_equal(b, jb)
        assert count == jcount
    # originals counted, relabels not
    assert [c for _, c in sink.adds] == [True, False] * 4
    counted = sum(b.obs.shape[0] for b, c in sink.adds if c)
    assert counted == actor.env_steps
    assert len(policy.inputs) == len(jpolicy.inputs)
    for x, y in zip(policy.inputs, jpolicy.inputs):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (policy.noise_resets, policy.decays) == (4, 4)


def test_goal_actor_through_the_service_counts_only_originals():
    config = D4PGConfig(**DIMS)
    svc = ReplayService(ReplayBuffer(10_000, 4, 2, device="cpu"))
    try:
        actor = GoalActorWorker("g0", config, ActorConfig(gamma=0.98),
                                fake.FakeGoalEnv(horizon=30, seed=0), svc,
                                WeightStore(), her_ratio=1.0, rng_seed=2,
                                learner_device="cpu")
        T = actor.run_episode(max_steps=30)
        svc.flush()
        assert T > 0
        assert len(svc) == 2 * T  # originals and her_ratio=1 relabels
        assert svc.env_steps == T  # only the originals count
    finally:
        svc.close()


class _ScaledSpyGoalEnv(fake.FakeGoalEnv):
    """FakeGoalEnv with a [-scale, scale] action box that records what it
    is stepped with."""

    def __init__(self, scale: float, **kw):
        super().__init__(**kw)
        self.scale = scale
        self.action_space = fake._Box(-scale, scale, (2,))
        self.stepped_actions: list[np.ndarray] = []

    def step(self, action):
        self.stepped_actions.append(np.asarray(action, np.float32).copy())
        return super().step(np.asarray(action, np.float32) / self.scale)


def test_goal_actor_rescales_actions():
    """The reference's ``test_goal_actor_rescales_actions`` on the port:
    the env sees the affine-rescaled action, the buffer keeps the
    tanh-range one."""
    config = D4PGConfig(**DIMS)
    svc = ReplayService(ReplayBuffer(10_000, 4, 2, device="cpu"))
    try:
        env = _ScaledSpyGoalEnv(scale=5.0, horizon=20, seed=3)
        actor = GoalActorWorker("g0", config, ActorConfig(), env, svc,
                                WeightStore(), her_ratio=0.0, rng_seed=4,
                                seed=4, learner_device="cpu")
        T = actor.run_episode(max_steps=20)
        svc.flush()
        stepped = np.stack(env.stepped_actions)
        stored = svc.buffer.gather(np.arange(T)).action
        low, high = np.full(2, -5.0, np.float32), np.full(2, 5.0, np.float32)
        np.testing.assert_allclose(
            stepped, wrappers.rescale_action(stored, low, high),
            rtol=1e-6, atol=1e-6)
        assert np.abs(stepped).max() > 1.0
        assert np.abs(stored).max() <= 1.0
    finally:
        svc.close()


def test_goal_actor_on_a_wrapper_that_does_not_forward():
    """gymnasium 1.x wrappers do not forward ``compute_reward``: the goal
    actor takes it from ``env.unwrapped``."""

    class NonForwardingWrapper:
        def __init__(self, env):
            self.unwrapped = env
            self.action_space = env.action_space
            self.observation_space = env.observation_space

        def reset(self, **kw):
            return self.unwrapped.reset(**kw)

        def step(self, a):
            return self.unwrapped.step(a)

    svc = ReplayService(ReplayBuffer(10_000, 4, 2, device="cpu"))
    try:
        actor = GoalActorWorker(
            "g0", D4PGConfig(**DIMS), ActorConfig(gamma=0.98),
            NonForwardingWrapper(fake.FakeGoalEnv(horizon=30, seed=0)), svc,
            WeightStore(), her_ratio=1.0, rng_seed=2, learner_device="cpu")
        T = actor.run_episode(max_steps=30)
        svc.flush()
        assert T > 0 and len(svc) == 2 * T
    finally:
        svc.close()


@pytest.mark.parametrize("normalize", [False, True])
def test_evaluator_success_rate_and_returns_equal(normalize):
    """The goal-conditioned eval on a fixed policy: returns, EWMA, success
    rate and the policy inputs (flattened, normalized when on) equal."""
    stats = np.random.default_rng(0).normal(0, 2, (50, 4))
    results = []
    for Ev, Config, Env, Store, RMS in (
            (Evaluator, D4PGConfig, fake.FakeGoalEnv, WeightStore,
             RunningMeanStd),
            (JaxEvaluator, JaxConfig, jfake.FakeGoalEnv, JaxStore, JaxRMS)):
        norm = None
        if normalize:
            norm = RMS(4)
            norm.update(stats)
        kw = dict(learner_device="cpu") if Ev is Evaluator else {}
        ev = Ev(Config(**DIMS), lambda: Env(horizon=25, seed=2), Store(),
                max_steps=25, goal_conditioned=True, obs_norm=norm, **kw)
        ev.policy = _StubPolicy()
        out = [ev.evaluate(n_trials=4, seed=s) for s in (0, 10)]
        results.append((out, ev.policy.inputs))
    (out, inputs), (jout, jinputs) = results
    assert out == jout
    assert 0.0 < out[0]["success_rate"] <= 1.0
    assert len(inputs) == len(jinputs)
    for x, y in zip(inputs, jinputs):
        np.testing.assert_array_equal(x, y)


def test_service_with_goal_actor_and_normalizer_matches_reference():
    """Goal-actor episodes through each package's ``ReplayService`` with
    a normalizer, host buffers: the stored rows and the statistics agree
    bitwise (the fold is the commit thread's, in ticket order)."""
    rows, stats = [], []
    for Actor, Config, Env, Cfg, Store, RMS, Svc, Buf in (
            (GoalActorWorker, D4PGConfig, fake.FakeGoalEnv, ActorConfig,
             WeightStore, RunningMeanStd, ReplayService,
             lambda: ReplayBuffer(10_000, 4, 2, device="cpu")),
            (JaxGoalActor, JaxConfig, jfake.FakeGoalEnv, JaxActorConfig,
             JaxStore, JaxRMS, JaxService, lambda: JaxBuffer(10_000, 4, 2))):
        norm = RMS(4)
        svc = Svc(Buf(), obs_norm=norm)
        try:
            actor = Actor("g0", Config(**DIMS), Cfg(gamma=0.98),
                          Env(horizon=30, seed=0), svc, Store(),
                          her_ratio=0.8, rng_seed=2, obs_norm=norm)
            actor.policy = _StubPolicy(seed=1, obs_norm=norm)
            for _ in range(4):
                actor.run_episode(max_steps=30)
                svc.flush()
            n = len(svc)
            rows.append(svc.buffer.gather(np.arange(n)))
            stats.append(norm.state_dict())
        finally:
            svc.close()
    _assert_batches_equal(rows[0], rows[1])
    assert np.abs(rows[0].obs).max() <= 5.0
    assert stats[0]["count"] == stats[1]["count"] > 0
    np.testing.assert_array_equal(stats[0]["mean"], stats[1]["mean"])
    np.testing.assert_array_equal(stats[0]["m2"], stats[1]["m2"])
