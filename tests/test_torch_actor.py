"""Port vs reference: the acting plane.

``ActorWorker`` (a ``LocalPolicyClient`` driving a ``VectorActorLane``),
``Evaluator``/``AsyncEvaluator`` and ``WeightStore``, at hidden (16, 16),
11 atoms, on the ``point`` env. The actor weights are carried across from
the JAX state (``io/from_jax``) and exploration is off
(``epsilon_0 = min_epsilon = 0``), so both sides act greedily and every
difference is float rounding: the rows the workers send over 50 ticks
match within atol 1e-5, eval returns within atol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.distributed.actor import ActorConfig as JaxActorConfig
from d4pg_tpu.distributed.actor import ActorWorker as JaxWorker
from d4pg_tpu.distributed.evaluator import Evaluator as JaxEvaluator
from d4pg_tpu.distributed.weights import WeightStore as JaxStore
from d4pg_tpu.envs import EnvPool as JaxPool
from d4pg_tpu.envs import PointMassEnv as JaxPoint
from d4pg_tpu.learner import state as jstate
from d4pg_tpu_torch.distributed.actor import ActorWorker
from d4pg_tpu_torch.distributed.evaluator import AsyncEvaluator, Evaluator
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.envs.fake import PointMassEnv
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.io.from_jax import state_from_jax
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.serving.client import (
    ActorConfig,
    LocalPolicyClient,
    resolve_act_device,
)

pytestmark = pytest.mark.torchport

DIMS = dict(obs_dim=4, act_dim=2, v_min=-10.0, v_max=0.0, n_atoms=11,
            hidden=(16, 16))
GREEDY = dict(epsilon_0=0.0, min_epsilon=0.0, n_step=3, gamma=0.99)


class _Sink:
    """A transition sink that keeps every batch (no ingest threads)."""

    def __init__(self):
        self.batches = []

    def add(self, batch, actor_id="local", **_):
        self.batches.append(batch)
        return True

    def rows(self):
        return [np.concatenate([np.asarray(getattr(b, f))
                                for b in self.batches])
                for f in self.batches[0]._fields]


def _weights(seed=0):
    """Both stores holding the same actor weights (JAX init, carried)."""
    jcfg = jstate.D4PGConfig(**DIMS)
    js = jstate.init_state(jcfg, jax.random.key(seed))
    tcfg = tstate.D4PGConfig(**DIMS)
    ts = state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    jw, tw = JaxStore(), WeightStore()
    jw.publish(js.actor_params, step=0)
    tw.publish(ts.actor, step=0)
    return (jcfg, jw), (tcfg, tw), ts


@pytest.mark.parametrize("num_envs,horizon", [(1, 9), (3, 20)])
def test_worker_rows_match_reference(num_envs, horizon):
    (jcfg, jw), (tcfg, tw), _ = _weights()
    jsink, tsink = _Sink(), _Sink()
    jworker = JaxWorker(
        "a", jcfg, JaxActorConfig(**GREEDY),
        JaxPool([lambda s=i: JaxPoint(horizon=horizon, seed=s)
                 for i in range(num_envs)], seed=5), jsink, jw, seed=0)
    tworker = ActorWorker(
        "a", tcfg, ActorConfig(**GREEDY),
        EnvPool([lambda s=i: PointMassEnv(horizon=horizon, seed=s)
                 for i in range(num_envs)], seed=5), tsink, tw, seed=0)
    assert jworker.run(30) == tworker.run(30) == 30 * num_envs
    assert jworker.run(20) == tworker.run(20)  # resumes mid-episode
    assert len(tsink.batches) == len(jsink.batches) == 50
    for name, t, j in zip(("obs", "action", "reward", "next_obs", "done",
                           "discount"), tsink.rows(), jsink.rows()):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0, err_msg=name)
    assert tworker.dropped_batches == 0
    assert tworker.policy.version == 1


def test_evaluator_returns_match_reference():
    (jcfg, jw), (tcfg, tw), _ = _weights(seed=3)
    jev = JaxEvaluator(jcfg, lambda: JaxPoint(horizon=30, seed=1), jw,
                       max_steps=30)
    tev = Evaluator(tcfg, lambda: PointMassEnv(horizon=30, seed=1), tw,
                    max_steps=30)
    for seed in (None, 11):
        j, t = jev.evaluate(3, seed=seed), tev.evaluate(3, seed=seed)
        for name in ("avg_test_reward", "ewma_test_reward"):
            np.testing.assert_allclose(t[name], j[name], atol=1e-4,
                                       rtol=0, err_msg=name)
        assert t["success_rate"] == j["success_rate"] == 0.0
        assert t["learner_step"] == j["learner_step"] == 0


def test_async_evaluator_reports_the_latest_eval():
    _, (tcfg, tw), _ = _weights()
    ev = AsyncEvaluator(Evaluator(
        tcfg, lambda: PointMassEnv(horizon=10, seed=1), tw, max_steps=10))
    try:
        assert ev.latest() is None
        assert ev.request(2, seed=4)
        final = ev.wait(timeout=60)
        assert final is not None and np.isfinite(final["avg_test_reward"])
        inline = Evaluator(tcfg, lambda: PointMassEnv(horizon=10, seed=1),
                           tw, max_steps=10).evaluate(2, seed=4)
        assert final["avg_test_reward"] == inline["avg_test_reward"]
    finally:
        ev.close()


@pytest.mark.parametrize("to_host", [True, False])
def test_publish_does_not_alias_the_learner(to_host):
    """The learner's modules are updated in place: an Adam step after a
    publish must not change what readers got."""
    *_, ts = _weights()
    store = WeightStore()
    version = store.publish(ts.actor, step=7, to_host=to_host)
    _, params = store.get()
    before = {k: v.clone() for k, v in params.items()}
    with torch.no_grad():
        for p in ts.actor.parameters():
            p.add_(1.0)
    _, params = store.get()
    for name, t in params.items():
        assert torch.equal(t, before[name]), name
        assert t.device.type == "cpu"
    assert (version, store.step, store.version) == (1, 7, 1)
    assert store.get_if_newer(1) is None and store.get_if_newer(0)[0] == 1
    assert store.snapshot()[2] == 7


def test_client_draws_and_devices():
    _, (tcfg, tw), _ = _weights()
    empty = WeightStore()
    obs = np.zeros((5, 4), np.float32)
    a = LocalPolicyClient(tcfg, ActorConfig(), empty, seed=2)
    b = LocalPolicyClient(tcfg, ActorConfig(), empty, seed=2)
    warm = a.actions(obs)  # uniform warm-up before any publish
    assert warm.shape == (5, 2) and (np.abs(warm) < 1).all()
    np.testing.assert_array_equal(warm, b.actions(obs))
    assert not a.pull() and a.version == 0
    with pytest.raises(RuntimeError, match="no weights"):
        a.greedy_actions(obs)
    with pytest.raises(RuntimeError, match="no weights"):
        a.snapshot_pull()
    ou = LocalPolicyClient(tcfg, ActorConfig(noise="ou", random_eps=0.5,
                                             epsilon_0=1.0), tw, seed=2)
    assert ou.pull() and not ou.pull()
    first = ou.actions(obs)
    assert first.shape == (5, 2) and (np.abs(first) <= 1).all()
    ou.reset_noise(np.array([True, False, True, False, False]))
    assert (ou._ou.x[[0, 2]] == 0).all()
    ou.decay_epsilon()
    assert ou.epsilon < 1.0
    assert resolve_act_device("cpu").type == "cpu"
    assert resolve_act_device("default", "cpu").type == "cpu"
    with pytest.raises(ValueError, match="actor device"):
        resolve_act_device("tpu")
    with pytest.raises(ValueError, match="actor device"):
        ActorConfig(device="gpu")


def test_client_default_device_follows_the_learner(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (tcfg, tw), _ = _weights()
    with pytest.raises(RuntimeError, match="cuda"):
        LocalPolicyClient(tcfg, ActorConfig(device="default"), tw)
    client = LocalPolicyClient(tcfg, ActorConfig(device="default"), tw,
                               learner_device="cpu")
    assert client.device.type == "cpu"
