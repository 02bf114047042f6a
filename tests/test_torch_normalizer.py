"""Port vs reference: observation normalization (``envs/normalizer``) and
the replay service's fold.

``RunningMeanStd`` against the reference on the same float64 batches:
update, merge, stats, normalize (float64, then the float32 cast) and the
state dict, all bitwise. ``ReplayService(obs_norm=...)`` over a host
buffer and over ``FusedDeviceReplay`` on the CPU, fed the same raw
batches as the reference's service over its buffers: the stored rows and
the statistics bitwise. ``FrozenNormalizer``, and the reference's
``tests/test_normalizer.py`` cases re-asserted on the port (its
multi-host ``SyncedRunningMeanStd`` case is in
``tests/test_torch_multihost.py``).
"""

import numpy as np
import pytest

from d4pg_tpu.distributed import ReplayService as JaxService
from d4pg_tpu.envs import normalizer as jnorm
from d4pg_tpu.replay import ReplayBuffer as JaxBuffer
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxFused
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.distributed.actor import GoalActorWorker
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.envs.fake import FakeGoalEnv
from d4pg_tpu_torch.envs.normalizer import FrozenNormalizer, RunningMeanStd
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch
from d4pg_tpu_torch.serving.client import ActorConfig

pytestmark = pytest.mark.torchport


def _chunks(seed=0, dim=5, sizes=(1, 7, 64, 128)):
    rng = np.random.default_rng(seed)
    return [rng.normal(3.0, 2.0, (n, dim)) * (1 + np.arange(dim))
            for n in sizes]


def _equal_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("clip,eps", [(5.0, 1e-2), (2.5, 1e-8)])
def test_running_mean_std_bitwise(clip, eps):
    ours, ref = RunningMeanStd(5, clip, eps), jnorm.RunningMeanStd(5, clip,
                                                                   eps)
    x = np.random.default_rng(9).normal(4.0, 30.0, (40, 5))
    for chunk in _chunks():
        ours.update(chunk)
        ref.update(chunk)
        for a, b in zip(ours.stats(), ref.stats()):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
        z, jz = ours.normalize(x), ref.normalize(x)
        assert z.dtype == jz.dtype == np.float32
        np.testing.assert_array_equal(z, jz)
    _equal_state(ours.state_dict(), ref.state_dict())
    # a Chan merge of another estimator's moments
    other = _chunks(seed=3)[2]
    ours.merge(64, other.mean(0), ((other - other.mean(0)) ** 2).sum(0))
    ref.merge(64, other.mean(0), ((other - other.mean(0)) ** 2).sum(0))
    _equal_state(ours.state_dict(), ref.state_dict())
    # a state dict crosses over both ways
    a, b = RunningMeanStd(5), jnorm.RunningMeanStd(5)
    a.load_state_dict(ref.state_dict())
    b.load_state_dict(ours.state_dict())
    np.testing.assert_array_equal(a.normalize(x), b.normalize(x))


def test_empty_stats_and_frozen_normalizer_bitwise():
    ours, ref = RunningMeanStd(3), jnorm.RunningMeanStd(3)
    x = np.array([[1.0, -2.0, 100.0]])
    np.testing.assert_array_equal(ours.normalize(x), ref.normalize(x))
    ours.update(np.zeros((0, 3)))  # an empty batch folds nothing
    assert ours.state_dict()["count"] == 0.0
    mean, std = np.array([0.5, -1.0, 2.0]), np.array([0.0, 3.0, 1e-9])
    f, jf = FrozenNormalizer(mean, std, 4.0), jnorm.FrozenNormalizer(
        mean, std, 4.0)
    np.testing.assert_array_equal(f.normalize(x), jf.normalize(x))
    f.set(mean + 1, std + 1, clip=1.5)
    jf.set(mean + 1, std + 1, clip=1.5)
    np.testing.assert_array_equal(f.normalize(x), jf.normalize(x))
    assert f.clip == 1.5


def _raw_batches(seed=0, n_batches=12, obs_dim=4, act_dim=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = int(rng.integers(1, 40))
        done = (rng.random(n) < 0.1).astype(np.float32)
        out.append(dict(
            obs=(rng.normal(size=(n, obs_dim)) * [1, 10, 100, 0.1]
                 + i).astype(np.float32),
            action=rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
            reward=rng.normal(size=n).astype(np.float32),
            next_obs=(rng.normal(size=(n, obs_dim)) * 5).astype(np.float32),
            done=done,
            discount=(0.99 * (1 - done)).astype(np.float32)))
    return out


def _feed(service, batches, Batch):
    for i, b in enumerate(batches):
        assert service.add(Batch(**b), actor_id=f"a{i % 3}",
                           count_env_steps=i % 4 != 3)
        if i % 5 == 4:
            service.flush()
    service.flush()


@pytest.mark.parametrize("kind", ["host", "fused"])
def test_service_normalizes_rows_like_the_reference(kind):
    """The same raw batches through both services: the rows each buffer
    holds, the env-step count and the statistics, bitwise. The fused
    buffer's rows are read from its ring after the service drains it."""
    batches = _raw_batches()
    total = sum(b["obs"].shape[0] for b in batches)
    norm, jn = RunningMeanStd(4), jnorm.RunningMeanStd(4)
    if kind == "host":
        buf = ReplayBuffer(1000, 4, 2, device="cpu")
        jbuf = JaxBuffer(1000, 4, 2)
    else:
        buf = FusedDeviceReplay(512, 4, 2, device="cpu", block_rows=64)
        jbuf = JaxFused(512, 4, 2, block_rows=64)
    svc = ReplayService(buf, obs_norm=norm)
    jsvc = JaxService(jbuf, obs_norm=jn)
    try:
        _feed(svc, batches, TransitionBatch)
        _feed(jsvc, batches, JaxBatch)
        if kind == "host":
            rows = buf.gather(np.arange(total))
            jrows = jbuf.gather(np.arange(total))
        else:
            assert svc.drain_device() == jsvc.drain_device() == total
            rows = [t[:total].numpy() for t in buf.storage]
            jrows = [np.asarray(a)[:total] for a in jbuf.storage]
        for f, a, b in zip(TransitionBatch._fields, rows, jrows):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype == np.float32, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert svc.env_steps == jsvc.env_steps
        _equal_state(norm.state_dict(), jn.state_dict())
        # next_obs is normalized but never folded: the count is obs rows
        assert norm.state_dict()["count"] == total
    finally:
        svc.close()
        jsvc.close()
    # the rows are normalize() of the raw rows, batch by batch in order
    replay = RunningMeanStd(4)
    want = []
    for b in batches:
        replay.update(b["obs"])
        want.append(replay.normalize(b["obs"]))
    np.testing.assert_array_equal(np.asarray(rows[0]), np.concatenate(want))


def test_stats_snapshot_is_consistent_under_concurrent_folds():
    """``stats`` copies under the lock: a reader racing the commit
    thread's folds always sees a (mean, std) pair of one fold."""
    import threading

    norm = RunningMeanStd(2, eps=0.0)
    stop = threading.Event()

    norm.update(np.zeros((4, 2)))  # fold 0, before any read

    def fold():
        for i in range(1, 2000):
            norm.update(np.full((4, 2), float(i)))
        stop.set()

    t = threading.Thread(target=fold)
    t.start()
    try:
        while not stop.is_set():
            mean, std = norm.stats()
            # after folds 0..k (4 rows each) the mean is k / 2 and the
            # variance ((k + 1)^2 - 1) / 12: a torn pair breaks the relation
            k = 2.0 * mean
            np.testing.assert_allclose(std ** 2, ((k + 1) ** 2 - 1) / 12,
                                       rtol=1e-9, atol=1e-12)
    finally:
        t.join(timeout=30)


# -- the reference's tests/test_normalizer.py, on the port -------------------

def test_running_mean_std_matches_numpy_oracle(rng):
    norm = RunningMeanStd(5, eps=1e-8)
    chunks = [rng.normal(3.0, 2.0, (n, 5)) * (1 + np.arange(5))
              for n in (1, 7, 64, 128)]
    for c in chunks:
        norm.update(c)
    all_rows = np.concatenate(chunks)
    mean, std = norm.stats()
    np.testing.assert_allclose(mean, all_rows.mean(0), rtol=1e-10)
    np.testing.assert_allclose(std, all_rows.std(0), rtol=1e-6)
    z = norm.normalize(all_rows)
    np.testing.assert_allclose(z.mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(z.std(0), 1.0, atol=1e-3)


def test_normalize_clips_and_floors_std():
    norm = RunningMeanStd(2, clip=5.0, eps=1e-2)
    norm.update(np.ones((100, 2)))  # zero-variance dims
    z = norm.normalize(np.array([[1.0, 1e9]]))
    assert z[0, 0] == 0.0
    assert z[0, 1] == 5.0  # clipped, not inf (std floored at eps)


def test_state_dict_roundtrip(rng):
    a = RunningMeanStd(3)
    a.update(rng.normal(0, 1, (50, 3)))
    b = RunningMeanStd(3)
    b.load_state_dict(a.state_dict())
    x = rng.normal(0, 1, (10, 3))
    np.testing.assert_array_equal(a.normalize(x), b.normalize(x))
    more = rng.normal(2, 3, (30, 3))
    a.update(more)
    b.update(more)
    np.testing.assert_allclose(a.stats()[1], b.stats()[1], rtol=1e-12)


def test_service_drain_normalizes_rows():
    config = D4PGConfig(obs_dim=4, act_dim=2, v_min=-50, v_max=0, n_atoms=11,
                        hidden=(16, 16))
    buf = ReplayBuffer(10_000, 4, 2, device="cpu")
    norm = RunningMeanStd(4)
    svc = ReplayService(buf, obs_norm=norm)
    try:
        actor = GoalActorWorker("g0", config, ActorConfig(gamma=0.98),
                                FakeGoalEnv(horizon=30, seed=0), svc,
                                WeightStore(), her_ratio=1.0, rng_seed=2,
                                obs_norm=norm, learner_device="cpu")
        for _ in range(4):
            actor.run_episode(max_steps=30)
        svc.flush()
        n = len(svc)
        assert n > 0
        rows = buf.gather(np.arange(n))
        assert np.abs(rows.obs).max() <= norm.clip + 1e-6
        assert np.abs(rows.obs.mean()) < 1.5
        assert norm.state_dict()["count"] > 0
    finally:
        svc.close()


def test_norm_stats_ride_the_weight_channel():
    """The port's weight server ships the store's (mean, std, clip); its
    client exposes them, and a policy client pulling through it builds a
    FrozenNormalizer that normalizes as the live estimator does."""
    from d4pg_tpu_torch.distributed.weight_server import (
        WeightClient,
        WeightServer,
    )
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.serving.client import LocalPolicyClient

    config = D4PGConfig(obs_dim=4, act_dim=2, v_min=-5, v_max=0, n_atoms=11,
                        hidden=(16, 16))
    store = WeightStore()
    norm = RunningMeanStd(4, clip=3.0)
    norm.update(np.arange(40, dtype=np.float64).reshape(10, 4))
    store.publish(init_state(config, 0, "cpu").actor, step=7,
                  norm_stats=(*norm.stats(), norm.clip))
    server = WeightServer(store)
    client = WeightClient("127.0.0.1", server.port, connect_timeout=5.0)
    try:
        policy = LocalPolicyClient(config, ActorConfig(), client)
        assert policy.pull()
        assert client.step == 7
        mean, std = norm.stats()
        np.testing.assert_array_equal(client.norm_stats[0], mean)
        np.testing.assert_array_equal(client.norm_stats[1], std)
        assert client.norm_stats[2] == 3.0
        assert isinstance(policy.obs_norm, FrozenNormalizer)
        x = np.random.default_rng(0).normal(0, 10, (6, 4))
        np.testing.assert_array_equal(policy.obs_norm.normalize(x),
                                      norm.normalize(x))
    finally:
        client.close()
        server.close()


def test_live_normalizer_stays_in_charge_of_an_in_process_client():
    """An in-process client given the service's RunningMeanStd keeps it
    across pulls; the store's published snapshot does not replace it."""
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.serving.client import LocalPolicyClient

    config = D4PGConfig(obs_dim=4, act_dim=2, hidden=(8,), n_atoms=5)
    norm = RunningMeanStd(4)
    store = WeightStore()
    store.publish(init_state(config, 0, "cpu").actor, step=0,
                  norm_stats=(*norm.stats(), norm.clip))
    policy = LocalPolicyClient(config, ActorConfig(), store, obs_norm=norm)
    assert policy.pull()
    assert policy.obs_norm is norm
    assert store.snapshot_ex()["norm_stats"][2] == 5.0


def test_rms_merge_matches_update():
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((40, 3)), rng.standard_normal((24, 3)) + 2
    one = RunningMeanStd(3)
    one.update(np.concatenate([x, y]))
    left, right = RunningMeanStd(3), RunningMeanStd(3)
    left.update(x)
    right.update(y)
    left.merge(right._count, right._mean, right._m2)
    np.testing.assert_allclose(left.stats()[0], one.stats()[0], rtol=1e-12)
    np.testing.assert_allclose(left.stats()[1], one.stats()[1], rtol=1e-12)
