"""Port vs reference: remote actors over localhost TCP (``actor_main``).

Both directions between the packages: the port's ``run_actor`` streams to
the reference's ``TransitionReceiver`` and pulls from its
``WeightServer``; the reference's ``run_actor`` streams to the port's
receiver and pulls from the port's ``WeightServer``. Exploration is off
(``epsilon_0 = min_epsilon = 0``) and the actor weights are one JAX state
carried across, so every action a frame carries is the greedy action of
the weights that crossed the wire: held against the other package's
policy on the frame's observations within 1e-6. A remote goal actor with
HER over the wire (the relabels' count flag keeps them out of env_steps),
and the weight server's round trip. The sharded planes both ways: an
actor of either package pulling v2 weight frames (``--weight_codec``,
each codec) from the other package's ``WeightPlaneServer`` and streaming
raw frames into its two-shard receiver and service, every action the
greedy action of the codec's image of the weights. Every run has its own bounds: actors
run a fixed number of ticks on a thread joined with a timeout, senders
give up after ``send_timeout`` seconds, every server closes in a
``finally``.
"""

import threading
import time

import jax
import numpy as np
import pytest

from d4pg_tpu import actor_main as jactor_main
from d4pg_tpu.config import ExperimentConfig as JaxExperimentConfig
from d4pg_tpu.distributed import ReplayService as JaxService
from d4pg_tpu.distributed import transport as jt
from d4pg_tpu.distributed import weight_plane as jwp
from d4pg_tpu.distributed import weight_server as jws
from d4pg_tpu.distributed.weights import WeightStore as JaxStore
from d4pg_tpu.learner import state as jstate
from d4pg_tpu.learner.update import act_deterministic
from d4pg_tpu.replay import ReplayBuffer as JaxBuffer
from d4pg_tpu_torch import actor_main
from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.distributed import transport as tt
from d4pg_tpu_torch.distributed import weight_plane as twp
from d4pg_tpu_torch.distributed import weight_server as tws
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.envs.normalizer import RunningMeanStd
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.learner.update import act_deterministic as t_greedy
from d4pg_tpu_torch.replay.uniform import ReplayBuffer

pytestmark = pytest.mark.torchport

NET = dict(hidden=(16, 16), n_atoms=11, v_min=-5.0, v_max=0.0)
GREEDY = dict(epsilon_0=0.0, min_epsilon=0.0, random_eps=0.0)
RUN = dict(env="point", num_envs=2, max_steps=20, n_steps=1, **NET, **GREEDY)


def _states(obs_dim=4, act_dim=2, seed=0):
    dims = dict(obs_dim=obs_dim, act_dim=act_dim, **NET)
    jcfg = jstate.D4PGConfig(**dims)
    js = jstate.init_state(jcfg, jax.random.key(seed))
    ts = state_from_jax(tstate.D4PGConfig(**dims), jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    return jcfg, js, ts


def _run_thread(fn, timeout=120.0):
    out = {}

    def body():
        try:
            out["steps"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "actor thread did not finish"
    if "error" in out:
        raise out["error"]
    return out["steps"]


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_torch_actor_feeds_a_jax_learner():
    jcfg, js, _ = _states()
    frames = []
    lock = threading.Lock()

    def on_batch(batch, aid, count):
        with lock:
            frames.append((batch, aid, count))

    receiver = jt.TransitionReceiver(on_batch, host="127.0.0.1")
    store = JaxStore()
    store.publish(js.actor_params, step=3)
    server = jws.WeightServer(store, host="127.0.0.1")
    try:
        steps = _run_thread(lambda: actor_main.run_actor(
            ExperimentConfig(**RUN), "127.0.0.1", receiver.port,
            server.port, actor_id="torch-0", max_ticks=30,
            send_timeout=10.0))
        assert steps == 60
        assert _wait(lambda: sum(b.obs.shape[0] for b, _, _ in frames)
                     >= 60)
    finally:
        receiver.close()
        server.close()
    assert {aid for _, aid, _ in frames} == {"torch-0"}
    assert all(count for _, _, count in frames)
    obs = np.concatenate([b.obs for b, _, _ in frames])
    action = np.concatenate([b.action for b, _, _ in frames])
    assert obs.shape == (60, 4) and obs.dtype == np.float32
    want = np.asarray(act_deterministic(jcfg, js.actor_params, obs))
    np.testing.assert_allclose(action, want, atol=1e-6, rtol=0)


def test_jax_actor_feeds_a_torch_learner():
    _, _, ts = _states(seed=2)
    svc = ReplayService(ReplayBuffer(1000, 4, 2, device="cpu"))
    receiver = tt.TransitionReceiver(
        lambda b, aid, count: svc.add(b, actor_id=aid, count_env_steps=count),
        generation=lambda: svc.generation)
    store = WeightStore()
    store.publish(ts.actor, step=5)
    server = tws.WeightServer(store)
    try:
        steps = _run_thread(lambda: jactor_main.run_actor(
            JaxExperimentConfig(**RUN), "127.0.0.1", receiver.port,
            server.port, actor_id="jax-0", max_ticks=30, send_timeout=10.0,
            expect_generation=True))
        assert steps == 60
        assert _wait(lambda: len(svc) >= 60)
        svc.flush()
        rows = svc.buffer.gather(np.arange(60))
        assert svc.env_steps == 60
        assert list(svc._heartbeats) == ["jax-0"]
        assert server.pulls_served >= 1
    finally:
        receiver.close()
        server.close()
        svc.close()
    import torch

    want = t_greedy(ts.actor, torch.as_tensor(rows.obs)).numpy()
    np.testing.assert_allclose(rows.action, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_remote_goal_actor_her_over_the_wire(normalize):
    """The port's ``test_remote_goal_actor_her_over_the_wire``: a remote
    goal actor streams originals and her_ratio=1 relabels; the learner
    stores both, counts only the originals. With the normalizer on, its
    statistics ride the weight frame and the service stores normalized
    rows."""
    cfg = ExperimentConfig(env="fake-goal", her=True, her_ratio=1.0,
                           max_steps=20, n_steps=1, v_min=-50.0, v_max=0.0,
                           hidden=(16, 16), n_atoms=11)
    _, _, ts = _states()
    norm = RunningMeanStd(4, clip=4.0) if normalize else None
    svc = ReplayService(ReplayBuffer(10_000, 4, 2, device="cpu"),
                        obs_norm=norm)
    receiver = tt.TransitionReceiver(
        lambda b, aid, count: svc.add(b, actor_id=aid, count_env_steps=count))
    store = WeightStore()
    if norm is not None:
        norm.update(np.random.default_rng(0).normal(size=(30, 4)))
    store.publish(ts.actor, step=0, norm_stats=(
        None if norm is None else (*norm.stats(), norm.clip)))
    server = tws.WeightServer(store)
    try:
        steps = _run_thread(lambda: actor_main.run_actor(
            cfg, "127.0.0.1", receiver.port, server.port,
            actor_id="remote-her", max_ticks=25, send_timeout=10.0))
        assert steps > 0
        assert _wait(lambda: len(svc) >= 2 * steps)
        svc.flush()
        assert len(svc) == 2 * steps
        assert svc.env_steps == steps
        if norm is not None:
            assert norm.state_dict()["count"] == 30 + 2 * steps
            rows = svc.buffer.gather(np.arange(2 * steps))
            assert np.abs(rows.obs).max() <= 4.0
    finally:
        receiver.close()
        server.close()
        svc.close()


def test_weight_server_client_round_trip():
    _, js, ts = _states()
    store = WeightStore()
    server = tws.WeightServer(store)
    client = tws.WeightClient("127.0.0.1", server.port, connect_timeout=5.0)
    try:
        assert client.get_if_newer(0) is None  # nothing published yet
        norm = (np.arange(4.0), np.full(4, 2.0), 5.0)
        store.publish(ts.actor, step=42, norm_stats=norm)
        version, params = client.get_if_newer(0)
        assert version == 1 and client.step == 42
        for name, t in ts.actor.state_dict().items():
            assert params[name].dtype == t.dtype
            np.testing.assert_array_equal(params[name].numpy(), t.numpy())
        np.testing.assert_array_equal(client.norm_stats[0], norm[0])
        assert client.norm_stats[2] == 5.0
        assert client.get_if_newer(version) is None  # up to date
        assert server.frame_encodes == 1 and server.pulls_served == 1
        # one frame serves every puller of a version
        other = tws.WeightClient("127.0.0.1", server.port,
                                 connect_timeout=5.0)
        assert other.get_if_newer(0)[0] == 1
        other.close()
        assert server.frame_encodes == 1 and server.pulls_served == 2
    finally:
        client.close()
        server.close()



@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_torch_v2_actor_feeds_a_sharded_jax_learner(codec):
    jcfg, js, _ = _states(seed=3)
    svc = JaxService(JaxBuffer(1000, 4, 2), num_ingest_shards=2)
    receiver = jt.TransitionReceiver(
        lambda *a: None, num_shards=2, on_payload=svc.add_payload,
        generation=lambda: svc.generation)
    store = JaxStore()
    store.publish(js.actor_params, step=3)
    server = jwp.WeightPlaneServer(store, host="127.0.0.1")
    try:
        steps = _run_thread(lambda: actor_main.run_actor(
            ExperimentConfig(**RUN), "127.0.0.1", receiver.port,
            server.port, actor_id="torch-v2", max_ticks=30,
            send_timeout=10.0, codec="raw", weight_codec=codec,
            expect_generation=True))
        assert steps == 60 and receiver.reuseport
        assert _wait(lambda: len(svc) >= 60)
        svc.flush()
        rows = svc.buffer.gather(np.arange(60))
        assert svc.env_steps == 60
        assert server.weight_stats()["frames_full"] >= 1
    finally:
        receiver.close()
        server.close()
        svc.close()
    image = jwp.decode_flat(jwp.encode_flat(
        jws._flatten(jax.tree_util.tree_map(np.asarray, js.actor_params)),
        codec))
    want = np.asarray(act_deterministic(jcfg, jws._unflatten(image),
                                        rows.obs))
    np.testing.assert_allclose(rows.action, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_jax_v2_actor_feeds_a_sharded_torch_learner(codec):
    import copy

    import torch

    _, _, ts = _states(seed=4)
    svc = ReplayService(ReplayBuffer(1000, 4, 2, device="cpu"),
                        num_ingest_shards=2)
    receiver = tt.TransitionReceiver(
        lambda *a: None, num_shards=2, on_payload=svc.add_payload,
        generation=lambda: svc.generation)
    store = WeightStore()
    store.publish(ts.actor, step=5)
    server = twp.WeightPlaneServer(store)
    try:
        steps = _run_thread(lambda: jactor_main.run_actor(
            JaxExperimentConfig(**RUN), "127.0.0.1", receiver.port,
            server.port, actor_id="jax-v2", max_ticks=30, send_timeout=10.0,
            codec="raw", weight_codec=codec, expect_generation=True))
        assert steps == 60 and receiver.reuseport
        assert _wait(lambda: len(svc) >= 60)
        svc.flush()
        rows = svc.buffer.gather(np.arange(60))
        stats = svc.ingest_stats()
        assert svc.env_steps == 60 and stats["decode_errors"] == 0
        assert sum(p["rows_in"] for p in stats["per_shard"]) == 60
        assert server.weight_stats()["frames_full"] >= 1
    finally:
        receiver.close()
        server.close()
        svc.close()
    image = twp.decode_flat(twp.encode_flat(
        tws._flatten(ts.actor.state_dict()), codec))
    actor = copy.deepcopy(ts.actor)
    actor.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           torch_layout(tws._unflatten(image)["params"])
                           .items()})
    want = t_greedy(actor, torch.as_tensor(rows.obs)).numpy()
    np.testing.assert_allclose(rows.action, want, atol=1e-6, rtol=0)
