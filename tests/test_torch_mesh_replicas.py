"""Port vs reference: mesh-native learner replicas
(``d4pg_tpu_torch/learner/mesh_replicas.py``, ``fleet/mesh_ab.py``).

The reference's eight ``tests/test_mesh_replicas.py`` cases on the port,
on the CPU:

  1. N = 1 through the group is bitwise the port's ``FusedLoop``;
  2. each replica's stream before the merge is bitwise an independent
     ``FusedLoop`` from the same state over the same fill;
  3. the sync merge is within rtol 1e-6 of the port's host
     ``Aggregator`` fed the same round (float64 sums on both sides);
  4. the async fold is BITWISE the host ``Aggregator`` receiving the
     same round-synchronous submissions in replica order (the three
     float32 operations of ``_blend``; the reference's own fold misses
     its aggregator by one float32 rounding, ROADMAP Queue 3);
  5. merged rounds publish monotone versions, and the store's latest is
     the merged actor;
  6. a bad mode or clip is refused; 7. ``run_round`` before ``load``
     raises;
  8. ``run_mesh_ab``'s row schema at a small ``MeshABConfig`` (the
     reference's case reads its committed fleet artifact; the port's
     artifact waits for item 17c).

And two cases across the packages: the port's merge against the
reference's ``make_collective_merge`` on the same numpy ``[N, ...]``
stacks (sync rtol 1e-6; async rtol 1e-6 with atol 1e-9, which covers the
reference's float32 rounding), and ``step_host_chunks`` plus one merge
against the reference's group at N = 2 on two virtual JAX CPU devices,
from states carried by ``io/from_jax.py``: metrics at the reference's
``tests/test_parallel.py`` TD bars (rtol 1e-4, atol 1e-5: the actor loss
of these small nets lies near zero, where a relative bar alone measures
float32 summation order), parameters at the learner's atol 1e-5.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.learner import D4PGConfig as JaxConfig
from d4pg_tpu.learner import init_state as jax_init_state
from d4pg_tpu.learner.mesh_replicas import MeshReplicaGroup as JaxGroup
from d4pg_tpu.learner.mesh_replicas import (
    make_collective_merge as jax_merge,
)
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.fleet.mesh_ab import MeshABConfig, run_mesh_ab
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner.aggregator import Aggregator
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.learner.mesh_replicas import (
    MeshReplicaGroup,
    make_collective_merge,
)
from d4pg_tpu_torch.learner.replica import (
    PARAM_FIELDS,
    params_of,
    replica_state,
)
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

OBS, ACT, N_ROWS, STEPS = 5, 2, 96, 4
KW = dict(obs_dim=OBS, act_dim=ACT, v_min=-10, v_max=10, n_atoms=11,
          hidden=(16, 16))
METRICS = dict(rtol=1e-4, atol=1e-5)  # tests/test_parallel.py's TD bars
PARAM_ATOL = 1e-5  # the learner's (test_torch_families.py)


def _config():
    return D4PGConfig(**KW)


def _batch(rng):
    return TransitionBatch(
        obs=rng.standard_normal((N_ROWS, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (N_ROWS, ACT)).astype(np.float32),
        reward=rng.standard_normal(N_ROWS).astype(np.float32),
        next_obs=rng.standard_normal((N_ROWS, OBS)).astype(np.float32),
        done=np.zeros(N_ROWS, np.float32),
        discount=np.full(N_ROWS, 0.99, np.float32))


def _fill(batch):
    buf = FusedDeviceReplay(N_ROWS, OBS, ACT, alpha=0.6, device="cpu")
    buf.add(batch)
    buf.drain()
    return buf


def _replica_states(config, n):
    """The driver's replica construction: identical networks, replica 0
    continuing the state's generator, replica i > 0 its own."""
    base = init_state(config, 0, "cpu")
    return [replica_state(base, i, 0) for i in range(n)]


def _group(config, n, **kw):
    return MeshReplicaGroup(config, _replica_states(config, n), k=2,
                            batch_size=8, **kw)


def _assert_trees_equal(a, b):
    for f in PARAM_FIELDS:
        assert set(a[f]) == set(b[f])
        for name in a[f]:
            assert torch.equal(a[f][name].cpu(), b[f][name].cpu()), \
                f"{f}/{name}"


def test_n1_mesh_path_bitwise_equals_legacy_loop(rng):
    config = _config()
    batch = _batch(rng)
    legacy = init_state(config, 0, "cpu")
    FusedLoop(config, _fill(batch), k=2, batch_size=8,
              generator=legacy.generator).run(legacy, STEPS)

    group = _group(config, 1)
    group.load(_fill(batch))
    group.run_round(STEPS)
    mesh_state = group.state_slice(0)
    _assert_trees_equal(params_of(legacy), params_of(mesh_state))
    assert mesh_state.step == legacy.step == STEPS
    for a, b in ((legacy.critic_opt, mesh_state.critic_opt),
                 (legacy.actor_opt, mesh_state.actor_opt)):
        for sa, sb in zip(a.state.values(), b.state.values()):
            assert torch.equal(sa["exp_avg"], sb["exp_avg"])
    # the merged tree IS the replica's params (the identity merge)
    _assert_trees_equal(group.merged_params(), params_of(legacy))
    group.close()


def _legacy_trees(config, batch, n):
    """n independent FusedLoops over identical fills from the group's
    initial states: the trees a round of thread replicas submits."""
    trees = []
    for state in _replica_states(config, n):
        FusedLoop(config, _fill(batch), k=2, batch_size=8,
                  generator=state.generator).run(state, STEPS)
        trees.append(params_of(state))
    return trees


def _host_merge(trees, mode, clip=8.0):
    """The port's host ``Aggregator`` receiving one round-synchronous
    round: every replica pulled the version-0 basis, so replica i's
    submission arrives at lag i (async) or joins the barrier (sync)."""
    agg = Aggregator(WeightStore(), mode=mode, clip=clip)
    epochs = [agg.register(i) for i in range(len(trees))]
    if mode == "sync":
        threads = [threading.Thread(
            target=agg.submit, args=(i, epochs[i], trees[i], 0),
            kwargs={"step": STEPS}, daemon=True)
            for i in range(len(trees))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    else:
        for i, tree in enumerate(trees):
            res = agg.submit(i, epochs[i], tree, 0, step=STEPS)
            assert res["status"] == "applied" and res["lag"] == i
    _v, merged = agg.current()
    agg.close()
    return merged


def _mesh_round(config, batch, mode, n, clip=8.0):
    group = _group(config, n, mode=mode, clip=clip)
    group.load(_fill(batch))
    group.run_round(STEPS)
    merged = group.merged_params()
    adopted = [params_of(group.state_slice(i)) for i in range(n)]
    group.close()
    return merged, adopted


def test_per_replica_streams_match_legacy_loops(rng):
    config = _config()
    batch = _batch(rng)
    legacy = _legacy_trees(config, batch, 2)
    group = _group(config, 2)
    group.load(_fill(batch))
    group._fused_steps(STEPS)  # the engine alone: no merge yet
    for i, want in enumerate(legacy):
        _assert_trees_equal(want, params_of(group.state_slice(i)))
    assert group.last_metrics["td_error"].shape == (2, 2, 8)
    group.close()


def test_sync_collective_average_matches_host_aggregator(rng):
    config = _config()
    batch = _batch(rng)
    host = _host_merge(_legacy_trees(config, batch, 2), "sync")
    merged, adopted = _mesh_round(config, batch, "sync", 2)
    for f in PARAM_FIELDS:
        for name, t in host[f].items():
            np.testing.assert_allclose(merged[f][name].numpy(), t.numpy(),
                                       rtol=1e-6, atol=0)
    for tree in adopted:  # every replica adopted the merged basis
        _assert_trees_equal(tree, merged)


def test_async_collective_fold_matches_host_aggregator(rng):
    config = _config()
    batch = _batch(rng)
    host = _host_merge(_legacy_trees(config, batch, 3), "async")
    merged, adopted = _mesh_round(config, batch, "async", 3)
    _assert_trees_equal(merged, host)
    for tree in adopted:
        _assert_trees_equal(tree, merged)


def test_merge_rounds_publish_monotone_versions(rng):
    config = _config()
    store = WeightStore()
    group = _group(config, 2, mode="async", store=store,
                   extract=lambda tree: tree["actor_params"])
    group.load(_fill(_batch(rng)))
    for _ in range(3):
        group.run_round(2)
    assert group.versions == sorted(group.versions) == [1, 2, 3]
    version, params = store.get()
    assert version == group.versions[-1]
    merged = group.merged_params()
    assert set(params) == set(merged["actor_params"])
    for name, t in params.items():
        assert torch.equal(t, merged["actor_params"][name])
    assert store.step == 3 * 2
    group.close()


def test_bad_mode_and_clip_rejected():
    config = _config()
    with pytest.raises(ValueError):
        _group(config, 1, mode="hogwild")
    with pytest.raises(ValueError):
        _group(config, 1, clip=0.5)
    with pytest.raises(ValueError):
        make_collective_merge(2, "sync", clip=0.5)


def test_run_round_before_load_raises():
    group = _group(_config(), 1)
    with pytest.raises(RuntimeError):
        group.run_round(2)


def test_mesh_ab_row_schema():
    """The reference's artifact gate on the row ``run_mesh_ab`` makes
    (CPU, a small load): both arms ran the same offered load, each with
    updates/s and per-round aggregation latency percentiles."""
    row = run_mesh_ab(MeshABConfig(rounds=2, steps_per_round=2, k=2,
                                   batch_size=8, n_rows=64),
                      device="cpu")
    assert row["metric"] == "mesh_learners_ab" and row["schema"] == 1
    assert row["n_replicas"] == 2 and row["backend"] == "cpu"
    for arm in ("socket", "collective"):
        assert row[arm]["updates_per_sec"] > 0
        assert row[arm]["agg_latency_s"]["p50"] is not None
        assert row[arm]["agg_latency_s"]["p95"] is not None
        assert row[arm]["agg_latency_s"]["n"] == 2
    assert row["load"]["rounds"] == 2 and row["load"]["steps_per_round"] == 2
    assert row["speedup_updates_per_sec"] is not None


# -- across the packages ----------------------------------------------------


@pytest.mark.parametrize("mode,n", [("sync", 3), ("async", 3), ("async", 1)])
def test_merge_matches_reference_collective_merge(rng, mode, n):
    stacks = {"kernel": rng.standard_normal((n, 4, 3)).astype(np.float32),
              "bias": rng.standard_normal((n, 3)).astype(np.float32)}
    want = jax.jit(jax_merge(n, mode, clip=2.0))(stacks)
    got = make_collective_merge(n, mode, clip=2.0)(
        {k: torch.from_numpy(v) for k, v in stacks.items()})
    for k in stacks:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9)
        if n == 1:
            np.testing.assert_array_equal(got[k].numpy(), stacks[k][0])


def _jax_replica_states(jcfg, n):
    """The reference driver's replica construction (fold_in keys)."""
    base = jax_init_state(jcfg, jax.random.key(0))
    states = []
    for i in range(n):
        s = jax.tree_util.tree_map(jnp.copy, base)
        if i:
            s = s._replace(key=jax.random.fold_in(s.key, i))
        states.append(s)
    return states


def test_step_host_chunks_and_merge_match_the_reference_group(rng):
    n, k, b = 2, 3, 8
    kw = dict(KW, projection="einsum")
    jcfg, tcfg = JaxConfig(**kw), D4PGConfig(**kw)
    jstates = _jax_replica_states(jcfg, n)
    tstates = [state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, s._replace(key=jax.random.key_data(s.key))), "cpu")
        for s in jstates]
    done = (rng.random((n, k, b)) < 0.2).astype(np.float32)
    fields = dict(
        obs=rng.standard_normal((n, k, b, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, k, b, ACT)).astype(np.float32),
        reward=rng.standard_normal((n, k, b)).astype(np.float32),
        next_obs=rng.standard_normal((n, k, b, OBS)).astype(np.float32),
        done=done, discount=(0.99 * (1 - done)).astype(np.float32))
    w = rng.uniform(0.2, 1.0, (n, k, b)).astype(np.float32)

    jgroup = JaxGroup(jcfg, jstates, k=k, batch_size=b,
                      devices=jax.devices()[:2])
    jm = jgroup.step_host_chunks(TransitionBatch(**fields), w)
    jgroup.merge()
    jmerged = jgroup.merged_params()
    group = MeshReplicaGroup(tcfg, tstates, k=k, batch_size=b)
    tm = group.step_host_chunks(TransitionBatch(**fields), w)
    group.merge()
    assert group.steps_done == jgroup.steps_done == k
    for name in ("critic_loss", "actor_loss", "q_mean", "td_error"):
        assert tuple(tm[name].shape) == np.asarray(jm[name]).shape
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   **METRICS, err_msg=name)
    merged = group.merged_params()
    for f in PARAM_FIELDS:
        want = torch_layout(jmerged[f]["params"])
        assert set(want) == set(merged[f])
        for name, arr in want.items():
            np.testing.assert_allclose(merged[f][name].numpy(), arr,
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{f}/{name}")
    for i in range(n):  # every replica adopted the merged basis
        _assert_trees_equal(params_of(group.state_slice(i)), merged)
    jgroup.close()
    group.close()
