"""Port vs reference: the ingest path of the fused learner.

The block ingest API of ``FusedDeviceReplay`` (``stage_block`` /
``commit_staged`` / ``drain`` / ``take``), the in-process
``ReplayService`` at one ingest shard, ``IngestOverlap``'s
single-consumer checks, and ``FusedLoop`` fed by a service. Both packages
get the same rows (numpy seeds) through their own calls; rings, sizes and
heads must be bitwise equal, and so must the trees (every insert is at
``max_priority ** alpha`` with ``max_priority`` 1, which both round to
1). ``stage_block`` copies its frame out of the staging ring; a test
pushes rows that lap the staging ring while a block is in flight and
holds the result to synchronous drains.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.core import locking as jlocking
from d4pg_tpu.distributed.replay_service import ReplayService as JaxService
from d4pg_tpu.learner import state as jstate
from d4pg_tpu.learner.loop import FusedLoop as JaxLoop
from d4pg_tpu.learner.update import update_step as jax_update_step
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxReplay
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.envs.normalizer import RunningMeanStd
from d4pg_tpu_torch.io.from_jax import state_from_jax, torch_layout
from d4pg_tpu_torch.learner import state as tstate
from d4pg_tpu_torch.learner.fused import make_fused_chunk
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.learner.pipeline import IngestDispatchError, IngestOverlap
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.uniform import TransitionBatch
from torch_lock_modes import debug_mode  # noqa: F401  (a fixture)

pytestmark = pytest.mark.torchport

OBS, ACT = 5, 2
TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = dict(obs_dim=OBS, act_dim=ACT, v_min=-10.0, v_max=10.0, n_atoms=11,
            hidden=(16, 16))


def _rows(rng, n):
    done = (rng.random(n) < 0.2).astype(np.float32)
    return dict(
        obs=rng.standard_normal((n, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, OBS)).astype(np.float32),
        done=done,
        discount=(0.99 ** 3 * (1 - done)).astype(np.float32),
    )


def _assert_same_replay(tbuf, jbuf, trees=True):
    assert (tbuf.size, tbuf.head) == (jbuf.size, jbuf.head)
    cap = tbuf.capacity
    for name, t, j in zip(TransitionBatch._fields, tbuf.storage,
                          jbuf.storage):
        np.testing.assert_array_equal(t[:cap].numpy(), np.asarray(j)[:cap],
                                      err_msg=name)
    if trees and jbuf.trees is not None:
        for t, j in zip(tbuf.trees, jbuf.trees):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("cap,block,sizes,prioritized", [
    (96, 32, (33, 64, 7, 100, 128, 5), True),  # partials, > capacity
    (50, 16, (10, 40, 23, 50, 9, 64), False),  # wraps the ring end
    (64, 16, (21,), True),  # one full block and a partial one
])
def test_block_stage_commit_matches_reference(rng, cap, block, sizes,
                                              prioritized):
    tbuf = FusedDeviceReplay(cap, OBS, ACT, block_rows=block,
                             prioritized=prioritized, device="cpu")
    jbuf = JaxReplay(cap, OBS, ACT, block_rows=block, prioritized=prioritized)
    for n in sizes:
        rows = _rows(rng, n)
        tbuf.add(TransitionBatch(**rows))
        jbuf.add(JaxBatch(**rows))
        # one block by hand, then the rest through drain()
        assert tbuf.stage_block() == jbuf.stage_block()
        assert len(tbuf) == len(jbuf)
        assert tbuf.stage_block() == 0  # the in-flight depth is one
        assert tbuf.commit_staged() == jbuf.commit_staged()
        assert tbuf.drain() == jbuf.drain()
        _assert_same_replay(tbuf, jbuf)
    assert tbuf.commit_staged() == 0 and tbuf.drain() == 0


def test_pushes_while_a_block_is_in_flight_land_as_staged(rng):
    """The staging ring holds 16 rows; 30 rows pushed while the first
    block is in flight lap it (overwriting the popped rows the block was
    read from) and drop the oldest pending rows. The ring and trees must
    be bitwise those of synchronous drains: the staged block as it was,
    then the newest 16. (The reference's ``stage_block`` hands the
    staging views to ``jax.device_put``, which on the JAX CPU backend
    may alias them, so there it can land the later rows instead: not a
    parity case.)"""
    inflight = FusedDeviceReplay(64, OBS, ACT, block_rows=8,
                                 staging_blocks=2, device="cpu")
    synchronous = FusedDeviceReplay(64, OBS, ACT, block_rows=8,
                                    staging_blocks=2, device="cpu")
    first, late = _rows(rng, 8), _rows(rng, 30)
    inflight.add(TransitionBatch(**first))
    assert inflight.stage_block() == 8
    inflight.add(TransitionBatch(**late))
    assert inflight.commit_staged() == 8
    assert inflight.drain() == 16
    for rows in (first, late):
        synchronous.add(TransitionBatch(**rows))
        synchronous.drain()
    _assert_same_replay(inflight, synchronous)
    for name, ring in zip(TransitionBatch._fields, inflight.storage):
        np.testing.assert_array_equal(ring[:8].numpy(), first[name])
        np.testing.assert_array_equal(ring[8:24].numpy(), late[name][-16:])


def test_staging_take_pops_views_in_order(rng):
    tbuf = FusedDeviceReplay(64, OBS, ACT, block_rows=8, staging_blocks=2,
                             device="cpu")
    a, b = _rows(rng, 12), _rows(rng, 10)
    tbuf.add(TransitionBatch(**a))
    assert tbuf.stage_block() == 8
    tbuf.add(TransitionBatch(**b))  # 14 pending; the ring wraps
    parts = tbuf._staging.take(14)
    assert len(parts) == 2 and len(tbuf._staging) == 0
    got = np.concatenate([p.obs for p in parts])
    np.testing.assert_array_equal(got, np.concatenate([a["obs"][8:],
                                                       b["obs"]]))
    assert tbuf._staging.take(3) == []


def _service_pair(cap=256, block=16, prioritized=True):
    tbuf = FusedDeviceReplay(cap, OBS, ACT, block_rows=block,
                             prioritized=prioritized, device="cpu")
    jbuf = JaxReplay(cap, OBS, ACT, block_rows=block, prioritized=prioritized)
    return (ReplayService(tbuf), tbuf), (JaxService(jbuf), jbuf)


def test_service_add_flush_drain_lands_the_reference_ring(rng):
    (tsvc, tbuf), (jsvc, jbuf) = _service_pair(cap=128)
    try:
        for i, n in enumerate((7, 0, 30, 64, 1, 50)):
            rows = _rows(rng, n)
            aid = f"actor-{i % 2}"
            assert tsvc.add(TransitionBatch(**rows), actor_id=aid)
            assert jsvc.add(JaxBatch(**rows), actor_id=aid)
        # relabel-style rows do not count as env steps
        rows = _rows(rng, 9)
        tsvc.add(TransitionBatch(**rows), count_env_steps=False)
        jsvc.add(JaxBatch(**rows), count_env_steps=False)
        tsvc.flush(), jsvc.flush()
        assert tsvc.env_steps == jsvc.env_steps == 152
        assert len(tsvc) == len(jsvc) == 128
        assert tsvc.drain_device() == jsvc.drain_device()
        _assert_same_replay(tbuf, jbuf)
        assert tsvc.dead_actors() == [] and tsvc._rows_committed == 161
        tsvc.set_env_steps(5)
        assert tsvc.env_steps == 5
    finally:
        tsvc.close(), jsvc.close()


def test_service_concurrent_producers_lose_no_row():
    """More producer threads than cores, a short switch interval and a
    small admission deque (blocking adds): every row lands exactly once
    and the counters agree."""
    producers, batches, rows = 16, 12, 5
    # staging for every row: nothing is dropped for backlog
    buf = FusedDeviceReplay(producers * batches * rows, OBS, ACT,
                            block_rows=64, staging_blocks=16, device="cpu")
    svc = ReplayService(buf, ingest_capacity=4)

    def produce(p):
        for b in range(batches):
            ids = (p * batches + b) * rows + np.arange(rows)
            obs = np.repeat(ids[:, None], OBS, 1).astype(np.float32)
            assert svc.add(TransitionBatch(
                obs=obs, action=np.zeros((rows, ACT), np.float32),
                reward=np.zeros(rows, np.float32), next_obs=obs,
                done=np.zeros(rows, np.float32),
                discount=np.ones(rows, np.float32)),
                actor_id=f"p{p}", timeout=30.0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=produce, args=(p,))
                   for p in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        svc.flush(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    total = producers * batches * rows
    try:
        assert svc.env_steps == total and len(svc) == total
        assert svc.drain_device() == total
        ids = np.sort(buf.storage.obs[:total, 0].numpy())
        np.testing.assert_array_equal(ids, np.arange(total))
        assert svc._pending == 0 and svc._rows_committed == total
        assert svc._shards[0].admit_fails == 0
    finally:
        svc.close()


def test_service_modes_and_an_early_writeback():
    """Every mode of the service is ported: a generation other than 0
    (crash recovery: tests/test_torch_recovery.py), sharded ingest and
    shedding (tests/test_torch_sharded_ingest.py), observation
    normalization (tests/test_torch_normalizer.py), the elastic admission
    policy and live resizing (tests/test_torch_elastic.py); a write-back
    before any dealer is attached is a usage error."""
    from d4pg_tpu_torch.elastic import AdmissionPolicy

    buf = FusedDeviceReplay(32, OBS, ACT, device="cpu")
    restarted = ReplayService(buf, generation=1,
                              admission=AdmissionPolicy())
    assert restarted.generation == 1 and restarted.dealer is None
    restarted.close()
    svc = ReplayService(buf, obs_norm=RunningMeanStd(OBS),
                        num_ingest_shards=2, shed_watermark=0.5)
    try:
        svc.set_ingest_depth(8)
        assert [s["shed_at"] for s in svc.ingest_stats()["per_shard"]] \
            == [4, 4]
        with pytest.raises(RuntimeError, match="attach_dealer"):
            svc.queue_writeback(None, None, None)
    finally:
        svc.close()
    sharded = FusedDeviceReplay(32, OBS, ACT, device="cpu", ingest_shards=2)
    assert sharded.ingest_shards == 2


def test_lock_tiers_are_the_reference_tiers():
    assert locking.HIERARCHY == {name: jlocking.HIERARCHY[name]
                                 for name in locking.HIERARCHY}


@pytest.mark.parametrize("outer,inner", [
    ("shard", "buffer"),     # an ingest deque held across replay access
    ("wstore", "service"),   # a weight read held across a service call
    ("commit", "commit"),    # an equal tier is not a descent
])
def test_inverted_acquisition_raises_and_leaves_the_stack_clean(outer, inner,
                                                              debug_mode):
    first = locking.TieredCondition(outer)
    second = locking.TieredLock(inner)
    with first:
        with pytest.raises(locking.LockHierarchyError, match=inner):
            second.acquire()
        assert not second.locked()
    # the failed acquisition left nothing held: the inner tier alone is legal
    with second:
        pass
    assert locking._tls.held == []


def test_descent_holds_across_a_condition_wait(debug_mode):
    service = locking.TieredLock("service")
    cond = locking.TieredCondition("shard")
    with service, cond:
        assert not cond.wait(0.001)
        assert [n for _, n in locking._tls.held] == ["service", "shard"]
        with pytest.raises(locking.LockHierarchyError):
            locking.TieredLock("buffer").acquire()
    assert locking._tls.held == []


def test_ingest_overlap_is_single_consumer():
    (svc, _), (jsvc, _) = _service_pair()
    try:
        first = IngestOverlap(svc)
        with pytest.raises(IngestDispatchError, match="already has"):
            IngestOverlap(svc)
        assert first.commit() == 0 and first.stage() == 0
        # a dispatch in flight: a second call raises instead of waiting
        first._busy.acquire()
        with pytest.raises(IngestDispatchError, match="concurrent"):
            first.flush()
        first._busy.release()
        first.release()
        second = IngestOverlap(svc)  # the slot is free again
        with pytest.raises(IngestDispatchError, match="ownership moved"):
            first.commit()
        second.release()
        second.release()  # idempotent
        del second
        IngestOverlap(svc)  # a dropped owner releases through GC too
    finally:
        svc.close(), jsvc.close()


def test_fused_loop_with_service_ingests_as_reference(rng):
    """One sequence of adds, the same schedule: each chunk commits the
    block staged after the previous one and stages the next; rows added
    between chunks land in the same ring slots as the reference's."""
    (tsvc, tbuf), (jsvc, jbuf) = _service_pair(cap=256, block=16)
    tcfg = tstate.D4PGConfig(**DIMS, projection="pallas")
    jcfg = jstate.D4PGConfig(**DIMS, projection="einsum")
    tstate_ = tstate.init_state(tcfg, seed=0, device="cpu")
    js = jstate.init_state(jcfg, jax.random.key(0))
    tloop = FusedLoop(tcfg, tbuf, k=2, batch_size=8,
                      generator=torch.Generator().manual_seed(0),
                      service=tsvc)
    jloop = JaxLoop(jcfg, jbuf, k=2, batch_size=8, service=jsvc,
                    donate=False)
    batches = [_rows(rng, n) for n in (40, 20, 25, 3, 30, 18, 7, 33, 12)]
    try:
        for svc, batch in ((tsvc, TransitionBatch), (jsvc, JaxBatch)):
            svc.add(batch(**batches[0]))
            svc.flush()
        feed = iter(batches[1:])

        def add_next(svc, batch):
            def on_chunk(*_):
                rows = next(feed, None)
                if rows is not None:
                    svc.add(batch(**rows))
                    svc.flush()  # staged before the next chunk's stage()
            return on_chunk

        feed = iter(batches[1:])
        tloop.run(tstate_, 9, on_chunk=add_next(tsvc, TransitionBatch))
        feed = iter(batches[1:])
        js, _ = jloop.run(js, 9, on_chunk=add_next(jsvc, JaxBatch))
        for name in ("rows_committed", "rows_staged", "blocks"):
            assert (getattr(tloop.ingest, name)
                    == getattr(jloop.ingest, name)), name
        assert tloop.ingest.rows_staged > 0
        _assert_same_replay(tbuf, jbuf, trees=False)
        assert tloop.steps_done == jloop.steps_done == 9
        # the next run's flush lands the rest, as the reference's does
        tloop.run(tstate_, 1), jloop.run(js, 1)
        _assert_same_replay(tbuf, jbuf, trees=False)
    finally:
        tloop.close(), jloop.close()
        tsvc.close(), jsvc.close()


def test_chunk_after_service_fill_matches_reference_step_by_step(rng):
    """Buffers filled through the services; then one PER chunk with
    injected uniforms against the reference run step by step
    (``sample_from_uniforms`` -> ``is_weights`` -> ``update_step`` ->
    ``update_from_td``)."""
    (tsvc, tbuf), (jsvc, jbuf) = _service_pair(cap=64, block=16)
    try:
        for n in (20, 30, 25):
            rows = _rows(rng, n)
            tsvc.add(TransitionBatch(**rows))
            jsvc.add(JaxBatch(**rows))
        tsvc.flush(), jsvc.flush()
        tsvc.drain_device(), jsvc.drain_device()
    finally:
        tsvc.close(), jsvc.close()
    _assert_same_replay(tbuf, jbuf)
    k, batch = 3, 8
    jcfg = jstate.D4PGConfig(**DIMS, projection="pallas")
    tcfg = tstate.D4PGConfig(**DIMS, projection="pallas")
    js = jstate.init_state(jcfg, jax.random.key(1))
    ts = state_from_jax(tcfg, jax.tree_util.tree_map(
        np.asarray, js._replace(key=jax.random.key_data(js.key))), "cpu")
    u = rng.random((k, batch)).astype(np.float32)
    update = jax.jit(lambda s, b, w: jax_update_step(jcfg, s, b, w))
    jt, jm = jbuf.trees, []
    for t in range(k):
        idx = jdper.sample_from_uniforms(jt, jnp.asarray(u[t]),
                                         jnp.int32(jbuf.size))
        w = jdper.is_weights(jt, idx, jdper.beta_schedule(js.step, 0.4,
                                                          100_000),
                             jnp.int32(jbuf.size))
        js, m = update(js, JaxBatch(*[arr[idx] for arr in jbuf.storage]), w)
        jt = jdper.update_from_td(jt, idx, m["td_error"], 0.6)
        jm.append({**m, "idx": idx})
    fn = make_fused_chunk(tcfg, k=k, batch_size=batch)
    tt, tm = fn(ts, tbuf.trees, tbuf.storage, tbuf.size,
                u=torch.from_numpy(u))
    for t in range(k):
        np.testing.assert_array_equal(tm["idx"][t].numpy(),
                                      np.asarray(jm[t]["idx"]))
        for name in ("critic_loss", "actor_loss", "td_error"):
            np.testing.assert_allclose(tm[name][t].numpy(),
                                       np.asarray(jm[t][name]),
                                       err_msg=f"{name} step {t}", **TOL)
    arrays = torch_layout(js.actor_params["params"])
    for name, p in ts.actor.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), arrays[name], **TOL)
    for t, j in zip(tt, jt):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
