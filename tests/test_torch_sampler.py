"""Port vs reference: the sample-on-ingest host dealer
(``d4pg_tpu_torch/replay/sampler.py``, ``replay/staging.DealtBlockRing``,
``replay/schedule.SharedBetaSchedule``).

``ShardSlicePerTrees`` bitwise against one flat tree and against the
reference's (K = 1, 2, 4 slices; all-zero slices; one leaf per slice);
the dealer's blocks bitwise against the port's host path (``add`` +
``update_priorities`` + ``sample_chunk`` on a twin buffer) and against the
reference's ``SampleDealer`` fed the same inserts and write-backs from
the same seed; the shared beta clock; the write-back generation fence;
dead tickets never dealt; the ring's capacity, close and clear; the
``sampler`` registry provider and the ``deal`` span. The N = 1 dealt
replica against the host replica is in ``test_torch_learner_plane.py``.
"""

import threading
import time

import numpy as np
import pytest

from d4pg_tpu.replay.prioritized import PrioritizedReplayBuffer as JaxPER
from d4pg_tpu.replay.sampler import SampleDealer as JaxDealer
from d4pg_tpu.replay.sampler import ShardSlicePerTrees as JaxSlices
from d4pg_tpu.replay.schedule import SharedBetaSchedule as JaxBeta
from d4pg_tpu.replay.staging import DealtBlockRing as JaxRing
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.obs import trace as obs_trace
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.sampler import SampleDealer, ShardSlicePerTrees
from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
from d4pg_tpu_torch.replay.segment_tree import MinTree, SumTree
from d4pg_tpu_torch.replay.staging import DealtBlockRing
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport


def _batch(rng, n, obs_dim=6, act_dim=3):
    return TransitionBatch(
        obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32))


# ------------------------------------------- shard-slice tree merge ----


@pytest.mark.parametrize("backend", ["numpy", "auto"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_slice_merge_bitwise_equals_single_tree_and_reference(rng, k,
                                                              backend):
    cap = 64
    merged = ShardSlicePerTrees(cap, k, backend=backend)
    ref = JaxSlices(cap, k, backend="numpy")
    s, m = SumTree(cap), MinTree(cap)
    assert merged.backend == ("numpy" if backend == "numpy" else
                              merged.backend)
    for _ in range(25):
        idx = rng.integers(0, cap, size=int(rng.integers(1, 17)))
        vals = rng.uniform(0.01, 5.0, size=idx.size)
        for t in (merged, ref, s, m):
            t.set(idx, vals)
        assert merged.total() == s.sum() == ref.total()
        assert merged.min() == m.min() == ref.min()
        np.testing.assert_array_equal(merged.get(idx), s.get(idx))
        prefixes = rng.uniform(0.0, s.sum(), size=33)
        got = merged.find_prefixsum(prefixes)
        np.testing.assert_array_equal(got, s.find_prefixsum(prefixes))
        np.testing.assert_array_equal(got, ref.find_prefixsum(prefixes))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k", [2, 4])
def test_slice_merge_with_all_zero_priority_slices(rng, k, dtype):
    cap = 32
    merged = ShardSlicePerTrees(cap, k, backend="numpy", dtype=dtype)
    ref = JaxSlices(cap, k, backend="numpy", dtype=dtype)
    s = SumTree(cap)
    idx = np.arange(cap // k)  # only slice 0 holds mass
    vals = rng.uniform(0.1, 2.0, size=idx.size)
    for t in (merged, ref, s):
        t.set(idx, vals)
    prefixes = rng.uniform(0.0, float(merged.total()), size=50)
    np.testing.assert_array_equal(merged.find_prefixsum(prefixes),
                                  ref.find_prefixsum(prefixes))
    if dtype == np.float64:
        assert merged.total() == s.sum()
        np.testing.assert_array_equal(merged.find_prefixsum(prefixes),
                                      s.find_prefixsum(prefixes))
    hi = np.arange(cap - cap // k, cap)  # a write into a zero slice
    hvals = rng.uniform(0.1, 2.0, size=hi.size)
    for t in (merged, ref, s):
        t.set(hi, hvals)
    assert merged.total() == ref.total()
    prefixes = rng.uniform(0.0, float(merged.total()), size=50)
    np.testing.assert_array_equal(merged.find_prefixsum(prefixes),
                                  ref.find_prefixsum(prefixes))


def test_slice_cap_one_edge(rng):
    cap = 8
    merged = ShardSlicePerTrees(cap, cap, backend="numpy")
    s = SumTree(cap)
    vals = rng.uniform(0.1, 3.0, size=cap)
    merged.set(np.arange(cap), vals)
    s.set(np.arange(cap), vals)
    assert merged.slice_cap == 1 and merged.total() == s.sum()
    prefixes = rng.uniform(0.0, s.sum(), size=40)
    np.testing.assert_array_equal(merged.find_prefixsum(prefixes),
                                  s.find_prefixsum(prefixes))


def test_capacity_one_tree(rng):
    merged = ShardSlicePerTrees(1, 4, backend="numpy")
    ref = JaxSlices(1, 4, backend="numpy")
    assert merged.n_slices == ref.n_slices == 1
    merged.set(np.array([0]), np.array([2.5]))
    ref.set(np.array([0]), np.array([2.5]))
    assert merged.total() == ref.total() == 2.5
    prefixes = np.array([0.0, 1.0, 2.5, 3.0])
    np.testing.assert_array_equal(merged.find_prefixsum(prefixes),
                                  ref.find_prefixsum(prefixes))


# ------------------------------------------- the dealer's block oracle --


def _lockstep(rng, k_shards, rounds=4):
    """The port's dealer, a port twin buffer sampled the host way, and
    the reference's dealer: same seed, same inserts, same write-backs."""
    CAP, K, B, SEED = 128, 3, 8, 11
    legacy = PrioritizedReplayBuffer(CAP, 6, 3, alpha=0.6, seed=SEED,
                                     backend="numpy")
    twin = PrioritizedReplayBuffer(CAP, 6, 3, alpha=0.6, seed=SEED)
    jbuf = JaxPER(CAP, 6, 3, alpha=0.6, seed=SEED, backend="numpy")
    ring, jring = DealtBlockRing(1), JaxRing(1)
    dealer = SampleDealer(CAP, [ring], n_shards=k_shards, k=K, batch_size=B,
                          alpha=0.6, beta_schedule=SharedBetaSchedule(0.4,
                                                                      1000),
                          seed=SEED, ring_capacity=1)
    jdealer = JaxDealer(CAP, [jring], n_shards=k_shards, k=K, batch_size=B,
                        alpha=0.6, beta_schedule=JaxBeta(0.4, 1000),
                        seed=SEED, ring_capacity=1)
    sched = SharedBetaSchedule(0.4, 1000)
    dealer.pause_dealing()
    jdealer.pause_dealing()
    for i in range(3):
        batch = _batch(rng, 48)
        legacy.add(batch)
        dealer.ingest_and_deal([(twin.add(batch), i, None)], twin)
        jdealer.ingest_and_deal([(jbuf.add(JaxBatch(*batch)), i, None)], jbuf)
    dealer.resume_dealing()
    jdealer.resume_dealing()
    for _ in range(rounds):
        dealt = dealer.ingest_and_deal((), twin)
        jdealt = jdealer.ingest_and_deal((), jbuf)
        assert len(dealt) == len(jdealt) == 1
        dealer.publish(dealt)
        jdealer.publish(jdealt)
        blk, jblk = ring.pop(timeout=0), jring.pop(timeout=0)
        beta = sched.beta_at(sched.current_step())
        lb, lw, lidx = legacy.sample_chunk(3, 8, beta=beta,
                                           weight_base=legacy.weight_base())
        sched.advance(3)
        yield blk, jblk, (lb, lw, lidx, beta, legacy.generation[lidx])
        td = rng.uniform(0.05, 3.0, size=lidx.shape)
        legacy.update_priorities(lidx, td, generation=legacy.generation[lidx])
        dealer.queue_writeback(blk.idx, td, blk.gen)
        jdealer.queue_writeback(jblk.idx, td, jblk.gen)
    assert dealer.dealt_blocks == jdealer.dealt_blocks == rounds
    dealer.close()
    jdealer.close()


@pytest.mark.parametrize("k_shards", [1, 2])
def test_dealer_blocks_bitwise_equal_host_path_and_reference(rng, k_shards):
    for blk, jblk, (lb, lw, lidx, beta, lgen) in _lockstep(rng, k_shards):
        np.testing.assert_array_equal(blk.idx, lidx)
        np.testing.assert_array_equal(blk.weights, lw)
        assert blk.weights.dtype == lw.dtype == np.float32
        assert blk.beta == beta and blk.step == jblk.step
        np.testing.assert_array_equal(blk.gen, lgen)
        for a, b in zip(blk.batches, lb):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(blk.idx, jblk.idx)
        np.testing.assert_array_equal(blk.weights, jblk.weights)
        np.testing.assert_array_equal(blk.gen, jblk.gen)
        assert blk.beta == jblk.beta
        for a, b in zip(blk.batches, jblk.batches):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_idle_ticks_and_a_full_ring_skip_before_the_generator(rng):
    """A full ring skips a deal without a draw: the next block is the one
    an uninterrupted dealer deals."""
    blocks = []
    for hold in (False, True):
        buf = PrioritizedReplayBuffer(64, 6, 3, seed=3)
        ring = DealtBlockRing(1)
        dealer = SampleDealer(64, [ring], n_shards=1, k=1, batch_size=4,
                              seed=3, ring_capacity=1)
        dealer.publish(dealer.ingest_and_deal(
            [(buf.add(_batch(np.random.default_rng(1), 32)), 0, None)], buf))
        if hold:  # the ring stays full for two ticks
            dealer.publish(dealer.ingest_and_deal(
                [(buf.add(_batch(np.random.default_rng(2), 0)), 1, None)],
                buf))
            dealer.publish(dealer.ingest_and_deal((), buf))
            assert dealer.deals_skipped_full == 1
        ring.pop(timeout=0)
        dealer.publish(dealer.ingest_and_deal((), buf))
        blocks.append(ring.pop(timeout=0))
        dealer.close()
    np.testing.assert_array_equal(blocks[0].idx, blocks[1].idx)


# ------------------------------------------- the shared beta clock ------


def test_shared_beta_two_replicas_same_step_same_beta():
    sched = SharedBetaSchedule(beta0=0.4, beta_steps=1000)
    barrier = threading.Barrier(2)
    out: list = [None, None]

    def reader(i):
        barrier.wait()
        t = sched.current_step()
        out[i] = (t, sched.beta_at(t))

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert out[0] == out[1]

    def advancer():
        for _ in range(50):
            sched.advance(5)

    threads = [threading.Thread(target=advancer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive()
    assert sched.current_step() == 1000
    assert sched.beta_at(sched.current_step()) == 1.0


def test_shared_beta_matches_reference():
    sched, ref = SharedBetaSchedule(0.4, 100), JaxBeta(0.4, 100)
    for t in (0, 1, 37, 50, 99, 100, 250):
        assert sched.beta_at(t) == ref.beta_at(t)
        assert sched.beta_at(t) == 0.4 + (1.0 - 0.4) * min(1.0, t / 100)
    assert sched.advance(3) == ref.advance(3) == 0
    assert sched.current_step() == ref.current_step() == 3


# ------------------------------------------- write-back fencing --------


def test_writeback_generation_fence_drops_stale(rng):
    CAP, K, B = 64, 1, 4
    ring = DealtBlockRing(capacity=2)
    buf = PrioritizedReplayBuffer(CAP, 6, 3, alpha=0.6, seed=0)
    dealer = SampleDealer(CAP, [ring], n_shards=1, k=K, batch_size=B,
                          min_size=1, seed=0, ring_capacity=2)
    idx = buf.add(_batch(rng, 16))
    dealer.publish(dealer.ingest_and_deal([(idx, 0, None)], buf))
    blk = ring.pop(timeout=0)
    victim = int(blk.idx.ravel()[0])
    dealer.ingest_and_deal([(np.array([victim]), 1, None)], buf)
    before = dealer._trees.get(blk.idx.ravel()).copy()
    dealer.queue_writeback(blk.idx, np.full(blk.idx.shape, 9.0), blk.gen)
    dealer.drain_writebacks_for_shard(0)
    after = dealer._trees.get(blk.idx.ravel())
    stale = blk.idx.ravel() == victim
    assert dealer.writeback_dropped_stale == int(stale.sum())
    np.testing.assert_array_equal(after[stale], before[stale])
    if (~stale).any():
        np.testing.assert_array_equal(
            after[~stale], np.full(int((~stale).sum()), 9.0 ** 0.6))
    with pytest.raises(ValueError, match="positive"):
        dealer.queue_writeback(blk.idx, np.zeros(blk.idx.shape), blk.gen)
    dealer.close()


def test_shed_tickets_are_never_dealt(rng):
    """Tickets the service sheds never insert rows: with the audit on the
    dealer counts no dealt dead ticket while live rows keep dealing, and
    the service settles write-backs through ``queue_writeback``."""
    from d4pg_tpu_torch.distributed.replay_service import ReplayService

    svc = ReplayService(PrioritizedReplayBuffer(256, 6, 3, seed=0),
                        ingest_capacity=4, shed_watermark=0.5)
    ring = DealtBlockRing(capacity=2)
    dealer = SampleDealer(256, [ring], n_shards=1, k=1, batch_size=4,
                          seed=0, ring_capacity=2, audit=True)
    svc.attach_dealer(dealer)
    try:
        for i in range(40):
            svc.add(_batch(rng, 4), actor_id=f"a{i % 3}")
        svc.flush(timeout=10.0)
        blk = ring.pop(timeout=5.0)
        assert blk is not None
        svc.queue_writeback(blk.idx, np.full(blk.idx.shape, 2.0), blk.gen)
        deadline = time.monotonic() + 5.0
        while dealer.sampler_stats()["dealer_queue_depth"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert dealer.sampler_stats()["dealer_queue_depth"] == 0
        assert dealer.dealt_dead_tickets == 0
        stats = svc.ingest_stats()
        assert svc.env_steps == stats["rows_committed"]
    finally:
        svc.close()
    assert ring.closed  # the service's close closes the rings


def test_queue_writeback_without_a_dealer_raises():
    from d4pg_tpu_torch.distributed.replay_service import ReplayService

    svc = ReplayService(PrioritizedReplayBuffer(16, 6, 3, seed=0))
    try:
        with pytest.raises(RuntimeError, match="attach_dealer"):
            svc.queue_writeback(np.zeros(1, np.int64), np.ones(1),
                                np.zeros(1, np.int64))
    finally:
        svc.close()


# ------------------------------------------- the dealt ring ------------


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_dealt_ring_capacity_close_and_clear(impl):
    ring = DealtBlockRing(2) if impl == "port" else JaxRing(2)
    kicks = []
    ring.on_room = lambda: kicks.append(1)
    assert ring.room() == 2
    assert ring.offer("a") and ring.offer("b")
    assert not ring.offer("c")
    assert ring.depth() == 2 and ring.room() == 0
    assert ring.pop(timeout=0) == "a"
    assert ring.offer("c")
    assert ring.clear() == 2
    assert len(kicks) == 2  # a pop and a clear freed room
    assert ring.pop(timeout=0.01) is None
    ring.close()
    assert ring.closed and ring.room() == 0
    assert not ring.offer("d")
    assert ring.pop(timeout=None) is None  # close ends a waiting pop


def test_close_wakes_a_waiting_pop():
    ring = DealtBlockRing(1)
    out = []
    t = threading.Thread(target=lambda: out.append(ring.pop()))
    t.start()
    time.sleep(0.05)
    ring.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and out == [None]


# ------------------------------------------- obs plane -----------------


def test_sampler_provider_and_deal_span(rng):
    obs_trace.RECORDER.reset()
    obs_trace.RECORDER.enable(sample_rate=1.0)
    REGISTRY.histogram("sampler.writeback_lag_ms").reset()
    ring = DealtBlockRing(capacity=1)
    buf = PrioritizedReplayBuffer(64, 6, 3, alpha=0.6, seed=0)
    dealer = SampleDealer(64, [ring], n_shards=1, k=1, batch_size=4,
                          min_size=1, seed=0, ring_capacity=1)
    try:
        tid = 7
        obs_trace.RECORDER.begin(tid, time.monotonic())
        obs_trace.RECORDER.record_span(tid, "admission")
        obs_trace.RECORDER.mark_committed([tid])
        dealt = dealer.ingest_and_deal(
            [(buf.add(_batch(rng, 16)), 0, tid)], buf)
        assert len(dealt) == 1
        dealer.publish(dealt)
        blk = dealt[0][1]
        assert blk.tid == tid
        dealer.queue_writeback(blk.idx, np.full(blk.idx.shape, 1.0), blk.gen)
        dealer.drain_writebacks_for_shard(0)
        obs_trace.RECORDER.mark_grad()
        lat = obs_trace.RECORDER.latency_block()
        assert lat["orphans"] == 0
        assert lat["stages"]["commit_to_deal"]["n"] >= 1
        assert lat["stages"]["deal_to_grad"]["n"] >= 1
        prov = REGISTRY.export()["sampler"]
        assert prov["dealt_blocks"] == 1 and prov["dealt_rows"] == 4
        assert prov["dealer_queue_depth"] == 0
        assert prov["writeback_lag_ms"]["n"] == 1
        assert prov["ring_capacity"] == 1 and prov["ring_depths"] == [1]
    finally:
        dealer.close()
        obs_trace.RECORDER.disable()
        obs_trace.RECORDER.reset()
    assert "sampler" not in REGISTRY.export()
