"""Port vs reference: device-resident PER sampling
(``d4pg_tpu_torch/replay/device_sampler.DeviceSampleDealer`` over a
``FusedDeviceReplay(gen_tracked=True)``), here on the CPU.

The oracle is the seeded stream in lockstep: the device dealer (both
arms; on the CPU ``pallas`` runs the descent's plain version, the kernel
runs on the card in ``chip_smoke.py`` phase 22) against the port's
float32 host twin (``SampleDealer(scheme='device')``) bitwise in every
field, and against the reference's ``DeviceSampleDealer`` on JAX's CPU
(its Pallas arm in interpret mode) bitwise in ``idx``, rows, ``gen`` and
``beta``, with the weights within 1e-6 relative (float32 ``**`` is not
bitwise portable between XLA and torch; the port's twin and dealer call
one function). Descent edge cases against the float64 host tree: all-zero
priorities, a commit wrapping the capacity boundary, one leaf, ties. The
fenced write-back lands in the device tree; the generation-tracked
buffer's slot assignment and refusals; a ring's clear releasing dealt
device blocks; ``select_sampler``'s policy and validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay.device_sampler import DeviceSampleDealer as JaxDealer
from d4pg_tpu.replay.fused_buffer import FusedDeviceReplay as JaxFused
from d4pg_tpu.replay.schedule import SharedBetaSchedule as JaxBeta
from d4pg_tpu.replay.staging import DealtBlockRing as JaxRing
from d4pg_tpu.replay.uniform import TransitionBatch as JaxBatch
from d4pg_tpu_torch.ops import autotune as at
from d4pg_tpu_torch.ops.sampler_descent import descend
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_sampler import DeviceSampleDealer
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.sampler import SampleDealer, ShardSlicePerTrees
from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
from d4pg_tpu_torch.replay.segment_tree import SumTree
from d4pg_tpu_torch.replay.staging import DealtBlockRing
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport

CAP, K, B, OD, AD = 128, 2, 8, 4, 2


def _mk_batch(rng, n):
    return TransitionBatch(
        rng.random((n, OD)).astype(np.float32),
        rng.random((n, AD)).astype(np.float32),
        rng.random(n).astype(np.float32),
        rng.random((n, OD)).astype(np.float32),
        (rng.random(n) < 0.1).astype(np.float32),
        np.full(n, 0.99, np.float32))


def _device_rig(arm="scan", seed=42):
    buf = FusedDeviceReplay(CAP, OD, AD, alpha=0.6, device="cpu",
                            gen_tracked=True, block_rows=32)
    ring = DealtBlockRing(4)
    dealer = DeviceSampleDealer(CAP, [ring], k=K, batch_size=B, alpha=0.6,
                                beta_schedule=SharedBetaSchedule(),
                                min_size=8, seed=seed, arm=arm)
    dealer.resync(buf)
    return buf, ring, dealer


def _twin_rig(seed=42):
    buf = PrioritizedReplayBuffer(CAP, OD, AD, alpha=0.6, seed=0)
    ring = DealtBlockRing(4)
    dealer = SampleDealer(CAP, [ring], n_shards=1, k=K, batch_size=B,
                          alpha=0.6, beta_schedule=SharedBetaSchedule(),
                          min_size=8, seed=seed, scheme="device")
    dealer.resync(buf)
    return buf, ring, dealer


def _jax_rig(arm, seed=42):
    buf = JaxFused(CAP, OD, AD, alpha=0.6, gen_tracked=True, block_rows=32)
    ring = JaxRing(4)
    dealer = JaxDealer(CAP, [ring], k=K, batch_size=B, alpha=0.6,
                       beta_schedule=JaxBeta(), min_size=8, seed=seed,
                       arm=arm, interpret=True)
    dealer.resync(buf)
    return buf, ring, dealer


# --------------------------------------------- the seeded-stream oracle


@pytest.mark.parametrize("arm", ["scan", "pallas"])
def test_device_dealer_bitwise_equals_twin_and_matches_reference(rng, arm):
    dbuf, _, dd = _device_rig(arm)
    hbuf, _, hd = _twin_rig()
    jbuf, _, jd = _jax_rig(arm)
    dealt_total = 0
    for step in range(6):
        batch = _mk_batch(rng, 10)
        dealt_d = dd.ingest_and_deal([(dbuf.add(batch), None, None)], dbuf)
        dealt_h = hd.ingest_and_deal([(hbuf.add(batch), None, None)], hbuf)
        dealt_j = jd.ingest_and_deal(
            [(jbuf.add(JaxBatch(*batch)), None, None)], jbuf)
        assert len(dealt_d) == len(dealt_h) == len(dealt_j)
        for (_, bd), (_, bh), (_, bj) in zip(dealt_d, dealt_h, dealt_j):
            idx = bd.idx.numpy()
            np.testing.assert_array_equal(idx, bh.idx)
            np.testing.assert_array_equal(bd.weights.numpy(), bh.weights)
            np.testing.assert_array_equal(bd.gen.numpy(), bh.gen)
            assert bd.beta == bh.beta and bd.step == bh.step
            for da, ha in zip(bd.batches, bh.batches):
                np.testing.assert_array_equal(da.numpy(), ha)
            # across the packages
            np.testing.assert_array_equal(idx, np.asarray(bj.idx))
            np.testing.assert_array_equal(bd.gen.numpy(), np.asarray(bj.gen))
            assert bd.beta == bj.beta and bd.step == bj.step
            for da, ja in zip(bd.batches, bj.batches):
                np.testing.assert_array_equal(da.numpy(), np.asarray(ja))
            np.testing.assert_allclose(bd.weights.numpy(),
                                       np.asarray(bj.weights), rtol=1e-6,
                                       atol=0)
            td = np.random.default_rng(step).uniform(0.1, 2.0, idx.shape)
            dd.queue_writeback(idx, td, bd.gen.numpy())
            hd.queue_writeback(bh.idx, td, bh.gen)
            jd.queue_writeback(np.asarray(bj.idx), td, np.asarray(bj.gen))
            dealt_total += 1
        dd.publish(dealt_d)
        hd.publish(dealt_h)
        jd.publish(dealt_j)
    assert dealt_total >= 4
    # the device trees are the twin's, leaf for leaf
    cap = dbuf.trees.capacity
    np.testing.assert_array_equal(
        dbuf.trees.sum_tree[cap:].numpy(),
        hd._trees.get(np.arange(cap)).astype(np.float32))
    np.testing.assert_array_equal(
        dbuf.trees.sum_tree.numpy(), np.asarray(jbuf.trees.sum_tree))
    for d in (dd, hd, jd):
        d.close()


def test_twin_trees_match_f64_legacy_on_dyadic_priorities(rng):
    t32 = ShardSlicePerTrees(CAP, 1, dtype=np.float32)
    t64 = ShardSlicePerTrees(CAP, 1)
    idx = np.arange(CAP)
    pri = rng.integers(1, 1024, size=CAP).astype(np.float64) / 16.0
    t32.set(idx, pri)
    t64.set(idx, pri)
    assert t32.total() == t64.total()
    mass = (rng.integers(0, int(t64.total() * 16), size=256)
            .astype(np.float64) / 16.0)
    np.testing.assert_array_equal(t32.find_prefixsum(mass),
                                  t64.find_prefixsum(mass))


def test_block_weights_match_reference_and_the_twin_formula(rng):
    total = np.float32(37.25)
    min_root = np.float32(0.125)
    leaf = rng.uniform(0.125, 3.0, (K, B)).astype(np.float32)
    for beta in (0.4, 0.5, 0.731, 1.0):
        got = dper.block_weights(torch.tensor(total), torch.tensor(min_root),
                                 torch.from_numpy(leaf), beta, 100).numpy()
        want = np.asarray(jdper.block_weights(
            jnp.float32(total), jnp.float32(min_root), jnp.asarray(leaf),
            jnp.float32(beta), jnp.int32(100)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert got.max() <= 1.0 + 1e-6


# ------------------------------------- descent edge cases --------------


def _host_ref(values):
    s = SumTree(len(values))
    s.set(np.arange(len(values)), np.asarray(values, np.float64))
    return s


def test_descent_all_zero_priorities():
    cap = 16
    host = _host_ref(np.zeros(cap))
    trees = dper.init(cap, "cpu")
    mass = torch.tensor([0.0, 0.5, 1.0])
    got = descend(trees.sum_tree, mass).numpy()
    np.testing.assert_array_equal(got, host.find_prefixsum(mass.numpy()))
    np.testing.assert_array_equal(got, [cap - 1] * 3)
    clamped = dper.sample_from_uniforms(trees, torch.zeros(3), 5)
    assert int(clamped.max()) <= 4


def test_descent_capacity_boundary_wraparound(rng):
    buf = FusedDeviceReplay(12, OD, AD, alpha=0.6, device="cpu",
                            gen_tracked=True, block_rows=8)
    jbuf = JaxFused(12, OD, AD, alpha=0.6, gen_tracked=True, block_rows=8)
    filler = _mk_batch(rng, 8)
    slots = []
    for _ in range(2):  # 16 rows into 12 slots: the second block wraps
        slots.append(buf.add(filler))
        np.testing.assert_array_equal(slots[-1], jbuf.add(JaxBatch(*filler)))
        buf.drain()
        jbuf.drain()
    assert slots[1][-1] < slots[1][0]
    p = float(buf.max_priority) ** 0.6
    host = np.zeros(buf.trees.capacity)
    host[np.concatenate(slots) % 12] = np.float32(p)
    ref = _host_ref(host)
    mass = (rng.random(64) * ref.sum()).astype(np.float32)
    got = descend(buf.trees.sum_tree, torch.from_numpy(mass)).numpy()
    np.testing.assert_array_equal(got, ref.find_prefixsum(mass))
    wrapped = slots[1][slots[1] < slots[1][0]]
    assert (buf.gen.numpy()[wrapped] == 2).all()
    np.testing.assert_array_equal(buf.gen.numpy(), np.asarray(jbuf.gen))
    np.testing.assert_array_equal(buf.generation, jbuf.generation)
    np.testing.assert_array_equal(buf.trees.sum_tree.numpy(),
                                  np.asarray(jbuf.trees.sum_tree))
    assert buf.size == 12


def test_descent_single_leaf_tree():
    host = _host_ref([3.0])
    trees = dper.set_leaves(dper.init(1, "cpu"), torch.tensor([0]),
                            torch.tensor([3.0]))
    mass = torch.tensor([0.0, 1.5, 2.999])
    got = descend(trees.sum_tree, mass).numpy()
    np.testing.assert_array_equal(got, host.find_prefixsum(mass.numpy()))
    np.testing.assert_array_equal(got, [0, 0, 0])


def test_descent_tie_rule_on_duplicate_prefixes():
    vals = [1.0, 0.0, 0.0, 1.0]
    host = _host_ref(vals)
    trees = dper.set_leaves(dper.init(4, "cpu"), torch.arange(4),
                            torch.tensor(vals))
    mass = torch.tensor([0.0, 0.5, 1.0, 1.5])
    got = descend(trees.sum_tree, mass).numpy()
    np.testing.assert_array_equal(got, host.find_prefixsum(mass.numpy()))
    np.testing.assert_array_equal(got, [0, 0, 3, 3])


# ------------------------------------- write-back fencing, device tree


def test_generation_fenced_writeback_lands_in_device_tree(rng):
    buf, _ring, dealer = _device_rig()
    dealer.ingest_and_deal([(buf.add(_mk_batch(rng, 16)), None, None)], buf)
    live_slot, stale_slot = 3, 7
    gen = buf.gen.numpy()
    dealer.queue_writeback(np.array([stale_slot]), np.array([9.0]),
                           np.array([gen[stale_slot] - 1]))
    # duplicates of one slot: the last queued value wins
    dealer.queue_writeback(np.array([live_slot, live_slot]),
                           np.array([5.0, 2.0]),
                           np.array([gen[live_slot]] * 2))
    dealer.ingest_and_deal((), buf)  # the idle tick settles the queue
    cap = buf.trees.capacity
    leaf = buf.trees.sum_tree.numpy()[cap + live_slot]
    assert leaf == np.float32(2.0 ** 0.6)  # host pow, cast float32
    assert buf.trees.sum_tree.numpy()[cap + stale_slot] == np.float32(1.0)
    assert dealer.writeback_dropped_stale == 1
    assert dealer.max_priority == pytest.approx(5.0)
    assert buf.max_priority == pytest.approx(5.0)
    leaves = buf.trees.sum_tree.numpy()[cap:].astype(np.float64).sum()
    assert abs(float(buf.trees.sum_tree[1]) - leaves) <= 1e-5 * leaves
    dealer.close()


def test_gen_tracked_buffer_assigns_slots_and_refuses_misuse(rng):
    buf = FusedDeviceReplay(CAP, OD, AD, device="cpu", gen_tracked=True,
                            block_rows=32)
    s1 = buf.add(_mk_batch(rng, 5))
    s2 = buf.add(_mk_batch(rng, 3))
    np.testing.assert_array_equal(np.concatenate([s1, s2]), np.arange(8))
    assert len(buf.add(_mk_batch(rng, 0))) == 0
    assert buf.size == 0 and len(buf) == 8  # staged rows count
    assert buf.drain() == 8 and buf.size == 8
    np.testing.assert_array_equal(buf.gen.numpy()[:8], 1)
    with pytest.raises(RuntimeError, match="staging overflow"):
        buf.add(_mk_batch(rng, CAP + 1))
    with pytest.raises(ValueError, match="prioritized"):
        FusedDeviceReplay(CAP, OD, AD, device="cpu", prioritized=False,
                          gen_tracked=True)
    with pytest.raises(ValueError, match="ingest_shards"):
        FusedDeviceReplay(CAP, OD, AD, device="cpu", gen_tracked=True,
                          ingest_shards=2)
    with pytest.raises(ValueError, match="gen_tracked"):
        DeviceSampleDealer(CAP, [], k=K, batch_size=B).resync(
            FusedDeviceReplay(CAP, OD, AD, device="cpu"))
    with pytest.raises(ValueError, match="unknown device sampler arm"):
        DeviceSampleDealer(CAP, [], k=K, batch_size=B, arm="host")


def test_device_ring_clear_releases_dropped_blocks(rng):
    import weakref

    buf, ring, dealer = _device_rig()
    dealer.publish(dealer.ingest_and_deal(
        [(buf.add(_mk_batch(rng, 16)), None, None)], buf))
    assert ring.depth() > 0, "the dealer never dealt"
    refs = [weakref.ref(t) for blk in list(ring._q)
            for t in (*blk.batches, blk.weights, blk.idx, blk.gen)]
    assert ring.clear() > 0
    assert all(r() is None for r in refs)  # released at the clear
    assert buf.trees.sum_tree.numel() == 2 * buf.trees.capacity
    dealer.close()


# ------------------------------------------- autotune arbitration ------


def test_select_sampler_policy_and_validation():
    r = at.select_sampler("auto", capacity=CAP, k=K, batch_size=B,
                          device="cpu")
    assert r.selected == "host" and r.timings_ms is None
    for arm in at.SAMPLER_ARMS:
        assert at.select_sampler(arm, capacity=CAP, k=K,
                                 batch_size=B).selected == arm
    with pytest.raises(ValueError, match="unknown --sampler arm"):
        at.select_sampler("einsum", capacity=CAP, k=K, batch_size=B)
    timed = at.autotune_sampler(CAP, K, B, repeats=1, iters=2, device="cpu")
    assert set(timed.timings_ms) == {"scan", "pallas"}
    assert timed.selected in ("scan", "pallas")


def test_autotune_block_carries_both_surfaces():
    at.select_projection("einsum", batch_size=B, v_min=0.0, v_max=1.0,
                         n_atoms=11, device="cpu")
    at.select_sampler("scan", capacity=CAP, k=K, batch_size=B)
    blk = at.autotune_block()
    assert blk["metric"] == "autotune" and blk["schema"] == 1
    for surface in ("projection", "sampler"):
        assert set(blk["surfaces"][surface]) == {"selected", "reason",
                                                 "timings_ms"}
    assert blk["surfaces"]["sampler"]["selected"] == "scan"


def test_reference_auto_policy_off_tpu_is_host():
    from d4pg_tpu.ops import autotune as jat

    assert jax.default_backend() == "cpu"
    assert jat.select_sampler("auto", capacity=CAP, k=K,
                              batch_size=B).selected == at.select_sampler(
        "auto", capacity=CAP, k=K, batch_size=B, device="cpu").selected
