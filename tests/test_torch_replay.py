"""Port vs reference: the host-sampled replay path's buffers and trees.

The same seeded random op sequences (adds, samples, chunk samples,
priority write-backs with and without generations, state_dict round
trips) go through the port's and the reference's ``SumTree`` /
``MinTree``, ``ReplayBuffer`` and ``PrioritizedReplayBuffer``; slots, IS
weights, rows and trees must agree bitwise. The port runs its ring in
host RAM and as a device ring on the CPU, and its trees in numpy and in
C++ (``replay/native.py``); the reference runs its numpy trees (its
native backend would build into the JAX package's own directory). Then
the port's device trees (``replay/device_per.py``) held to the port's
host trees under a random op sequence, as
``tests/test_device_per.py::test_device_trees_match_host_under_random_op_sequences``
holds the reference's. Small sizes: capacity 50 (trees of 64 leaves),
obs 3, act 2.
"""

import math

import numpy as np
import pytest
import torch

from d4pg_tpu.replay import prioritized as jper
from d4pg_tpu.replay import segment_tree as jtree
from d4pg_tpu.replay import uniform as juniform
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay import prioritized as tper
from d4pg_tpu_torch.replay import segment_tree as ttree
from d4pg_tpu_torch.replay import uniform as tuniform

pytestmark = pytest.mark.torchport

CAP, OBS, ACT = 50, 3, 2


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(rng, n):
    done = (rng.random(n) < 0.2).astype(np.float32)
    return dict(
        obs=rng.standard_normal((n, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, OBS)).astype(np.float32),
        done=done, discount=(0.99 * (1 - done)).astype(np.float32))


def _assert_rows(port, ref, what):
    for name, t, j in zip(juniform.TransitionBatch._fields, port, ref):
        np.testing.assert_array_equal(_host(t), np.asarray(j),
                                      err_msg=f"{what} {name}")


@pytest.mark.parametrize("cap", [1, 50, 64, 1000])
def test_segment_trees_bitwise_under_random_ops(rng, cap):
    ts, tm = ttree.SumTree(cap), ttree.MinTree(cap)
    js, jm = jtree.SumTree(cap), jtree.MinTree(cap)
    assert ts.capacity == js.capacity == ttree.next_pow2(cap)
    for _ in range(20):
        n = int(rng.integers(1, 3 * cap + 1))
        idx = rng.integers(0, cap, n)  # duplicates: the last one wins
        vals = rng.random(n) * rng.choice([1e-3, 1.0, 1e3])
        for tree in (ts, tm, js, jm):
            tree.set(idx, vals)
        np.testing.assert_array_equal(ts.tree, js.tree)
        np.testing.assert_array_equal(tm.tree, jm.tree)
        assert ts.sum() == js.sum() and tm.min() == jm.min()
        mass = rng.uniform(0, ts.sum(), 33)
        mass[:3] = [0.0, ts.sum(), ts.tree[min(2, cap)]]  # ends, a left sum
        np.testing.assert_array_equal(ts.find_prefixsum(mass),
                                      js.find_prefixsum(mass))
        probe = rng.integers(0, cap, 9)
        np.testing.assert_array_equal(ts.get(probe), js.get(probe))


@pytest.mark.parametrize("storage", ["host", "device"])
def test_uniform_buffer_bitwise_under_random_ops(rng, storage):
    port = tuniform.ReplayBuffer(CAP, OBS, ACT, seed=3, storage=storage,
                                 device="cpu")
    ref = juniform.ReplayBuffer(CAP, OBS, ACT, seed=3)
    with pytest.raises(ValueError, match="empty"):
        port.sample(4)
    for step in range(30):
        op = int(rng.integers(4)) if step else 0
        if op == 0:
            rows = _rows(rng, int(rng.integers(1, 2 * CAP // 3)))
            np.testing.assert_array_equal(
                port.add(tuniform.TransitionBatch(**rows)),
                ref.add(juniform.TransitionBatch(**rows)))
            assert (len(port), port.head) == (len(ref), ref.head)
        elif op == 1:
            _assert_rows(port.sample(8), ref.sample(8), "sample")
        elif op == 2:
            tb, tw, ti = port.sample_chunk(3, 5)
            jb, jw, ji = ref.sample_chunk(3, 5)
            assert tw is None and jw is None
            np.testing.assert_array_equal(ti, ji)
            _assert_rows(tb, jb, "chunk")
            assert _host(tb.obs).shape == (3, 5, OBS)
        else:
            state = port.state_dict()
            ref_state = ref.state_dict()
            assert (state["head"], state["size"], state["capacity"]) == (
                ref_state["head"], ref_state["size"], ref_state["capacity"])
            for name in juniform.TransitionBatch._fields:
                np.testing.assert_array_equal(state["rows"][name],
                                              ref_state["rows"][name])
            fresh = tuniform.ReplayBuffer(CAP, OBS, ACT, storage=storage,
                                          device="cpu")
            fresh.load_state_dict(state)
            _assert_rows(fresh.gather(np.arange(len(ref))),
                         ref.gather(np.arange(len(ref))), "restored")
    with pytest.raises(ValueError, match="capacity"):
        tuniform.ReplayBuffer(CAP + 1, OBS, ACT).load_state_dict(
            port.state_dict())


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("storage", ["host", "device"])
def test_prioritized_buffer_bitwise_under_random_ops(rng, storage, backend):
    """Adds (wrapping the ring), stratified samples and chunks, IS weights
    (with and without a global weight base), write-backs with stale
    generations and with duplicate slots, and a state_dict round trip."""
    port = tper.PrioritizedReplayBuffer(CAP, OBS, ACT, alpha=0.6, seed=11,
                                        backend=backend, storage=storage,
                                        device="cpu")
    ref = jper.PrioritizedReplayBuffer(CAP, OBS, ACT, alpha=0.6, seed=11,
                                       backend="numpy")
    assert port.tree_backend == backend
    taken = []  # (idx, generation) snapshots for later write-backs
    for step in range(60):
        op = int(rng.integers(5)) if step > 1 else 0
        if op == 0:
            rows = _rows(rng, int(rng.integers(1, CAP // 2)))
            np.testing.assert_array_equal(
                port.add(tper.TransitionBatch(**rows)),
                ref.add(jper.TransitionBatch(**rows)))
            np.testing.assert_array_equal(port.generation, ref.generation)
        elif op == 1:
            beta = float(rng.uniform(0.3, 1.0))
            tb, tw, ti = port.sample(16, beta=beta)
            jb, jw, ji = ref.sample(16, beta=beta)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tw, jw)
            assert tw.dtype == np.float32
            _assert_rows(tb, jb, "sample")
            taken.append((ti, port.generation[ti].copy()))
        elif op == 2:
            base = (None if rng.integers(2) else
                    0.5 * port.weight_base())
            assert port.weight_base() == ref.weight_base()
            tb, tw, ti = port.sample_chunk(3, 8, beta=0.5, weight_base=base)
            jb, jw, ji = ref.sample_chunk(3, 8, beta=0.5, weight_base=base)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tw, jw)
            _assert_rows(tb, jb, "chunk")
            taken.append((ti, port.generation[ti].copy()))
        elif op == 3 and taken:
            idx, gen = taken.pop(int(rng.integers(len(taken))))
            prio = (np.abs(rng.standard_normal(idx.shape)) + 1e-6
                    ).astype(np.float32)
            use_gen = bool(rng.integers(4))
            port.update_priorities(idx, prio, gen if use_gen else None)
            ref.update_priorities(idx, prio, gen if use_gen else None)
            assert port.max_priority == ref.max_priority
        else:
            state, ref_state = port.state_dict(), ref.state_dict()
            np.testing.assert_array_equal(state["leaf_priorities"],
                                          ref_state["leaf_priorities"])
            np.testing.assert_array_equal(state["generation"],
                                          ref_state["generation"])
            assert state["max_priority"] == ref_state["max_priority"]
            fresh = tper.PrioritizedReplayBuffer(
                CAP, OBS, ACT, alpha=0.6, backend=backend, storage=storage,
                device="cpu")
            fresh.load_state_dict(state)
            live = np.arange(len(ref))
            np.testing.assert_array_equal(fresh._trees.get(live),
                                          ref._trees.get(live))
            assert fresh._trees.sum() == ref._trees.sum()
            assert fresh._trees.min() == ref._trees.min()
        live = np.arange(len(ref))
        np.testing.assert_array_equal(port._trees.get(live),
                                      ref._trees.get(live))
        assert port._trees.sum() == ref._trees.sum()
        assert port._trees.min() == ref._trees.min()


def test_generation_guard_drops_stale_priority_updates():
    """A slot overwritten between sample and write-back keeps its fresh
    priority (``tests/test_replay.py``'s case on the port)."""
    def batch(n, val):
        return tper.TransitionBatch(
            obs=np.full((n, 2), val, np.float32),
            action=np.zeros((n, 1), np.float32),
            reward=np.zeros(n, np.float32),
            next_obs=np.zeros((n, 2), np.float32),
            done=np.zeros(n, np.float32),
            discount=np.full(n, 0.99, np.float32))

    buf = tper.PrioritizedReplayBuffer(8, 2, 1, alpha=1.0, backend="numpy")
    idx0 = buf.add(batch(8, 0.0))
    gen = buf.generation[idx0].copy()
    buf.add(batch(4, 1.0))  # the ring wraps: slots 0..3 hold new rows
    before = buf._trees.get(np.arange(8)).copy()
    buf.update_priorities(idx0, np.full(8, 100.0), generation=gen)
    after = buf._trees.get(np.arange(8))
    np.testing.assert_array_equal(after[:4], before[:4])
    np.testing.assert_allclose(after[4:], 100.0)
    with pytest.raises(ValueError, match="positive"):
        buf.update_priorities(idx0, np.zeros(8))


def test_unknown_storage_and_backend_raise():
    with pytest.raises(ValueError, match="storage"):
        tuniform.ReplayBuffer(8, 2, 1, storage="disk")
    with pytest.raises(ValueError, match="backend"):
        tper.PrioritizedReplayBuffer(8, 2, 1, backend="gpu")


def test_device_trees_match_host_under_random_op_sequences(rng):
    """The port's device trees (float32, here on the CPU) against its host
    trees (float64) under inserts, duplicate-index priority updates and a
    final batch of prefix queries, at the reference test's bars."""
    cap = 64
    s_host, m_host = ttree.SumTree(cap), ttree.MinTree(cap)
    trees = dper.init(cap, "cpu")
    live = 0
    for _ in range(30):
        if rng.integers(2) == 0 or live == 0:  # a block of new slots
            n = int(rng.integers(1, 9))
            idx = np.arange(live, live + n) % cap
            live = min(live + n, cap)
            p = float(trees.max_priority) ** 0.6
            s_host.set(idx, np.full(n, p))
            m_host.set(idx, np.full(n, p))
            trees = dper.insert(trees, torch.from_numpy(idx), 0.6)
        else:  # a priority update with duplicates, one value per slot
            n = int(rng.integers(1, 9))
            idx = rng.integers(0, live, size=n)
            lut = dict(zip(np.unique(idx),
                           rng.uniform(0.5, 4.0, len(np.unique(idx)))))
            pr = np.array([lut[i] for i in idx])
            s_host.set(idx, pr**0.6)
            m_host.set(idx, pr**0.6)
            trees = dper.set_leaves(trees, torch.from_numpy(idx),
                                    torch.from_numpy(pr**0.6).float())
        np.testing.assert_allclose(float(trees.sum_tree[1]), s_host.sum(),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(trees.min_tree[1]), m_host.min(),
                                   rtol=1e-6)
        leaf_idx = np.arange(live)
        np.testing.assert_allclose(
            trees.sum_tree[cap + leaf_idx].numpy(), s_host.get(leaf_idx),
            rtol=1e-5)
    mass = rng.uniform(0, s_host.sum() * 0.999, size=64)
    host_leaves = s_host.find_prefixsum(mass)
    dev_leaves = dper.descend(trees.sum_tree,
                              torch.from_numpy(mass).float()).numpy()
    assert math.log2(cap) == 6
    # float32 against float64 partial sums can disagree exactly at a leaf
    # boundary: off by one leaf there
    assert (np.abs(dev_leaves - host_leaves) <= 1).all()
    assert (dev_leaves == host_leaves).mean() > 0.9
