"""Port vs reference: the in-process learner plane
(``d4pg_tpu_torch/learner/aggregator.py``, ``learner/replica.py``).

The aggregator against the reference's on the same submissions (torch
CPU tensors on the port's side, numpy on the reference's), bitwise: a
lag-0 submission adopted whole, the stale-correction arithmetic, the
clip floor, the basis rules, a basis from the future, the sync barrier's
float64 average, a fenced replica releasing the survivors, epoch and
generation fences, the monotone ledger and the ``learner`` provider.
Then the replicas: one replica through the aggregator bitwise equal to
the port's ``FusedLoop``; the N = 1 dealt replica bitwise equal to the
N = 1 host replica; replica state copies (no shared tensor, replica 0
continuing the state's generator); a respawn fencing the dead epoch; two
host replicas training through the aggregator. And the lock hierarchy:
every tier the port declares has the reference's value.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.core import locking as jlocking
from d4pg_tpu.distributed.weights import WeightStore as JaxStore
from d4pg_tpu.learner.aggregator import Aggregator as JaxAggregator
from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.learner.aggregator import Aggregator
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.learner.replica import (
    PARAM_FIELDS,
    LearnerReplica,
    params_of,
    replica_generator_seed,
    replica_state,
)
from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.sampler import SampleDealer
from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
from d4pg_tpu_torch.replay.staging import DealtBlockRing
from d4pg_tpu_torch.replay.uniform import TransitionBatch

pytestmark = pytest.mark.torchport


def _params(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((4, 3))).astype(np.float32),
            "b": (scale * rng.standard_normal(3)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


class _Pair:
    """The port's and the reference's aggregators fed the same calls."""

    def __init__(self, mode="async", clip=8.0):
        self.t = Aggregator(WeightStore(), mode=mode, clip=clip)
        self.j = JaxAggregator(JaxStore(), mode=mode, clip=clip)

    def register(self, rid, params=None):
        et = self.t.register(rid, params=None if params is None
                             else _t(params))
        ej = self.j.register(rid, params=params)
        assert et == ej
        return et

    def submit(self, rid, epoch, params, basis, **kw):
        rt = self.t.submit(rid, epoch, _t(params), basis, **kw)
        rj = self.j.submit(rid, epoch, params, basis, **kw)
        assert rt == rj
        return rt

    def basis(self, rid):
        vt, bt = self.t.basis(rid)
        vj, bj = self.j.basis(rid)
        assert vt == vj and (bt is None) == (bj is None)
        return vt

    def assert_current_equal(self):
        vt, ct = self.t.current()
        vj, cj = self.j.current()
        assert vt == vj
        for k in cj:
            assert ct[k].dtype == torch.float32
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
        return ct

    def close(self):
        self.t.close()
        self.j.close()


def test_bad_mode_and_clip_rejected():
    with pytest.raises(ValueError):
        Aggregator(WeightStore(), mode="hogwild")
    with pytest.raises(ValueError):
        Aggregator(WeightStore(), clip=0.5)


def test_lag0_adopted_wholesale_bitwise(rng):
    agg = _Pair()
    epoch = agg.register(0, _params(rng))
    sub = _params(rng)
    res = agg.submit(0, epoch, sub, agg.basis(0))
    assert res == {"status": "applied", "version": 1, "lag": 0,
                   "weight": 1.0, "clipped": False}
    cur = agg.assert_current_equal()
    for k in sub:
        np.testing.assert_array_equal(cur[k].numpy(), sub[k])
    # the store got the aggregate (a copy of it)
    _, pub = agg.t._store.get()
    np.testing.assert_array_equal(pub["w"].numpy(), sub["w"])
    agg.close()


def test_stale_correction_arithmetic(rng):
    agg = _Pair()
    e0 = agg.register(0, _params(rng))
    e1 = agg.register(1)
    b1 = agg.basis(1)
    agg.submit(0, e0, _params(rng), agg.basis(0))
    before = {k: v.clone() for k, v in agg.t.current()[1].items()}
    sub = _params(rng)
    res = agg.submit(1, e1, sub, b1)
    assert res["status"] == "applied" and res["lag"] == 1
    assert res["weight"] == pytest.approx(0.5) and not res["clipped"]
    cur = agg.assert_current_equal()
    for k in sub:
        b = before[k].numpy()
        np.testing.assert_array_equal(
            cur[k].numpy(), (b + np.float32(0.5) * (sub[k] - b)))
    agg.close()


def test_clip_floor_bounds_very_stale_updates(rng):
    agg = _Pair(clip=2.0)
    e0 = agg.register(0, _params(rng))
    e1 = agg.register(1)
    b1 = agg.basis(1)
    for _ in range(5):
        agg.submit(0, e0, _params(rng), agg.basis(0))
    res = agg.submit(1, e1, _params(rng), b1)
    assert res["lag"] == 5 and res["weight"] == pytest.approx(0.5)
    assert res["clipped"] is True
    agg.assert_current_equal()
    snap, jsnap = agg.t._snapshot(), agg.j._snapshot()
    assert snap["clip_rate"] == jsnap["clip_rate"] == pytest.approx(
        1 / 6, abs=1e-4)
    assert snap["replicas"] == jsnap["replicas"]
    agg.close()


def test_basis_never_serves_own_submission(rng):
    agg = _Pair()
    epoch = agg.register(0, _params(rng))
    assert agg.basis(0) == 0 and agg.t.basis(0)[1] is None
    agg.submit(0, epoch, _params(rng), 0)
    assert agg.basis(0) == 1 and agg.t.basis(0)[1] is None
    e1 = agg.register(1)
    agg.submit(1, e1, _params(rng), agg.basis(1))
    assert agg.basis(0) == 2 and agg.t.basis(0)[1] is not None
    agg.close()


def test_future_basis_is_a_protocol_breach(rng):
    agg = _Pair()
    epoch = agg.register(0, _params(rng))
    res = agg.submit(0, epoch, _params(rng), basis=7)
    assert res["status"] == "fenced" and res["lag"] == -7
    agg.close()


def test_sync_barrier_averages_in_float64(rng):
    a, b = _params(rng), _params(rng)
    results = {}
    for name, agg in (("port", Aggregator(WeightStore(), mode="sync")),
                      ("ref", JaxAggregator(JaxStore(), mode="sync"))):
        conv = _t if name == "port" else (lambda x: x)
        e0 = agg.register(0, params=conv(_params(rng)))
        e1 = agg.register(1)
        out = {}

        def worker(rid, epoch, sub, agg=agg, out=out):
            out[rid] = agg.submit(rid, epoch, sub, agg.basis(rid)[0])

        t = threading.Thread(target=worker, args=(0, e0, conv(a)),
                             daemon=True)
        t.start()
        time.sleep(0.1)  # replica 0 waits on the barrier
        worker(1, e1, conv(b))
        t.join(timeout=5.0)
        assert not t.is_alive()
        for rid in (0, 1):
            assert out[rid]["status"] == "applied"
            assert out[rid]["version"] == 1  # one publish for the round
        results[name] = agg.current()[1]
        agg.close()
    for k in a:
        want = ((a[k].astype(np.float64) + b[k].astype(np.float64))
                / 2).astype(np.float32)
        np.testing.assert_array_equal(results["port"][k].numpy(), want)
        np.testing.assert_array_equal(np.asarray(results["ref"][k]), want)


def test_sync_fence_releases_survivor_sole_contributor_exact(rng):
    agg = Aggregator(WeightStore(), mode="sync")
    e0 = agg.register(0, params=_t(_params(rng)))
    agg.register(1)
    sub = _t(_params(rng))
    out = {}
    t = threading.Thread(target=lambda: out.update(
        r=agg.submit(0, e0, sub, agg.basis(0)[0])), daemon=True)
    t.start()
    time.sleep(0.1)
    agg.fence_replica(1)  # the kill unwedges the round
    t.join(timeout=5.0)
    assert not t.is_alive() and out["r"]["status"] == "applied"
    for k in sub:
        assert torch.equal(agg.current()[1][k], sub[k])
    agg.close()


def test_epoch_and_generation_fencing(rng):
    agg = _Pair()
    epoch = agg.register(0, _params(rng))
    assert agg.t.live_epoch(0) == epoch
    agg.t.fence_replica(0)
    agg.j.fence_replica(0)
    assert agg.t.live_epoch(0) is None
    assert agg.submit(0, epoch, _params(rng), 0)["status"] == "fenced"
    epoch2 = agg.register(0)
    assert epoch2 == epoch + 1
    res = agg.submit(0, epoch2, _params(rng), agg.basis(0), generation=99)
    assert res["status"] == "fenced"
    assert agg.t.counters() == agg.j.counters()
    assert agg.t.counters()["fenced"] == 2
    agg.close()


def test_ledger_monotone_across_fences(rng):
    agg = Aggregator(WeightStore())
    epoch = agg.register(0, params=_t(_params(rng)))
    for _ in range(3):
        agg.submit(0, epoch, _t(_params(rng)), agg.basis(0)[0])
        agg.fence_replica(0)
        epoch = agg.register(0)
    assert [v for _g, v in agg.ledger()] == [1, 2, 3]
    assert agg.ledger_monotone() is True
    agg._ledger.append((0, 2))  # a rewind
    assert agg.ledger_monotone() is False
    agg.close()


def test_learner_provider_exported(rng):
    agg = Aggregator(WeightStore())
    epoch = agg.register(0, params=_t(_params(rng)))
    agg.submit(0, epoch, _t(_params(rng)), agg.basis(0)[0])
    snap = REGISTRY.export().get("learner")
    assert snap["mode"] == "async" and snap["version"] == 1
    assert snap["live_replicas"] == 1 and snap["applied"] == 1
    assert snap["replicas"]["0"]["submits"] == 1
    assert snap["staleness"]["count"] == 1
    agg.close()
    assert "learner" not in REGISTRY.export()


# ------------------------------------------------- the replicas ---------

OBS, ACT = 5, 2
CONFIG = D4PGConfig(obs_dim=OBS, act_dim=ACT, v_min=-10, v_max=10,
                    n_atoms=11, hidden=(16, 16))


def _rows(rng, n):
    return TransitionBatch(
        obs=rng.standard_normal((n, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, OBS)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32))


def _assert_states_equal(a, b):
    for m in ("actor", "critic", "target_actor", "target_critic"):
        for (ka, ta), (kb, tb) in zip(getattr(a, m).state_dict().items(),
                                      getattr(b, m).state_dict().items()):
            assert ka == kb
            assert torch.equal(ta, tb), (m, ka)
    assert a.step == b.step


def test_n1_through_aggregator_bitwise_equals_fused_loop(rng):
    N, STEPS = 96, 4
    batch = _rows(rng, N)

    def fill():
        buf = FusedDeviceReplay(N, OBS, ACT, alpha=0.6, device="cpu")
        buf.add(batch)
        buf.drain()
        return buf

    legacy_state = init_state(CONFIG, 0, "cpu")
    FusedLoop(CONFIG, fill(), k=2, batch_size=8,
              generator=torch.Generator().manual_seed(3)).run(
        legacy_state, STEPS)
    agg = Aggregator(WeightStore())
    rep = LearnerReplica(0, CONFIG, agg, init_state(CONFIG, 0, "cpu"), k=2,
                         batch_size=8, buffer=fill(),
                         generator=torch.Generator().manual_seed(3))
    res = rep.run_round(STEPS)
    assert res["status"] == "applied" and res["lag"] == 0
    assert rep.mode == "fused" and rep.steps_done == STEPS
    _assert_states_equal(legacy_state, rep.state)
    _v, cur = agg.current()
    want = params_of(legacy_state)
    for f in PARAM_FIELDS:
        for k, v in want[f].items():
            assert torch.equal(cur[f][k], v)
    rep.close()
    agg.close()


def test_n1_dealt_replica_bitwise_equals_host_replica(rng):
    """One replica on dealt blocks lands bit for bit the state of one
    host-sampled replica over a twin service, in pause/resume lockstep
    with a one-block ring (each side's write-back settles before its
    next draw, the host path's order)."""
    CAP, K, B, SEED, ROUNDS = 256, 2, 8, 5, 3
    blocks = [_rows(rng, 48) for _ in range(2)]
    svc_h = ReplayService(PrioritizedReplayBuffer(CAP, OBS, ACT, alpha=0.6,
                                                  seed=SEED))
    svc_d = ReplayService(PrioritizedReplayBuffer(CAP, OBS, ACT, alpha=0.6,
                                                  seed=SEED))
    ring = DealtBlockRing(capacity=1)
    dealer = SampleDealer(CAP, [ring], n_shards=1, k=K, batch_size=B,
                          alpha=0.6,
                          beta_schedule=SharedBetaSchedule(0.4, 1000),
                          seed=SEED, ring_capacity=1)
    dealer.pause_dealing()
    svc_d.attach_dealer(dealer)
    agg_h, agg_d = Aggregator(WeightStore()), Aggregator(WeightStore())
    try:
        for b in blocks:
            svc_h.add(b, actor_id="oracle")
            svc_d.add(b, actor_id="oracle")
        svc_h.flush(timeout=10.0)
        svc_d.flush(timeout=10.0)
        rep_h = LearnerReplica(0, CONFIG, agg_h,
                               init_state(CONFIG, 0, "cpu"), k=K,
                               batch_size=B, service=svc_h,
                               beta_schedule=SharedBetaSchedule(0.4, 1000))
        rep_d = LearnerReplica(0, CONFIG, agg_d,
                               init_state(CONFIG, 0, "cpu"), k=K,
                               batch_size=B, service=svc_d, dealt_ring=ring,
                               beta_schedule=SharedBetaSchedule(0.4, 1000))
        assert rep_h.mode == "host" and rep_d.mode == "dealt"
        for _ in range(ROUNDS):
            dealer.resume_dealing()
            deadline = time.monotonic() + 5.0
            while ring.depth() == 0:
                assert time.monotonic() < deadline, "no block dealt"
                time.sleep(0.01)
            dealer.pause_dealing()
            rep_d.run_round(K)
            rep_h.run_round(K)
        _assert_states_equal(rep_h.state, rep_d.state)
        assert rep_h.steps_done == rep_d.steps_done == ROUNDS * K
        rep_h.close()
        rep_d.close()
    finally:
        agg_h.close()
        agg_d.close()
        svc_h.close()
        svc_d.close()


def test_replica_state_copies_share_no_tensor():
    state = init_state(CONFIG, 0, "cpu")
    state.generator.manual_seed(123)
    r0, r1 = replica_state(state, 0, 7), replica_state(state, 1, 7)
    mods = ("actor", "critic", "target_actor", "target_critic")
    ptrs = {t.data_ptr() for m in mods
            for t in getattr(state, m).state_dict().values()}
    for r in (r0, r1):
        _assert_states_equal(state, r)
        for m in mods:
            for t in getattr(r, m).state_dict().values():
                assert t.data_ptr() not in ptrs
        # the optimizer steps the replica's own parameters
        own = {id(p) for p in r.actor.parameters()}
        assert {id(p) for g in r.actor_opt.param_groups
                for p in g["params"]} == own
    # replica 0 continues the state's stream; replica 1 has its own
    want = torch.rand(4, generator=state.generator)
    assert torch.equal(torch.rand(4, generator=r0.generator), want)
    gen1 = torch.Generator().manual_seed(replica_generator_seed(7, 1))
    assert torch.equal(torch.rand(4, generator=r1.generator),
                       torch.rand(4, generator=gen1))
    assert replica_generator_seed(7, 1) != replica_generator_seed(7, 2)


def test_respawn_fences_the_dead_epoch(rng):
    svc = ReplayService(PrioritizedReplayBuffer(128, OBS, ACT, seed=0))
    agg = Aggregator(WeightStore())
    try:
        svc.add(_rows(rng, 64))
        svc.flush(timeout=10.0)
        rep = LearnerReplica(0, CONFIG, agg, init_state(CONFIG, 0, "cpu"),
                             k=2, batch_size=8, service=svc)
        dead = rep.epoch
        assert rep.respawn() == dead + 1
        res = agg.submit(0, dead, params_of(rep.state), agg.basis(0)[0])
        assert res["status"] == "fenced"
        assert rep.run_round(2)["status"] == "applied"
        assert rep.stats()["applied"] == 1 and rep.stats()["epoch"] == dead + 1
        rep.close()
    finally:
        agg.close()
        svc.close()


def test_two_host_replicas_train_through_the_aggregator(rng):
    svc = ReplayService(PrioritizedReplayBuffer(256, OBS, ACT, seed=0))
    store = WeightStore()
    agg = Aggregator(store, extract=lambda t: t["actor_params"])
    sched = SharedBetaSchedule(0.4, 1000)
    state = init_state(CONFIG, 0, "cpu")
    try:
        svc.add(_rows(rng, 128))
        svc.flush(timeout=10.0)
        reps = [LearnerReplica(i, CONFIG, agg, replica_state(state, i, 0),
                               k=2, batch_size=8, service=svc,
                               beta_schedule=sched) for i in range(2)]
        for _ in range(2):
            threads = [threading.Thread(target=r.run_round, args=(4,))
                       for r in reps]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
                assert not t.is_alive()
        assert all(r.steps_done == 8 for r in reps)
        assert sched.current_step() == 16
        assert agg.counters()["applied"] == 4 and agg.ledger_monotone()
        version, actor = store.get()
        assert version == 4 and set(actor) == set(
            state.actor.state_dict())
        for r in reps:
            r.close()
    finally:
        agg.close()
        svc.close()


def test_lock_tiers_match_the_reference():
    for name, tier in locking.HIERARCHY.items():
        assert jlocking.HIERARCHY[name] == tier, name
    for name in ("replica", "agg", "pserve", "sampler"):
        assert name in locking.HIERARCHY
    # the declared descents of the new planes
    order = [locking.HIERARCHY[n] for n in
             ("buffer", "replica", "agg", "wserve", "pserve", "wstore",
              "shard", "sampler", "ring")]
    assert order == sorted(order, reverse=True)
