"""The port's lock-hierarchy sentinels (``d4pg_tpu_torch/core/locking.py``).

The reference's ``tests/test_locking.py`` cases on the port (all but the
static-pass mirror, which belongs to the lint plane): production mode is
plain delegation, debug mode asserts monotone tier descent per thread and
counts contention, record mode counts instead of raising, and the
merge-wedge shape on the port's own service is detected. Then the parts
the drills rest on: the ``locks`` registry provider, ``record_mode``
putting back the mode it found, and each drill counting an ascent that a
thread of its run commits.
"""

import threading
import time

import pytest

from d4pg_tpu.core import locking as jlocking
from d4pg_tpu_torch.core import locking
from d4pg_tpu_torch.core.locking import (
    HIERARCHY, LockHierarchyError, TieredCondition, TieredLock,
)
from torch_lock_modes import debug_mode  # noqa: F401  (a fixture)

pytestmark = [pytest.mark.torchport, pytest.mark.concurrency]


def test_hierarchy_table_shape():
    # outermost first, strictly decreasing: the elastic control plane
    # above everything (the autoscaler may never be climbed INTO from a
    # data-plane lock), the five ingest-plane tiers, the multi-learner
    # pair (replica > aggregator), the weight plane's three (relay >
    # server cache > store), and the serving plane's condition wedged
    # between the weight server and the store
    assert list(HIERARCHY) == ["elastic", "service", "buffer", "replica",
                               "agg", "commit", "wrelay", "wserve",
                               "pserve", "wstore", "shard", "sampler",
                               "ring"]
    tiers = list(HIERARCHY.values())
    assert tiers == sorted(tiers, reverse=True)
    assert len(set(tiers)) == len(tiers)


def test_tiers_are_the_reference_tiers():
    assert HIERARCHY == jlocking.HIERARCHY


def test_descent_is_legal_and_tracked(debug_mode):
    svc, buf, ring = (TieredLock("service"), TieredLock("buffer"),
                      TieredLock("ring"))
    with svc:
        with buf:
            with ring:
                assert [n for _, n in locking.held_tiers()] == [
                    "service", "buffer", "ring"]
    assert locking.held_tiers() == []
    assert locking.violation_count() == 0


def test_sequential_same_tier_is_legal(debug_mode):
    a, b = TieredCondition("shard"), TieredCondition("shard")
    with a:
        pass
    with b:
        pass
    assert locking.violation_count() == 0


def test_inverted_acquisition_raises(debug_mode):
    """The unit acceptance bar: a deliberately inverted acquisition
    (buffer while holding ring — ascent) raises immediately."""
    buf, ring = TieredLock("buffer"), TieredLock("ring")
    with ring:
        with pytest.raises(LockHierarchyError, match="hierarchy violation"):
            buf.acquire()
    assert locking.violation_count() == 1


def test_equal_tier_nesting_raises(debug_mode):
    # two sibling shard conditions held at once: the hidden worker-vs-
    # worker deadlock; strict descent forbids equal tiers too
    a, b = TieredCondition("shard"), TieredCondition("shard")
    with a:
        with pytest.raises(LockHierarchyError):
            b.acquire()


def test_merge_wedge_shape_is_caught(debug_mode):
    """The regression: do commit-cond work while holding a shard leaf
    condition (the shape whose cross-thread interleaving wedges the
    ordered merge) on the port's real service's locks, and assert the
    runtime sentinel catches it."""
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.replay.uniform import ReplayBuffer

    svc = ReplayService(ReplayBuffer(128, 3, 2), num_ingest_shards=2)
    try:
        shard = svc._shards[0]
        with pytest.raises(LockHierarchyError):
            with shard.cond:           # leaf held ...
                with svc._commit_cond:  # ... merge work under it: WEDGE
                    pass
        # ... and the old review bug: settling service accounting
        # (_pending, under _lock) INSIDE the merge condition
        with pytest.raises(LockHierarchyError):
            with svc._commit_cond:
                with svc._lock:
                    pass
        # the shipped discipline itself stays silent: commit-cond then
        # (sequentially) the service lock, exactly as _commit_loop runs
        with svc._commit_cond:
            pass
        with svc._lock:
            pass
    finally:
        locking.disable_debug()  # close() joins threads that wait()
        svc.close()


def test_record_mode_counts_instead_of_raising():
    locking.enable_debug(raise_on_violation=False)
    locking.reset_stats()
    try:
        svc, ring = TieredLock("service"), TieredLock("ring")
        with ring:
            with svc:  # ascent — recorded, not raised
                pass
        assert locking.violation_count() == 1
        assert "hierarchy violation" in locking.hierarchy_violations()[0]
    finally:
        locking.disable_debug()
        locking.reset_stats()


def test_condition_wait_keeps_stack_consistent(debug_mode):
    cond = TieredCondition("commit")
    done = []

    def waiter():
        with cond:
            cond.wait(timeout=0.05)
            done.append(locking.held_tiers())

    t = threading.Thread(target=waiter)
    t.start()
    t.join(timeout=5.0)
    assert done and [n for _, n in done[0]] == ["commit"]
    assert locking.held_tiers() == []  # main thread untouched
    stats = locking.lock_stats()
    assert stats["commit"]["cond_waits"] == 1


def test_contention_counters(debug_mode):
    lock = TieredLock("service")
    lock.acquire()
    seen = []

    def contender():
        with lock:
            seen.append(True)

    t = threading.Thread(target=contender)
    t.start()
    # let the contender hit the held lock, then release
    for _ in range(1000):
        if lock._contended:
            break
        threading.Event().wait(0.001)
    lock.release()
    t.join(timeout=5.0)
    assert seen
    stats = locking.lock_stats()["service"]
    assert stats["acquisitions"] == 2
    assert stats["contended"] == 1
    assert stats["wait_ns"] > 0
    assert stats["max_hold_ns"] > 0


def test_production_mode_is_plain_delegation():
    assert not locking.debug_enabled()
    lock, cond = TieredLock("buffer"), TieredCondition("shard")
    with lock:
        pass
    with cond:
        cond.notify_all()
    # no bookkeeping happened
    assert locking.held_tiers() == []
    assert lock._acquisitions == 0


def test_unknown_tier_rejected():
    with pytest.raises(ValueError):
        TieredLock("no-such-tier")
    custom = TieredLock("custom", tier=99)  # explicit tier escape hatch
    with custom:
        pass


def test_locks_provider_exports_the_counters(debug_mode):
    from d4pg_tpu_torch.obs.registry import REGISTRY

    lock = TieredLock("buffer")
    with lock:
        pass
    block = REGISTRY.export()["locks"]
    assert block["debug"] is True
    assert block["hierarchy_violations"] == 0
    assert block["per_lock"]["buffer"]["acquisitions"] >= 1


def test_record_mode_puts_back_the_mode_it_found():
    assert not locking.debug_enabled()
    with locking.record_mode():
        assert locking.debug_enabled()
        ring, svc = TieredLock("ring"), TieredLock("service")
        before = locking.violation_count()
        with ring:
            with svc:  # recorded, not raised
                pass
        assert locking.violation_count() == before + 1
    assert not locking.debug_enabled()
    locking.enable_debug(raise_on_violation=True)
    try:
        with locking.record_mode():
            pass
        # raise mode came back with the switch
        with TieredLock("ring"):
            with pytest.raises(LockHierarchyError):
                TieredLock("service").acquire()
    finally:
        locking.disable_debug()
        locking.reset_stats()


def test_violation_is_flight_recorded_in_record_mode():
    from d4pg_tpu_torch.obs import flight

    flight.RECORDER.reset()
    with locking.record_mode():
        with TieredLock("shard"):
            with TieredLock("service"):
                pass
    events = [e for e in flight.RECORDER.events()
              if e["kind"] == "lock_violation"]
    assert len(events) == 1 and "acquiring 'service'" in events[0]["msg"]
    locking.reset_stats()


def _ascent_once_armed(timeout: float = 60.0) -> None:
    """Once a run has armed record mode (and read its starting count),
    commit one ascent: a service-tier acquisition under a shard-tier
    hold, the merge-wedge shape."""
    deadline = time.monotonic() + timeout
    while not locking.debug_enabled() and time.monotonic() < deadline:
        time.sleep(0.005)
    time.sleep(0.2)
    with TieredLock("shard"):
        with TieredLock("service"):
            pass


def _drill(name: str, tmp_path) -> int:
    """One short CPU run of a drill; returns its violation count."""
    if name == "harness":
        from d4pg_tpu_torch.fleet import ChaosConfig, FleetConfig, FleetHarness

        rep = FleetHarness(FleetConfig(
            n_actors=2, duration_s=1.0, rows_per_sec=200.0, block_rows=8,
            obs_dim=6, act_dim=2, capacity=4096, chaos=ChaosConfig(seed=1),
            flight_dir=str(tmp_path))).run()
        return rep["locks"]["hierarchy_violations"]
    if name == "learner_chaos":
        from d4pg_tpu_torch.fleet.learner_chaos import run_learner_chaos

        rep = run_learner_chaos(n_replicas=2, duration_s=1.0,
                                replica_kills=0, torn_prob=0.0)
    elif name == "elastic_chaos":
        from d4pg_tpu_torch.fleet.elastic_chaos import run_elastic_chaos

        rep = run_elastic_chaos(device="cpu", model_horizon_s=1.0,
                                flash_start_s=0.3, flash_duration_s=0.3)
    elif name == "serving_chaos":
        from d4pg_tpu_torch.fleet.serving_chaos import run_serving_chaos

        rep = run_serving_chaos(n_lanes=1, envs_per_lane=1, duration_s=1.0,
                                server_kills=0, torn_prob=0.0, device="cpu")
    elif name == "weight_chaos":
        from d4pg_tpu_torch.fleet.weight_chaos import run_weight_chaos

        rep = run_weight_chaos(n_pullers=2, relay_depth=1, duration_s=1.0,
                               learner_kills=0, relay_kills=0)
    else:
        from d4pg_tpu_torch.fleet.sampler_chaos import (
            SamplerChaosConfig,
            run_sampler_chaos,
        )

        rep = run_sampler_chaos(SamplerChaosConfig(
            n_actors=2, duration_s=1.0, device="cpu",
            flight_dir=str(tmp_path)))
    return rep["hierarchy_violations"]


@pytest.mark.parametrize("drill", ["harness", "learner_chaos",
                                   "elastic_chaos", "serving_chaos",
                                   "weight_chaos", "sampler_chaos"])
def test_each_drill_counts_an_injected_ascent(drill, tmp_path):
    """Each drill arms record mode for its run: an ascent committed by
    another thread meanwhile is counted in its report (and raises in
    none of the plane's threads), and the mode is put back after."""
    locking.reset_stats()
    t = threading.Thread(target=_ascent_once_armed, daemon=True)
    t.start()
    count = _drill(drill, tmp_path)
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert count == 1
    assert not locking.debug_enabled()
    locking.reset_stats()
