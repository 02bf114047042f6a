"""The port's fleet plane: the reference's ``tests/test_fleet.py`` cases
on ``d4pg_tpu_torch.fleet``, then the plane held against the reference's.

The reference's 18 cases: an N=8 chaos-enabled smoke, bit-for-bit
reproducibility of the seeded fault script, determinism of the chaos
primitives, the degradation bookkeeping, the process and real-actor lane
modes, the K=2 sharded plane and its bitwise equivalence to K=1, and the
two wide sweeps (``slow``). The reference's check that its benchmark
entry point imports becomes a run of ``fleet.sweep.main`` with a tiny
``--out`` here. Cross-package: the chaos streams and schedules, the
synthetic block, a ``max_ticks`` run's fault script, counters and
schedule digest, and the scripted K=1/K=2 feed's buffer bytes equal the
reference's at the same seeds. Every harness run dumps (if at all) into
the test's ``tmp_path``.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from d4pg_tpu import fleet as jfleet
from d4pg_tpu_torch.fleet import (
    ActorChaos,
    ChaosConfig,
    ChaosPolicy,
    FleetConfig,
    FleetHarness,
    StallGate,
    run_sweep,
    synthetic_block,
)

pytestmark = pytest.mark.torchport

_FLIGHT_DIR: list[str] = []


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path):
    """Every harness run of a test dumps into the test's tmp_path."""
    _FLIGHT_DIR[:] = [str(tmp_path / "flight")]
    yield
    _FLIGHT_DIR.clear()

# The tier-1 chaos mix: every fault kind enabled, scaled so an N=8 x
# 12-tick run still exercises drops, delays, crashes AND the stall gate.
SMOKE_CHAOS = ChaosConfig(
    drop_prob=0.1,
    delay_prob=0.2, delay_min_s=0.001, delay_max_s=0.005,
    crash_prob=0.05, restart_delay_s=0.3,
    receiver_stall_s=0.1, stall_every_s=0.4,
    seed=7,
)


def _smoke_config(**overrides) -> FleetConfig:
    base = dict(
        n_actors=8, max_ticks=12, rows_per_sec=400.0, block_rows=16,
        obs_dim=24, act_dim=4, capacity=20_000, heartbeat_timeout=0.5,
        evict_every_s=0.1, send_timeout=0.5, chaos=SMOKE_CHAOS,
        flight_dir=_FLIGHT_DIR[0],
    )
    base.update(overrides)
    return FleetConfig(**base)


def test_chaos_stream_deterministic():
    """Decision i of actor k depends only on (seed, k, i): two streams
    built from the same config replay the identical fault script, and a
    different actor index yields a different (decorrelated) one."""
    a = ActorChaos(SMOKE_CHAOS, 3, "a3")
    b = ActorChaos(SMOKE_CHAOS, 3, "a3")
    other = ActorChaos(SMOKE_CHAOS, 4, "a3")
    seq_a = [a.next() for _ in range(200)]
    seq_b = [b.next() for _ in range(200)]
    seq_o = [other.next() for _ in range(200)]
    assert seq_a == seq_b
    assert seq_a != seq_o
    kinds = {ev.kind for ev in seq_a}
    assert kinds == {"ok", "drop", "delay", "crash"}  # all faults live
    for ev in seq_a:
        if ev.kind == "delay":
            assert SMOKE_CHAOS.delay_min_s <= ev.arg <= SMOKE_CHAOS.delay_max_s


def test_stall_schedule_deterministic_and_bounded():
    policy = ChaosPolicy(SMOKE_CHAOS)
    sched = policy.stall_schedule(3.0)
    assert sched == policy.stall_schedule(3.0)
    assert sched, "stalls enabled but schedule empty"
    assert all(0 < t < 3.0 and d == SMOKE_CHAOS.receiver_stall_s
               for t, d in sched)
    assert ChaosPolicy(ChaosConfig()).stall_schedule(10.0) == []


def test_chaos_config_validation():
    with pytest.raises(ValueError):
        ChaosConfig(drop_prob=1.5)
    with pytest.raises(ValueError):
        ChaosConfig(delay_min_s=0.2, delay_max_s=0.1)
    assert not ChaosConfig().enabled()
    assert SMOKE_CHAOS.enabled()


def test_stall_gate_bounded_wait():
    gate = StallGate()
    assert gate.wait(timeout=0.1)  # open by default
    gate.stall()
    t0 = time.monotonic()
    assert not gate.wait(timeout=0.05)  # bounded, not a deadlock
    assert time.monotonic() - t0 < 1.0
    gate.resume()
    assert gate.wait(timeout=0.1)
    assert gate.stalls == 1


def test_fleet_smoke_n8_with_chaos():
    """The tier-1 acceptance smoke: 8 lanes, every fault kind enabled,
    seeded, seconds of wall clock — the plane must ingest rows, count
    every loss, recover from crashes, and finish without a deadlock."""
    result = FleetHarness(_smoke_config()).run()
    assert result["deadlocks"] == 0
    assert result["rows_per_sec"] > 0
    assert result["rows_inserted"] > 0
    assert result["ticks"] == 8 * 12
    # accounting closes: every attempted row was inserted or counted lost
    # (TCP frames accepted into a dying receiver's buffer are the only
    # non-counted loss mode, and the receiver here outlives the lanes)
    drops = result["drops"]
    assert result["rows_inserted"] + drops["backpressure_rows"] \
        + drops["shed_rows"] <= result["rows_attempted"]
    # the seeded script fired every fault kind at this size (seed-pinned)
    assert result["crashes"] > 0
    assert drops["chaos_rows"] > 0
    assert result["recovery"]["n"] > 0  # crash -> delivery measured
    assert result["receiver_stalls"] > 0
    lat = result["send_latency_ms"]
    assert lat["n"] > 0 and lat["p99"] >= lat["p50"] > 0
    # the smoke runs with lock-hierarchy assertions armed (record mode):
    # zero violations, and per-lock contention counters in the artifact
    locks = result["locks"]
    assert locks["hierarchy_violations"] == 0
    assert locks["violation_samples"] == []
    for tier in ("service", "shard", "commit"):
        per = locks["per_lock"][tier]
        assert per["acquisitions"] > 0
        assert per["wait_ns"] >= 0 and per["max_hold_ns"] > 0


def test_fleet_seeded_run_reproducible_bitwise():
    """Acceptance bar: seeded chaos runs reproduce bit-for-bit at the
    harness level — the full fault script (actor, tick, kind, float arg)
    is identical across two runs, as are the script-derived counters."""
    a = FleetHarness(_smoke_config()).run()
    b = FleetHarness(_smoke_config()).run()
    assert a["chaos_log"] == b["chaos_log"]
    assert a["crashes"] == b["crashes"]
    assert a["drops"]["chaos_rows"] == b["drops"]["chaos_rows"]
    assert a["ticks"] == b["ticks"]
    # ...and a different seed yields a different script
    c = FleetHarness(_smoke_config(
        chaos=dataclasses.replace(SMOKE_CHAOS, seed=8))).run()
    assert c["chaos_log"] != a["chaos_log"]


def test_fleet_eviction_and_readmission_under_crash():
    """A crashed lane whose outage exceeds the heartbeat timeout is
    evicted; its post-restart stream re-admits it (service-side recovery
    interval recorded)."""
    chaos = ChaosConfig(crash_prob=0.2, restart_delay_s=0.4, seed=3)
    result = FleetHarness(_smoke_config(
        chaos=chaos, max_ticks=20, heartbeat_timeout=0.25,
        evict_every_s=0.05)).run()
    assert result["crashes"] > 0
    assert result["evictions"] > 0
    assert result["readmissions"] > 0
    assert result["service_recovery"]["n"] > 0
    assert result["service_recovery"]["mean_s"] > 0
    assert result["deadlocks"] == 0


def test_synthetic_block_shapes_and_determinism():
    a = synthetic_block(16, 24, 4, seed=5)
    b = synthetic_block(16, 24, 4, seed=5)
    assert a.obs.shape == (16, 24) and a.action.shape == (16, 4)
    np.testing.assert_array_equal(a.obs, b.obs)
    assert a.obs.dtype == np.float32


def test_fleet_process_mode_small():
    """The optional subprocess mode: same lane loop, real processes. Kept
    tiny (2 lanes, no chaos) — it pays a spawn+import per lane."""
    cfg = _smoke_config(n_actors=2, max_ticks=4, mode="process",
                        chaos=ChaosConfig(seed=1),
                        connect_stagger_s=0.05)
    result = FleetHarness(cfg).run()
    assert result["mode"] == "process"
    assert result["deadlocks"] == 0
    assert result["rows_inserted"] == 2 * 4 * 16  # no chaos: all delivered
    assert result["chaos_log"] and all(
        ev[2] == "ok" for ev in result["chaos_log"])


def test_fleet_config_validation():
    with pytest.raises(ValueError):
        FleetConfig(mode="coroutine")
    assert FleetConfig(n_actors=4).demand_rows_per_sec() == 4 * 20.0


def test_fleet_smoke_sharded_k2():
    """The sharded receiver under the full tier-1 chaos mix: K=2 ingest
    shards, v2 raw frames (codec auto-resolves), every fault kind firing
    — zero deadlocks, zero merge order-breaks, and every shard's
    counters consistent with the rows it owned."""
    result = FleetHarness(_smoke_config(ingest_shards=2)).run()
    assert result["ingest_shards"] == 2
    assert result["codec"] == "raw"  # auto resolves to the v2 plane
    assert result["deadlocks"] == 0
    assert result["order_breaks"] == 0
    assert result["decode_errors"] == 0
    assert result["rows_inserted"] > 0
    assert result["ticks"] == 8 * 12
    assert result["rows_per_sec_per_shard"] == pytest.approx(
        result["rows_per_sec"] / 2, abs=0.1)
    # K=2 exercises the full tier stack under chaos — still zero
    # hierarchy violations, and the shard conditions saw real traffic
    assert result["locks"]["hierarchy_violations"] == 0
    assert result["locks"]["per_lock"]["shard"]["acquisitions"] > 0
    shards = result["per_shard"]
    assert [s["shard"] for s in shards] == [0, 1]
    # per-shard admission accounting covers every delivered row
    assert sum(s["rows_in"] for s in shards) >= result["rows_inserted"]
    drops = result["drops"]
    assert result["rows_inserted"] + drops["backpressure_rows"] \
        + drops["shed_rows"] <= result["rows_attempted"]
    assert result["crashes"] > 0 and drops["chaos_rows"] > 0


def _scripted_feed(n_lanes: int, ticks: int, block_rows: int = 8,
                   obs_dim: int = 6, act_dim: int = 2):
    """The deterministic K-equivalence feed: the SAME seeded fleet script
    (chaos decides which (lane, tick) blocks deliver), serialized in
    canonical (tick, lane) order. Lane k's tick t block is seeded by
    (k, t), so the feed is bit-reproducible."""
    policy = ChaosPolicy(SMOKE_CHAOS)
    streams = [policy.actor_stream(k, f"lane-{k}") for k in range(n_lanes)]
    feed = []
    for t in range(ticks):
        for k, chaos in enumerate(streams):
            ev = chaos.next()
            if ev.kind in ("ok", "delay"):  # delivered blocks only
                feed.append((k, synthetic_block(
                    block_rows, obs_dim, act_dim, seed=1000 * k + t)))
    return feed


def test_fleet_k2_bitwise_replay_equivalence_vs_k1():
    """Acceptance bar: the same seeded fleet script through a K=1 and a
    K=2 service lands the IDENTICAL final buffer — same bytes in the
    same slots, same env-step count — because the sharded plane's merge
    commits in admission-ticket order (docs/architecture.md
    "merge-commit ordering rules")."""
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.replay.uniform import ReplayBuffer

    feed = _scripted_feed(n_lanes=4, ticks=30)
    assert len(feed) > 50  # the script actually delivered a fleet's worth
    s1 = ReplayService(ReplayBuffer(100_000, 6, 2))
    s2 = ReplayService(ReplayBuffer(100_000, 6, 2), num_ingest_shards=2)
    for k, block in feed:
        s1.add(block, actor_id=f"lane-{k}")
        s2.add(block, actor_id=f"lane-{k}", shard=k % 2)
    s1.flush(timeout=10.0)
    s2.flush(timeout=10.0)
    assert s1.env_steps == s2.env_steps == 8 * len(feed)
    assert len(s1) == len(s2)
    for field in ("obs", "action", "reward", "next_obs", "done",
                  "discount"):
        np.testing.assert_array_equal(
            getattr(s1.buffer._store, field), getattr(s2.buffer._store, field))
    # counter-total equivalence (obs plane, no-double-count contract):
    # the unified row ledger must agree bitwise between the K=1 and K=2
    # planes — admitted == committed == env_steps on a clean feed, with
    # NO contribution from which internal path (drain vs direct-stage)
    # carried the rows
    st1, st2 = s1.ingest_stats(), s2.ingest_stats()
    assert st2["order_breaks"] == 0
    for key in ("env_steps", "rows_committed", "sheds", "shed_rows",
                "decode_errors", "admit_fails"):
        assert st1[key] == st2[key], key
    rows_in1 = sum(p["rows_in"] for p in st1["per_shard"])
    rows_in2 = sum(p["rows_in"] for p in st2["per_shard"])
    assert rows_in1 == rows_in2 == st1["rows_committed"] == 8 * len(feed)
    s1.close()
    s2.close()


def test_fleet_actor_mode_smoke():
    """The real-actor lane mode: N=2 lanes each spawn the port's
    ``actor_main`` in a subprocess — env pool, policy inference, live
    weight pulls — against
    the harness's receiver + weight server, through the sharded (K=2)
    ingest plane. Rows counted by the service must equal the env steps
    the actors report (n-step folding holds a tail back per env)."""
    cfg = _smoke_config(n_actors=2, max_ticks=8, mode="actor",
                        ingest_shards=2, chaos=ChaosConfig(seed=1),
                        send_timeout=5.0, heartbeat_timeout=30.0)
    result = FleetHarness(cfg).run()
    assert result["mode"] == "actor"
    assert result["deadlocks"] == 0
    assert len(result["lane_env_steps"]) == 2
    # 8 ticks x 2 envs per lane of real interaction
    assert all(s == 16 for s in result["lane_env_steps"])
    # every delivered row is real actor data; the n-step folder (n=2)
    # holds a warmup tail back per env, so inserted < env steps but must
    # cover the bulk of the interaction
    assert 0 < result["rows_inserted"] <= sum(result["lane_env_steps"])
    assert result["rows_inserted"] >= sum(result["lane_env_steps"]) // 2
    assert result["ingest"]["order_breaks"] == 0


@pytest.mark.slow
@pytest.mark.fleet
def test_shard_sweep_slow():
    """A bounded K ∈ {1, 2} shard sweep through the real sweep runner
    (the full K ∈ {1, 2, 4} x N=256 version is ``python -m
    d4pg_tpu_torch.fleet.sweep --shards_sweep 1 2 4``)."""
    from d4pg_tpu_torch.fleet import shard_sweep

    artifact = shard_sweep(ks=(1, 2), n_actors=16, duration_s=2.0,
                           rows_per_sec=200.0, chaos=SMOKE_CHAOS,
                           obs_dim=24, act_dim=4, capacity=50_000,
                           block_rows=16, heartbeat_timeout=0.5,
                           evict_every_s=0.1, send_timeout=0.5,
                           flight_dir=_FLIGHT_DIR[0])
    assert [r["ingest_shards"] for r in artifact["sweep"]] == [1, 2]
    assert [r["codec"] for r in artifact["sweep"]] == ["npz", "raw"]
    for row in artifact["sweep"]:
        assert row["deadlocks"] == 0
        assert row["rows_per_sec"] > 0
        assert row["locks"]["hierarchy_violations"] == 0
    scaling = artifact["scaling"]
    assert scaling[0]["speedup_vs_k1"] == 1.0
    assert all(s["vs_ceiling"] is not None for s in scaling)
    # the K-sweep's lock-wait attribution column is populated per K
    assert all(s["lock_wait_ms"] is not None
               and s["hierarchy_violations"] == 0 for s in scaling)


@pytest.mark.slow
@pytest.mark.fleet
def test_fleet_sweep_slow():
    """A bounded two-point sweep through the real sweep runner (the full
    {8..256} x 10 s version is ``python -m d4pg_tpu_torch.fleet.sweep``)."""
    artifact = run_sweep(ns=(8, 32), duration_s=2.0,
                         chaos=SMOKE_CHAOS, obs_dim=24, act_dim=4,
                         capacity=50_000, rows_per_sec=100.0,
                         block_rows=16, heartbeat_timeout=0.5,
                         evict_every_s=0.1, send_timeout=0.5,
                         flight_dir=_FLIGHT_DIR[0])
    assert [row["n_actors"] for row in artifact["sweep"]] == [8, 32]
    for row in artifact["sweep"]:
        assert row["deadlocks"] == 0
        assert row["rows_per_sec"] > 0
        assert "chaos_log" not in row  # stripped: regenerable from seed
        assert set(row["drops"]) == {"chaos_rows", "backpressure_rows",
                                     "shed_batches", "shed_rows"}
    assert artifact["metric"] == "fleet_rows_per_sec"
    assert artifact["config"]["chaos"]["seed"] == SMOKE_CHAOS.seed


def test_bench_fleet_entrypoint_importable(tmp_path, capsys):
    """The sweep's command line runs end to end: a tiny N sweep writes
    its artifact to ``--out`` and prints the same JSON."""
    import json

    from d4pg_tpu_torch.fleet.sweep import main

    out = tmp_path / "fleet.json"
    main(["--ns", "2", "--seconds", "0.5", "--block_rows", "8",
          "--no_chaos", "--out", str(out)])
    artifact = json.loads(out.read_text())
    assert artifact == json.loads(capsys.readouterr().out.strip())
    assert artifact["metric"] == "fleet_rows_per_sec"
    row, = artifact["sweep"]
    assert row["n_actors"] == 2 and row["deadlocks"] == 0
    assert row["rows_per_sec"] > 0
    assert row["locks"]["hierarchy_violations"] == 0


def test_fleet_analysis_table_and_plot(tmp_path):
    """actor_scaling renders the sweep artifact as table + PNG."""
    from d4pg_tpu_torch.analysis.actor_scaling import fleet_table, plot_fleet

    artifact = run_sweep(ns=(4,), duration_s=0.0, chaos=SMOKE_CHAOS,
                         max_ticks=4, obs_dim=24, act_dim=4,
                         capacity=10_000, rows_per_sec=200.0,
                         block_rows=8, heartbeat_timeout=0.5,
                         evict_every_s=0.1, send_timeout=0.5,
                         flight_dir=_FLIGHT_DIR[0])
    table = fleet_table(artifact)
    assert "rows/s" in table and "4" in table
    out = plot_fleet(artifact, str(tmp_path / "fleet.png"))
    import os

    assert os.path.getsize(out) > 0


def test_stop_event_interrupts_lanes():
    """An externally-set stop event ends a duration-mode run early —
    lanes are interruptible mid-sleep (no join timeouts burned)."""
    cfg = _smoke_config(max_ticks=None, duration_s=0.5,
                        chaos=ChaosConfig(seed=0), rows_per_sec=20.0)
    t0 = time.monotonic()
    result = FleetHarness(cfg).run()
    assert time.monotonic() - t0 < 15.0
    assert result["deadlocks"] == 0
    assert threading.active_count() < 100  # lanes actually exited


# ------------------------------------------------ against the reference --

_CHAOS_CASES = [
    SMOKE_CHAOS,
    ChaosConfig(crash_prob=0.2, restart_delay_s=0.4, seed=3),
    dataclasses.replace(SMOKE_CHAOS, seed=11, service_kill_count=3,
                        service_kill_every_s=1.3),
]


def _jchaos(cfg: ChaosConfig):
    return jfleet.ChaosConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("case", range(len(_CHAOS_CASES)))
def test_chaos_streams_and_schedules_equal_the_reference(case):
    cfg = _CHAOS_CASES[case]
    for k in (0, 3, 17):
        ours = ChaosPolicy(cfg).actor_stream(k, f"fleet-{k}")
        ref = jfleet.ChaosPolicy(_jchaos(cfg)).actor_stream(k, f"fleet-{k}")
        assert ([tuple(ours.next()) for _ in range(300)]
                == [tuple(ref.next()) for _ in range(300)])
    for horizon in (0.5, 3.0, 60.0):
        assert (ChaosPolicy(cfg).stall_schedule(horizon)
                == jfleet.ChaosPolicy(_jchaos(cfg)).stall_schedule(horizon))
        assert (ChaosPolicy(cfg).service_kill_schedule(horizon)
                == jfleet.ChaosPolicy(_jchaos(cfg)
                                      ).service_kill_schedule(horizon))


def test_synthetic_block_is_the_reference_block():
    for rows, obs_dim, act_dim, seed in ((16, 24, 4, 5), (8, 376, 17, 0)):
        ours = synthetic_block(rows, obs_dim, act_dim, seed=seed)
        ref = jfleet.synthetic_block(rows, obs_dim, act_dim, seed=seed)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_harness_fault_script_and_counters_equal_the_reference():
    """A ``max_ticks`` run of each package's harness at one config: the
    same fault script (every lane's events), the same script-derived
    counters and the same schedule digest of the draw ledger."""
    kw = dict(
        n_actors=6, max_ticks=10, rows_per_sec=400.0, block_rows=16,
        obs_dim=24, act_dim=4, capacity=20_000, heartbeat_timeout=0.5,
        evict_every_s=0.1, send_timeout=0.5, ingest_shards=2,
        flight_dir=_FLIGHT_DIR[0])
    ours = FleetHarness(FleetConfig(chaos=SMOKE_CHAOS, **kw)).run()
    ref = jfleet.FleetHarness(jfleet.FleetConfig(
        chaos=_jchaos(SMOKE_CHAOS), **kw)).run()
    assert [tuple(e) for e in ours["chaos_log"]] == \
        [tuple(e) for e in ref["chaos_log"]]
    assert ours["crashes"] == ref["crashes"] > 0
    assert ours["drops"]["chaos_rows"] == ref["drops"]["chaos_rows"] > 0
    assert ours["ticks"] == ref["ticks"] == 6 * 10
    assert (ours["draw_ledger"]["schedule_digest"]
            == ref["draw_ledger"]["schedule_digest"])
    assert ours["draw_ledger"]["streams"] == ref["draw_ledger"]["streams"]
    assert ours["draw_ledger"]["digest"] == ref["draw_ledger"]["digest"]


def test_scripted_feed_lands_the_reference_buffer_bytes():
    """The K-equivalence feed through the port's K=1 and K=2 services and
    the reference's K=1 service: the same bytes in the same slots."""
    from d4pg_tpu.distributed.replay_service import (
        ReplayService as JReplayService,
    )
    from d4pg_tpu.replay.uniform import ReplayBuffer as JReplayBuffer
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.replay.uniform import ReplayBuffer

    feed = _scripted_feed(n_lanes=4, ticks=30)
    ref = JReplayService(JReplayBuffer(100_000, 6, 2))
    s1 = ReplayService(ReplayBuffer(100_000, 6, 2))
    s2 = ReplayService(ReplayBuffer(100_000, 6, 2), num_ingest_shards=2)
    for k, block in feed:
        ref.add(block, actor_id=f"lane-{k}")
        s1.add(block, actor_id=f"lane-{k}")
        s2.add(block, actor_id=f"lane-{k}", shard=k % 2)
    for s in (ref, s1, s2):
        s.flush(timeout=10.0)
    assert ref.env_steps == s1.env_steps == s2.env_steps == 8 * len(feed)
    for field in ("obs", "action", "reward", "next_obs", "done",
                  "discount"):
        want = np.asarray(getattr(ref.buffer, field))
        for s in (s1, s2):
            got = getattr(s.buffer._store, field)
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes(), field
    for s in (ref, s1, s2):
        s.close()
