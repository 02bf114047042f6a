"""The port's fleet drills: the reference's fleet-marked drill smokes on
``d4pg_tpu_torch.fleet``, the drills' seeded schedules against the
reference's, and the schema of every block the sweep builds.

From the reference: the service-chaos smoke and its configuration checks,
the kill schedule, the bitwise ``recovery_probe`` and flight-dump
retention (``tests/test_recovery.py``); the three ``FleetHarness`` cases
of ``tests/test_obs.py``; the serving, weight, sampler and device-sampler
chaos smokes (the device arm on the CPU here). The reference checks its
blocks' schema on a committed artifact; here each block is built by the
test at a small size and checked as it comes back. Every harness run
dumps (if at all) into the test's ``tmp_path``.
"""

import dataclasses
import glob
import json
import os
import threading
import time

import pytest

from d4pg_tpu_torch.obs import flight as tflight
from d4pg_tpu_torch.obs import trace as ttrace
from d4pg_tpu_torch.obs.registry import REGISTRY

pytestmark = [pytest.mark.torchport, pytest.mark.fleet]


# ------------------------------------------------- learner-kill chaos ----

@pytest.mark.recovery
def test_service_chaos_smoke(tmp_path):
    """A small seeded fleet survives mid-run service kills: the
    supervisor restores from the latest snapshot, actors re-handshake,
    and the run ends with zero deadlocks/hierarchy violations and a
    populated recovery block (MTTR, fence ledger, storm spread)."""
    from d4pg_tpu_torch.fleet import FleetConfig, FleetHarness
    from d4pg_tpu_torch.fleet.sweep import default_service_chaos

    cfg = FleetConfig(
        n_actors=6, duration_s=6.0, rows_per_sec=60.0, block_rows=16,
        obs_dim=12, act_dim=3, capacity=40_000, ingest_shards=2,
        codec="raw", send_timeout=0.5,
        chaos=default_service_chaos(seed=11, duration_s=6.0),
        flight_dir=str(tmp_path))
    result = FleetHarness(cfg).run()
    sc = result["service_chaos"]
    assert sc is not None
    assert sc["kills"] >= 1
    assert sc["restarts"] >= 1
    assert sc["failed_restarts"] == 0
    assert sc["final_generation"] == sc["kills"]
    assert sc["snapshots"] >= 1
    assert sc["mttr_s"]["n"] == sc["restarts"]
    assert sc["mttr_s"]["max_s"] < 30.0
    assert result["deadlocks"] == 0
    assert result["locks"]["hierarchy_violations"] == 0
    storm = sc["reconnect_storm"]
    assert storm["jitters"] >= 1
    assert storm["distinct"] >= 1
    assert result["rows_inserted"] > 0


@pytest.mark.recovery
def test_service_chaos_requires_raw_codec_and_threads():
    from d4pg_tpu_torch.fleet import FleetConfig
    from d4pg_tpu_torch.fleet.sweep import default_service_chaos

    chaos = default_service_chaos(seed=0, duration_s=5.0)
    with pytest.raises(ValueError, match="raw"):
        FleetConfig(n_actors=2, codec="npz", chaos=chaos)
    with pytest.raises(ValueError):
        FleetConfig(n_actors=2, codec="raw", mode="process", chaos=chaos)


@pytest.mark.recovery
def test_kill_schedule_seeded_and_bounded():
    from d4pg_tpu_torch.fleet import ChaosPolicy
    from d4pg_tpu_torch.fleet.sweep import default_service_chaos

    chaos = default_service_chaos(seed=5, duration_s=10.0)
    a = ChaosPolicy(chaos).service_kill_schedule(10.0)
    b = ChaosPolicy(chaos).service_kill_schedule(10.0)
    assert a == b and len(a) == chaos.service_kill_count
    assert all(0.1 <= t < 10.0 for t in a)
    other = dataclasses.replace(chaos, seed=6)
    assert ChaosPolicy(other).service_kill_schedule(10.0) != a


@pytest.mark.recovery
def test_recovery_probe_oracle_bitwise():
    from d4pg_tpu_torch.fleet.sweep import recovery_probe

    out = recovery_probe(seed=1, blocks=12, block_rows=8, obs_dim=6,
                         act_dim=2, cut=6, lost=2)
    assert out["oracle_bitwise_equal"] is True
    assert out["rows_lost_declared"] == 2 * 8
    assert out["rows_compared"] == (12 - 2) * 8


@pytest.mark.recovery
def test_flight_dump_retention_and_collision_free(tmp_path):
    fleet_art = tmp_path / "fleet_20990101-000000_0000001.json"
    fleet_art.write_text("{}")
    rec = tflight.FlightRecorder(maxlen=16, keep_dumps=3)
    rec.record("kill", generation=1)
    paths = [rec.dump(str(tmp_path), "service_kill") for _ in range(7)]
    assert len(set(paths)) == 7  # same-second dumps never collide
    left = sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "flight_*.json")))
    assert len(left) == 3
    assert left == sorted(os.path.basename(p) for p in paths)[-3:]
    assert fleet_art.exists()


@pytest.mark.recovery
def test_prune_artifacts_disabled_and_missing_dir(tmp_path):
    (tmp_path / "flight_a.json").write_text("{}")
    assert tflight.prune_artifacts(str(tmp_path), "flight_", 0) == []
    assert (tmp_path / "flight_a.json").exists()
    assert tflight.prune_artifacts(str(tmp_path / "nope"), "flight_",
                                   5) == []


# ------------------------------------------ the obs plane's harness runs --

def _obs_chaos(**kw):
    from d4pg_tpu_torch.fleet import ChaosConfig

    return ChaosConfig(
        drop_prob=0.1, delay_prob=0.2, delay_min_s=0.001, delay_max_s=0.005,
        crash_prob=0.05, restart_delay_s=0.3, seed=7, **kw)


def test_trace_propagation_k2_merge_under_chaos(tmp_path):
    """Every sampled trace crossing the K=2 sharded ordered merge under
    the full chaos mix keeps a monotone span sequence and terminates:
    shed frames get terminal ``shed`` spans, nothing leaks."""
    from d4pg_tpu_torch.fleet import FleetConfig, FleetHarness

    cfg = FleetConfig(
        n_actors=8, max_ticks=12, rows_per_sec=400.0, block_rows=16,
        obs_dim=24, act_dim=4, capacity=20_000, heartbeat_timeout=0.5,
        evict_every_s=0.1, send_timeout=0.5,
        chaos=_obs_chaos(receiver_stall_s=0.1, stall_every_s=0.4),
        ingest_shards=2, trace_sample=1.0, flight_dir=str(tmp_path))
    result = FleetHarness(cfg).run()
    assert result["deadlocks"] == 0
    assert result["frames_traced"] > 20
    lat = result["latency"]
    assert lat is not None and lat["orphans"] == 0
    table = ttrace.RECORDER.span_table()
    assert len(table) == result["frames_traced"] >= lat["completed"] > 0
    ordered_stages = ("send", "admission", "decode", "stage", "merge",
                      "commit", "grad")
    completed = shed = 0
    for tid, spans in table.items():
        terminal = [t for t in ("commit", "grad", "shed") if t in spans]
        assert terminal, f"trace {tid} leaked with spans {sorted(spans)}"
        if "shed" in spans:
            shed += 1
            continue
        completed += 1
        ts = [spans[s] for s in ordered_stages if s in spans]
        assert len(ts) >= 6
        assert ts == sorted(ts), f"non-monotone spans for {tid}: {spans}"
    assert completed == lat["completed"] and shed == lat["shed"]


def test_flight_dump_on_injected_lock_violation(tmp_path):
    """An injected lock-hierarchy violation (record mode) during a chaos
    smoke produces a flight-recorder dump holding the violation event and
    the >= 32 events before it."""
    from d4pg_tpu_torch.core import locking
    from d4pg_tpu_torch.fleet import FleetConfig, FleetHarness

    cfg = FleetConfig(
        n_actors=8, max_ticks=16, rows_per_sec=400.0, block_rows=16,
        obs_dim=24, act_dim=4, capacity=20_000, heartbeat_timeout=0.5,
        evict_every_s=0.1, send_timeout=0.5, chaos=_obs_chaos(),
        flight_dir=str(tmp_path))
    tflight.RECORDER.reset()

    def inject():
        # wait until THIS run armed record mode and produced a preamble
        # of ring events, then commit the merge-wedge shape: a
        # service-tier acquisition under a shard-tier hold
        deadline = time.monotonic() + 20.0
        while ((not locking.debug_enabled()
                or len(tflight.RECORDER) < 40)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        with locking.TieredLock("shard"):
            with locking.TieredLock("service"):
                pass

    t = threading.Thread(target=inject, daemon=True)
    t.start()
    result = FleetHarness(cfg).run()
    t.join(timeout=25.0)
    assert result["locks"]["hierarchy_violations"] == 1
    assert result["deadlocks"] == 0
    dump = result["flight_dump"]
    assert dump is not None and os.path.exists(dump)
    assert os.path.dirname(dump) == str(tmp_path)
    with open(dump) as f:
        d = json.load(f)
    assert d["reason"] == "hierarchy_violation"
    kinds = [e["kind"] for e in d["events"]]
    assert "lock_violation" in kinds
    idx = kinds.index("lock_violation")
    assert idx >= 32, f"only {idx} events precede the violation"
    assert "acquiring 'service'" in d["events"][idx]["msg"]
    assert kinds.count("admit") >= 32
    assert not locking.debug_enabled()  # the harness put the mode back
    locking.reset_stats()


def test_clean_smoke_produces_no_dump(tmp_path):
    from d4pg_tpu_torch.fleet import ChaosConfig, FleetConfig, FleetHarness

    cfg = FleetConfig(
        n_actors=2, max_ticks=4, rows_per_sec=400.0, block_rows=16,
        obs_dim=24, act_dim=4, capacity=20_000, heartbeat_timeout=0.5,
        evict_every_s=0.1, send_timeout=0.5, chaos=ChaosConfig(seed=1),
        flight_dir=str(tmp_path))
    result = FleetHarness(cfg).run()
    assert result["deadlocks"] == 0
    assert result["flight_dump"] is None
    assert glob.glob(os.path.join(str(tmp_path), "*.json")) == []


# ------------------------------------------------------ drill smokes ----

@pytest.mark.serving
def test_serving_chaos_smoke():
    """A small end-to-end run passes the three gating oracles (torn
    acceptance ledger, trace orphans, lock hierarchy), recovers from the
    server kill (MTTR measured) and counts its degradation instead of
    stalling. The server answers on the CPU here."""
    from d4pg_tpu_torch.fleet.serving_chaos import (
        ServingChaosConfig,
        run_serving_chaos,
    )

    crashes0 = REGISTRY.counter("threads.contained_crashes").value
    rep = run_serving_chaos(ServingChaosConfig(
        n_lanes=2, envs_per_lane=2, duration_s=1.5, server_kills=1,
        torn_prob=0.1, seed=3, device="cpu"))
    assert rep["server_kills"] == 1
    assert REGISTRY.counter("threads.contained_crashes").value == crashes0
    assert rep["mttr_s"] and rep["mttr_s"][0] is not None
    assert rep["torn"]["injected"] > 0
    assert rep["torn"]["accepted"] == 0
    assert rep["trace"]["orphans"] == 0
    assert rep["hierarchy_violations"] == 0
    assert rep["lanes_converged"] == 2
    assert rep["served"] > 0 and rep["env_steps"] > 0
    assert (rep["fallbacks"] + rep["warmup_fallbacks"]
            + rep["timeouts"] + rep["wire_errors"]) > 0
    assert rep["ingest"]["env_steps"] > 0
    assert rep["device"] == "cpu"


@pytest.mark.weights
def test_weight_chaos_smoke():
    from d4pg_tpu_torch.fleet.weight_chaos import (
        WeightChaosConfig,
        run_weight_chaos,
    )

    crashes0 = REGISTRY.counter("threads.contained_crashes").value
    rep = run_weight_chaos(WeightChaosConfig(
        n_pullers=8, relay_depth=2, duration_s=2.5,
        learner_kills=1, relay_kills=1, seed=3))
    assert rep["learner_kills"] == 1 and rep["final_generation"] == 1
    assert REGISTRY.counter("threads.contained_crashes").value == crashes0
    assert rep["torn"]["accepted"] == 0
    assert rep["ledger"]["monotone"] is True
    assert rep["ledger"]["unpublished_accepted"] == 0
    assert rep["trace"]["orphans"] == 0
    assert rep["hierarchy_violations"] == 0
    assert rep["oracle"]["delta_failures"] == 0
    assert rep["oracle"]["quant_failures"] == 0
    assert rep["frames_delta"] > 0 and rep["frames_full"] > 0
    assert rep["snapshots_per_sec"] > 0


@pytest.mark.sampler
def test_sampler_chaos_smoke(tmp_path):
    from d4pg_tpu_torch.fleet.sampler_chaos import (
        SamplerChaosConfig,
        run_sampler_chaos,
    )

    crashes0 = REGISTRY.counter("threads.contained_crashes").value
    rep = run_sampler_chaos(SamplerChaosConfig(
        sample_path="dealer", n_actors=4, duration_s=3.0,
        rows_per_sec=40.0, learner_kills=1, stale_frames=3, seed=3,
        flight_dir=str(tmp_path)))
    assert rep["deadlocks"] == 0
    assert REGISTRY.counter("threads.contained_crashes").value == crashes0
    assert rep["hierarchy_violations"] == 0
    assert rep["trace_orphans"] == 0
    assert rep["sampler"]["dealt_dead_tickets"] == 0
    assert rep["consumer"]["sample_path_buffer_acqs"] == 0
    assert rep["consumer"]["consumer_kills"] == 1
    assert rep["consumer"]["stale_frames_injected"] == 3
    assert rep["fenced_frames"] == 3
    assert rep["sampler"]["dealt_blocks"] > 0
    assert rep["consumer"]["blocks_consumed"] > 0


@pytest.mark.devsample
def test_device_sampler_chaos_smoke(tmp_path):
    """The device arm (here on the CPU) under the sampler fault set:
    every gating oracle holds and no top-frame containment fires."""
    from d4pg_tpu_torch.fleet.sampler_chaos import (
        SamplerChaosConfig,
        run_sampler_chaos,
    )

    crashes0 = REGISTRY.counter("threads.contained_crashes").value
    rep = run_sampler_chaos(SamplerChaosConfig(
        sample_path="device", n_actors=4, duration_s=2.5,
        rows_per_sec=40.0, learner_kills=1, stale_frames=2, seed=5,
        device="cpu", flight_dir=str(tmp_path)))
    assert REGISTRY.counter("threads.contained_crashes").value == crashes0
    assert rep["deadlocks"] == 0
    assert rep["hierarchy_violations"] == 0
    assert rep["trace_orphans"] == 0
    assert rep["sampler"]["dealt_dead_tickets"] == 0
    assert rep["consumer"]["sample_path_buffer_acqs"] == 0
    assert rep["consumer"]["consumer_kills"] == 1
    assert rep["ingest_shards"] == 1  # coerced: single commit thread
    assert rep["device"] == "cpu"
    assert rep["sampler"]["dealt_blocks"] > 0
    assert rep["consumer"]["blocks_consumed"] > 0


def test_drills_run_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                        tmp_path):
    import torch

    from d4pg_tpu_torch.fleet.sampler_chaos import (
        SamplerChaosConfig,
        run_sampler_chaos,
    )
    from d4pg_tpu_torch.fleet.serving_chaos import run_serving_chaos

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_serving_chaos(duration_s=0.1)
    with pytest.raises(RuntimeError, match="cuda"):
        run_sampler_chaos(SamplerChaosConfig(
            sample_path="device", n_actors=1, duration_s=0.1,
            flight_dir=str(tmp_path)))


# -------------------------------------------- schedules, cross-package ---

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_drill_kill_schedules_equal_the_reference(seed):
    from d4pg_tpu.fleet import ChaosPolicy as JChaosPolicy
    from d4pg_tpu.fleet import sampler_chaos as js
    from d4pg_tpu.fleet import serving_chaos as jv
    from d4pg_tpu.fleet import weight_chaos as jw
    from d4pg_tpu.fleet import sweep as jsweep
    from d4pg_tpu_torch.fleet import ChaosPolicy, sampler_chaos, sweep
    from d4pg_tpu_torch.fleet import serving_chaos, weight_chaos
    from d4pg_tpu_torch.fleet.chaos import ChaosConfig

    for kills in (0, 1, 3):
        for lane in (1, 2):
            assert (weight_chaos.WeightChaosConfig(seed=seed)
                    .kill_schedule(kills, lane)
                    == jw.WeightChaosConfig(seed=seed)
                    .kill_schedule(kills, lane))
            assert (serving_chaos.ServingChaosConfig(seed=seed)
                    .kill_schedule(kills, lane)
                    == jv.ServingChaosConfig(seed=seed)
                    .kill_schedule(kills, lane))
        ours = sampler_chaos.SamplerChaosConfig(
            seed=seed, learner_kills=kills, stale_frames=kills)
        ref = js.SamplerChaosConfig(seed=seed, learner_kills=kills,
                                    stale_frames=kills)
        assert ours.kill_schedule() == ref.kill_schedule()
        assert ours.stale_schedule() == ref.stale_schedule()
    for duration in (6.0, 10.0):
        ours = sweep.default_service_chaos(seed, duration)
        ref = jsweep.default_service_chaos(seed, duration)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ChaosPolicy(ours).service_kill_schedule(duration)
                == JChaosPolicy(ref).service_kill_schedule(duration))
    assert (dataclasses.asdict(sweep.default_chaos(seed))
            == dataclasses.asdict(jsweep.default_chaos(seed)))
    assert isinstance(sweep.default_chaos(seed), ChaosConfig)


# ------------------------------------------------ the sweep's blocks ----

_SMALL = dict(block_rows=8, obs_dim=12, act_dim=3, capacity=20_000)

_LATENCY_STAGES = ("wire_to_admission", "admission_to_decode",
                   "decode_to_stage", "stage_to_merge", "merge_to_commit",
                   "commit_to_grad", "wire_to_commit", "wire_to_grad")


@pytest.mark.recovery
def test_recovery_block_schema(tmp_path):
    from d4pg_tpu_torch.fleet.sweep import run_recovery

    rec = run_recovery(n_actors=6, duration_s=3.0, seed=2,
                       flight_dir=str(tmp_path), **_SMALL)
    json.dumps(rec)
    assert rec["metric"] == "fleet_recovery" and rec["schema"] == 1
    assert rec["kills"] >= 1 and rec["restarts"] >= 1
    assert rec["failed_restarts"] == 0
    assert rec["deadlocks"] == 0
    assert rec["hierarchy_violations"] == 0
    assert rec["mttr_s"]["n"] >= 1 and rec["mttr_s"]["max_s"] is not None
    assert rec["final_generation"] >= 1
    assert rec["rows_fenced"] >= 0 and rec["frames_fenced"] >= 0
    assert {"jitters", "distinct", "spread_ms"} <= set(rec["reconnect_storm"])
    assert rec["oracle"]["oracle_bitwise_equal"] is True
    assert rec["oracle"]["rows_lost_declared"] >= 0


@pytest.mark.weights
def test_weights_block_schema():
    from d4pg_tpu_torch.fleet.sweep import run_weights

    w = run_weights(n_pullers=6, relay_depth=2, duration_s=2.0, seed=1)
    json.dumps(w)
    assert w["metric"] == "weight_chaos" and w["schema"] == 1
    assert w["n_pullers"] == 6 and w["relay_depth"] == 2
    assert w["learner_kills"] >= 1 and w["final_generation"] >= 1
    assert w["snapshots_per_sec"] > 0
    assert w["delta_hit_rate"] is not None and 0 < w["delta_hit_rate"] <= 1
    for pct in ("p50", "p95", "p99"):
        assert w["staleness_ms"][pct] is not None
    assert w["torn"]["accepted"] == 0
    assert w["hierarchy_violations"] == 0
    assert w["trace"]["orphans"] == 0
    assert w["ledger"]["monotone"] is True
    assert w["ledger"]["unpublished_accepted"] == 0
    assert w["oracle"]["delta_failures"] == 0


@pytest.mark.sampler
def test_sampler_block_schema(tmp_path):
    from d4pg_tpu_torch.fleet.sweep import run_sampler

    blk = run_sampler(n_actors=4, duration_s=1.5, seed=1, learner_kills=1,
                      stale_frames=2, device="cpu", flight_dir=str(tmp_path))
    json.dumps(blk)
    assert blk["metric"] == "fleet_sampler" and blk["schema"] == 1
    ab = blk["ab"]
    assert ab["dealer"]["sample_path_buffer_acqs"] == 0
    assert ab["device"]["sample_path_buffer_acqs"] == 0
    assert ab["host"]["sample_path_buffer_acqs"] > 0
    for arm in ("dealer", "host", "device"):
        assert ab[arm]["wire_to_grad_p95_ms"] is not None
        assert "deal_to_grad_p95_ms" in ab[arm]
        assert ab[arm]["blocks_consumed"] > 0
        assert ab[arm]["deadlocks"] == 0
        assert ab[arm]["hierarchy_violations"] == 0
        assert ab[arm]["trace_orphans"] == 0
    assert ab["device"]["device"] == "cpu" and ab["dealer"]["device"] is None
    for arm in ("dealer", "device"):
        assert ab[arm]["sampler"]["dealt_blocks"] > 0
        assert "wire_to_grad_p95_delta_ms" in ab[arm]
    chaos = blk["chaos"]
    assert chaos["metric"] == "sampler_chaos" and chaos["schema"] == 1
    assert chaos["sample_path"] == "dealer"
    assert chaos["deadlocks"] == 0
    assert chaos["hierarchy_violations"] == 0
    assert chaos["trace_orphans"] == 0
    assert chaos["sampler"]["dealt_dead_tickets"] == 0
    assert chaos["consumer"]["sample_path_buffer_acqs"] == 0
    assert chaos["consumer"]["consumer_kills"] >= 1
    assert chaos["fenced_frames"] >= 1


@pytest.mark.serving
def test_serving_block_schema():
    from d4pg_tpu_torch.fleet.sweep import run_serving

    s = run_serving(lane_counts=(1, 2), envs_per_lane=2, duration_s=0.75,
                    pair_lanes=2, seed=1, device="cpu")
    json.dumps(s)
    assert s["metric"] == "fleet_serving" and s["schema"] == 1
    assert [r["n_lanes"] for r in s["sweep"]] == [1, 2]
    for row in s["sweep"]:
        assert row["actions_per_sec"] > 0
        assert row["trace_orphans"] == 0
        assert row["hierarchy_violations"] == 0
        for pct in ("p50", "p95", "p99"):
            assert row["latency_ms"][pct] is not None
    pair = s["batching"]
    assert pair["n_lanes"] == 2
    assert pair["batched_actions_per_sec"] > 0
    assert pair["unbatched_actions_per_sec"] > 0
    assert pair["speedup"] is not None
    chaos = s["chaos"]
    assert chaos["server_kills"] >= 1
    assert chaos["mttr_s"] and all(m is not None for m in chaos["mttr_s"])
    assert chaos["torn"]["accepted"] == 0
    assert chaos["trace"]["orphans"] == 0
    assert chaos["hierarchy_violations"] == 0


@pytest.mark.obs
def test_latency_block_schema(tmp_path):
    """The shard sweep's traced K=2 row carries the latency block, and the
    scaling table carries stage attribution next to ``lock_wait_ms``."""
    from d4pg_tpu_torch.fleet import ChaosConfig, shard_sweep

    art = shard_sweep(ks=(1, 2), n_actors=4, duration_s=1.0,
                      rows_per_sec=200.0, chaos=ChaosConfig(seed=1),
                      trace_sample=1.0, heartbeat_timeout=0.5,
                      evict_every_s=0.1, send_timeout=0.5,
                      flight_dir=str(tmp_path), **_SMALL)
    json.dumps(art)
    assert [r["codec"] for r in art["sweep"]] == ["npz", "raw"]
    assert art["sweep"][0]["latency"] is None  # the legacy row: untraced
    lat = art["sweep"][1]["latency"]
    assert lat["sample_rate"] > 0
    assert lat["n_traces"] > 0 and lat["orphans"] == 0
    for stage in _LATENCY_STAGES:
        assert {"p50", "p95", "p99", "n"} <= set(lat["stages"][stage])
    assert lat["wire_to_grad"]["n"] > 0
    for row in art["scaling"]:
        assert "stage_ms" in row and "lock_wait_ms" in row
        assert row["lock_wait_ms"] is not None
        assert row["hierarchy_violations"] == 0
        if row["ingest_shards"] > 1:
            assert "wire_to_commit" in row["stage_ms"]


@pytest.mark.learner
def test_learners_block_schema():
    from d4pg_tpu_torch.fleet.sweep import run_learners

    blk = run_learners(ns=(1, 2), duration_s=0.75, replica_kills=1)
    json.dumps(blk)
    assert blk["metric"] == "fleet_learners" and blk["schema"] == 1
    assert [r["n_replicas"] for r in blk["sweep"]] == [1, 2]
    for row in blk["sweep"]:
        assert row["updates_per_sec"] > 0
        assert row["ledger_monotone"] is True
        assert row["trace_orphans"] == 0
        assert row["hierarchy_violations"] == 0
    chaos = blk["chaos"]
    assert chaos["replica_kills"] == 1
    assert chaos["replayed_fenced"] == chaos["replayed_inflight"]
    assert chaos["hierarchy_violations"] == 0
