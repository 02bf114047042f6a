"""Fleet fan-out sweep: rows/s against N actors, chaos on, one receiver.

Counterpart of ``d4pg_tpu/fleet/sweep.py``. N in {8, 32, 64, 128, 256}
throttled lanes at a fixed per-lane demand walk the ingest plane from
idle (8 x 20 = 160 rows/s) to 256 x 20 = 5,120 rows/s with the default
chaos mix injecting drops, stragglers, crashes and receiver stalls the
whole way. ``shard_sweep`` fixes N and walks the ingest shards K; the
``run_*`` functions run the recovery, weight, learner, mesh, sampler,
serving and elastic drills and return their blocks. Run it:

    python -m d4pg_tpu_torch.fleet.sweep --ns 8 32 64 128 256 --seconds 10
    python -m d4pg_tpu_torch.fleet.sweep --ns 256 --shards_sweep 1 2 4
    python -m d4pg_tpu_torch.fleet.sweep --sampler --device cuda

Per-N rows are ``FleetHarness._report`` dicts minus the raw chaos log
(the log is deterministic from the seed, which the artifact carries).
The ingest, weight and learner planes are host work; the serving drill's
server, the sampler drill's device arm and the mesh A/B run on
``--device`` (the card by default, raising without one).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from d4pg_tpu_torch.fleet.chaos import ChaosConfig
from d4pg_tpu_torch.fleet.harness import FleetConfig, FleetHarness

SWEEP_NS = (8, 32, 64, 128, 256)


def default_chaos(seed: int = 0) -> ChaosConfig:
    """The sweep's standard fault mix: ~2% dropped blocks, ~5% stragglers
    (5-50 ms), ~0.4%/tick crashes with a 4 s outage (long enough to cross
    the 3 s heartbeat timeout, so every crash exercises eviction AND
    re-admission), and a 0.5 s receiver stall every 3 s."""
    return ChaosConfig(
        drop_prob=0.02,
        delay_prob=0.05, delay_min_s=0.005, delay_max_s=0.05,
        crash_prob=0.004, restart_delay_s=4.0,
        receiver_stall_s=0.5, stall_every_s=3.0,
        seed=seed,
    )


def default_service_chaos(seed: int = 0,
                          duration_s: float = 10.0) -> ChaosConfig:
    """The recovery run's fault mix: the FULL standard set (drops,
    stragglers, actor crashes, receiver stalls) PLUS the learner-kill
    script — two service kills inside ``duration_s`` (the acceptance
    bar: the service dies >= 2x mid-run), a 1 s snapshot cadence and a
    bounded-backoff supervisor."""
    import dataclasses as _dc

    return _dc.replace(
        default_chaos(seed),
        service_kill_every_s=duration_s / 3.5,
        service_kill_count=2,
        service_snapshot_every_s=1.0,
        service_restart_max=3,
        service_restart_backoff_s=0.25,
    )


def run_sweep(
    ns=SWEEP_NS,
    duration_s: float = 10.0,
    chaos: ChaosConfig | None = None,
    **overrides,
) -> dict:
    """Run the fleet harness at each N; returns the sweep artifact."""
    chaos = default_chaos() if chaos is None else chaos
    rows = []
    for n in ns:
        cfg = FleetConfig(n_actors=int(n), duration_s=duration_s,
                          chaos=chaos, **overrides)
        result = FleetHarness(cfg).run()
        result.pop("chaos_log", None)  # deterministic from the seed
        rows.append(result)
    base = FleetConfig(chaos=chaos, **overrides)
    return {
        "metric": "fleet_rows_per_sec",
        "unit": "rows/sec",
        "schema": 1,
        "sweep": rows,
        "config": {
            "rows_per_sec_per_actor": base.rows_per_sec,
            "block_rows": base.block_rows,
            "obs_dim": base.obs_dim,
            "act_dim": base.act_dim,
            "ingest_capacity": base.ingest_capacity,
            "shed_watermark": base.shed_watermark,
            "heartbeat_timeout": base.heartbeat_timeout,
            "send_timeout": base.send_timeout,
            "max_retries": base.max_retries,
            "mode": base.mode,
            "ingest_shards": base.ingest_shards,
            "codec": base.resolved_codec(),
            "chaos": dataclasses.asdict(chaos),
        },
    }


def shard_sweep(
    ks=(1, 2, 4),
    n_actors: int = 256,
    duration_s: float = 10.0,
    rows_per_sec: float = 60.0,
    chaos: ChaosConfig | None = None,
    trace_sample: float | None = None,
    **overrides,
) -> dict:
    """The multi-core receiver sweep: FIXED N, ingest shards K ∈ ``ks``.

    Offered load is raised (default 60 rows/s/lane = 15,360 rows/s at
    N=256) so the RECEIVER is the saturated stage: at 20 rows/s a lane
    the sweep is offered-load-limited above ~5,120 rows/s and no receiver
    change could show. ``codec='auto'``: the K=1 row runs the legacy npz
    plane (one receiver core); K>=2 rows run the sharded plane end to end
    (v2 raw frames, zero-decode admission, shard-worker decode, ordered
    merge commit). Each row reports ``rows_per_sec_per_shard``; the
    summary adds scaling efficiency vs K=1 and vs the reference's priced
    single-core ceiling (5,200 rows/s, a figure of the reference's host,
    kept as the reference's artifact keeps it).

    ``trace_sample`` (default ``obs.trace.DEFAULT_SAMPLE``) arms
    wire-to-grad tracing on the K≥2 rows, so the scaling table carries
    per-stage latency attribution NEXT TO ``lock_wait_ms`` — flat
    scaling now names its stage, not just its lock. The K=1 legacy-npz
    row is deliberately untraced (npz frames carry no extension; that
    row measures the single-receiver plane as it is)."""
    from d4pg_tpu_torch.obs.trace import DEFAULT_SAMPLE

    if trace_sample is None:
        trace_sample = DEFAULT_SAMPLE
    chaos = default_chaos() if chaos is None else chaos
    rows = []
    for k in ks:
        cfg = FleetConfig(n_actors=int(n_actors), duration_s=duration_s,
                          rows_per_sec=rows_per_sec, ingest_shards=int(k),
                          chaos=chaos,
                          trace_sample=(trace_sample if int(k) > 1 else 0.0),
                          **overrides)
        result = FleetHarness(cfg).run()
        result.pop("chaos_log", None)
        rows.append(result)
    base = rows[0]["rows_per_sec"] if rows else 0.0
    return {
        "n_actors": int(n_actors),
        "rows_per_sec_per_actor": rows_per_sec,
        "offered_rows_per_sec": round(n_actors * rows_per_sec, 1),
        "single_core_ceiling_rows_per_sec": 5200.0,  # the reference's
        "sweep": rows,
        "scaling": [
            {
                "ingest_shards": r["ingest_shards"],
                "rows_per_sec": r["rows_per_sec"],
                "rows_per_sec_per_shard": r["rows_per_sec_per_shard"],
                "speedup_vs_k1": (round(r["rows_per_sec"] / base, 2)
                                  if base else None),
                "efficiency": (round(r["rows_per_sec"]
                                     / (base * r["ingest_shards"]), 2)
                               if base else None),
                "vs_ceiling": round(r["rows_per_sec"] / 5200.0, 2),
                # per-K lock-wait attribution (core/locking.py sentinels):
                # on a multi-core receiver host, flat rows/s with rising
                # lock_wait_ms fingers contention, not CPU, as the limit
                "lock_wait_ms": _lock_wait_ms(r),
                "hierarchy_violations": (
                    r["locks"]["hierarchy_violations"]
                    if r.get("locks") else None),
                # per-K STAGE attribution (obs/trace spans): where a
                # frame's time goes between socket write and commit —
                # the column that turns "K didn't scale" into "decode
                # saturated" vs "the merge floor stalled". None on the
                # untraced K=1 legacy row.
                "stage_ms": _stage_attribution(r),
            }
            for r in rows
        ],
    }


def recovery_probe(seed: int = 0, blocks: int = 48, block_rows: int = 32,
                   obs_dim: int = 12, act_dim: int = 3,
                   cut: int = 24, lost: int = 4) -> dict:
    """The post-restore bitwise oracle: kill-and-restore must equal an
    uninterrupted run, modulo the declared losses.

    Deterministic, no sockets: incarnation A ingests blocks ``[0, cut)``,
    snapshots, ingests ``lost`` more (the in-flight rows a real crash
    forgets) and is SIGKILL-equivalently torn down. Incarnation B is
    built at the next generation, restores the snapshot, and ingests the
    remainder ``[cut+lost, blocks)``. The oracle C ingests exactly the
    surviving blocks in one uninterrupted life. B's buffer must equal
    C's BITWISE (columns, PER tree, write head) — recovery is
    exactly-once w.r.t. committed rows, with the ``lost`` blocks
    appearing ONLY in the declared-loss ledger."""
    import numpy as np

    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.fleet.sender import synthetic_block
    from d4pg_tpu_torch.replay.uniform import ReplayBuffer

    capacity = blocks * block_rows  # no wraparound: the cut stays legible

    def mk(generation: int = 0) -> ReplayService:
        return ReplayService(ReplayBuffer(capacity, obs_dim, act_dim),
                             generation=generation)

    def block(i: int):
        return synthetic_block(block_rows, obs_dim, act_dim,
                               seed=seed * 100_003 + i)

    a = mk()
    for i in range(cut):
        a.add(block(i), actor_id="probe")
    a.flush(timeout=10.0)
    snap = a.snapshot()
    for i in range(cut, cut + lost):
        a.add(block(i), actor_id="probe")
    a.flush(timeout=10.0)
    rows_lost = a.env_steps - int(snap["env_steps"])
    a.kill()  # abrupt: the post-snapshot rows die undeclared-nowhere-else

    b = mk(generation=int(snap["generation"]) + 1)
    b.restore(snap)
    survivors = list(range(cut)) + list(range(cut + lost, blocks))
    for i in range(cut + lost, blocks):
        b.add(block(i), actor_id="probe")
    b.flush(timeout=10.0)
    b_state = b.replay_state()
    b_rows = b.env_steps
    b.close()

    c = mk()
    for i in survivors:
        c.add(block(i), actor_id="probe")
    c.flush(timeout=10.0)
    c_state = c.replay_state()
    c.close()

    def bitwise(x, y) -> bool:
        if isinstance(x, dict):
            return (isinstance(y, dict) and x.keys() == y.keys()
                    and all(bitwise(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)):
            return (isinstance(y, (list, tuple)) and len(x) == len(y)
                    and all(bitwise(a_, b_) for a_, b_ in zip(x, y)))
        xa, ya = np.asarray(x), np.asarray(y)
        return xa.dtype == ya.dtype and bool(np.array_equal(xa, ya))

    return {
        "oracle_bitwise_equal": bitwise(b_state, c_state),
        "rows_lost_declared": int(rows_lost),
        "rows_compared": int(b_rows),
        "blocks": int(blocks),
        "blocks_lost": int(lost),
        "seed": int(seed),
    }


def run_recovery(
    n_actors: int = 64,
    duration_s: float = 10.0,
    ingest_shards: int = 2,
    rows_per_sec: float = 30.0,
    seed: int = 0,
    chaos: ChaosConfig | None = None,
    **overrides,
) -> dict:
    """The recovery block: one service_chaos run (full fault
    set + the seeded learner-kill script) flattened to the recovery
    headline numbers, plus the deterministic bitwise oracle probe."""
    chaos = (default_service_chaos(seed, duration_s) if chaos is None
             else chaos)
    cfg = FleetConfig(n_actors=int(n_actors), duration_s=duration_s,
                      ingest_shards=int(ingest_shards),
                      rows_per_sec=rows_per_sec, codec="raw", chaos=chaos,
                      **overrides)
    result = FleetHarness(cfg).run()
    result.pop("chaos_log", None)
    sc = result.get("service_chaos") or {}
    locks = result.get("locks")
    return {
        "metric": "fleet_recovery",
        "schema": 1,
        "n_actors": int(n_actors),
        "ingest_shards": int(ingest_shards),
        "duration_s": result["duration_s"],
        "kills": sc.get("kills", 0),
        "restarts": sc.get("restarts", 0),
        "failed_restarts": sc.get("failed_restarts", 0),
        "mttr_s": sc.get("mttr_s"),
        "snapshots": sc.get("snapshots", 0),
        "rows_fenced": sc.get("rows_fenced", 0),
        "frames_fenced": sc.get("frames_fenced", 0),
        "rows_lost_to_crash": sc.get("rows_lost_to_crash", 0),
        "final_generation": sc.get("final_generation"),
        "reconnect_storm": sc.get("reconnect_storm"),
        "rows_inserted": result["rows_inserted"],
        "deadlocks": result["deadlocks"],
        "hierarchy_violations": (locks["hierarchy_violations"]
                                 if locks else None),
        "oracle": recovery_probe(seed=seed),
        "chaos": dataclasses.asdict(chaos),
        "seed": int(seed),
    }


def run_weights(
    n_pullers: int = 64,
    relay_depth: int = 2,
    duration_s: float = 8.0,
    seed: int = 0,
    learner_kills: int = 1,
    **overrides,
) -> dict:
    """The weights block: one weight-chaos run
    (``fleet/weight_chaos.py`` — N pullers across a relay tree, torn/
    stale injection, relay crash, learner kill at generation+1) reported
    as the broadcast headline numbers + the three run-gating oracles
    (ledger / trace orphans / lock hierarchy)."""
    from d4pg_tpu_torch.fleet.weight_chaos import (
        WeightChaosConfig,
        run_weight_chaos,
    )

    return run_weight_chaos(WeightChaosConfig(
        n_pullers=int(n_pullers), relay_depth=int(relay_depth),
        duration_s=float(duration_s), learner_kills=int(learner_kills),
        seed=int(seed), **overrides))


def run_learners(
    ns=(1, 2, 4),
    duration_s: float = 4.0,
    seed: int = 0,
    replica_kills: int = 2,
    mode: str = "async",
    **overrides,
) -> dict:
    """The learners block (``fleet/learner_chaos.py``):
    updates/s vs replica count from kill-free rows (the scaling story —
    staleness percentiles and correction-clip rate per N), then ONE
    chaos row at N=max(ns) with seeded replica kills — in-flight-frame
    fencing, ledger monotonicity, trace orphans and the lock hierarchy
    are its run-gating oracles."""
    from d4pg_tpu_torch.fleet.learner_chaos import (
        LearnerChaosConfig,
        run_learner_chaos,
    )

    sweep = []
    for n in ns:
        r = run_learner_chaos(LearnerChaosConfig(
            n_replicas=int(n), duration_s=float(duration_s),
            replica_kills=0, torn_prob=0.0, mode=mode, seed=int(seed),
            **overrides))
        sweep.append({
            "n_replicas": int(n),
            "updates_per_sec": r["updates_per_sec"],
            "staleness": r["staleness"],
            "clip_rate": r["clip_rate"],
            "ledger_monotone": r["ledger"]["monotone"],
            "trace_orphans": r["trace"]["orphans"],
            "hierarchy_violations": r["hierarchy_violations"],
        })
    chaos_row = run_learner_chaos(LearnerChaosConfig(
        n_replicas=int(max(ns)), duration_s=float(duration_s),
        replica_kills=int(replica_kills), mode=mode, seed=int(seed),
        **overrides))
    return {"metric": "fleet_learners", "schema": 1, "mode": mode,
            "sweep": sweep, "chaos": chaos_row, "seed": int(seed)}


def run_mesh_learners(
    ns=(1, 2, 4),
    rounds: int = 6,
    steps_per_round: int = 8,
    mode: str = "async",
    seed: int = 0,
    device: str | None = None,
    **overrides,
) -> dict:
    """The mesh_learners block (``fleet/mesh_ab.py``): the
    socket-vs-collective aggregation A/B at equal offered load per
    replica count — updates/s on each arm plus per-round aggregation
    latency p50/p95, the measurement that attributes the mesh-native
    transport's win to the transport (grad work is identical by
    construction). Runs on ``device`` (the card by default); the port
    stacks replicas on the cards there are, so every N runs."""
    from d4pg_tpu_torch import resolve_device
    from d4pg_tpu_torch.fleet.mesh_ab import MeshABConfig, run_mesh_ab

    dev = resolve_device(device)
    sweep = [run_mesh_ab(MeshABConfig(
        n_replicas=int(n), rounds=int(rounds),
        steps_per_round=int(steps_per_round), mode=mode, seed=int(seed),
        **overrides), device=dev) for n in ns]
    return {"metric": "fleet_mesh_learners", "schema": 1, "mode": mode,
            "backend": dev.type, "sweep": sweep, "seed": int(seed)}


def run_sampler(
    n_actors: int = 64,
    duration_s: float = 6.0,
    seed: int = 0,
    learner_kills: int = 2,
    stale_frames: int = 8,
    **overrides,
) -> dict:
    """The sampler block (``fleet/sampler_chaos.py``):

    - **ab**: a fault-free three-arm sweep — host vs dealer vs device
      (the descent on ``device``) — under the SAME offered load and
      seed: wire_to_grad / deal_to_grad p95 on each arm, buffer-lock
      acquisitions on the consume path (the dealer and device arms'
      must be 0 by construction), blocks/s dealt.
    - **chaos**: one dealer-mode run at ``n_actors`` with the full
      fault set — seeded sender chaos, consumer kills + ring clears,
      shed pressure, stale-generation frame injection — gated by the
      run oracles (0 deadlocks / violations / orphans / dealt dead
      tickets).
    """
    from d4pg_tpu_torch.fleet.sampler_chaos import (
        SamplerChaosConfig,
        run_sampler_chaos,
    )

    ab = {}
    for path in ("host", "dealer", "device"):
        r = run_sampler_chaos(
            SamplerChaosConfig(
                sample_path=path, n_actors=int(n_actors),
                duration_s=float(duration_s), learner_kills=0,
                stale_frames=0, seed=int(seed), **overrides),
            chaos=ChaosConfig(seed=int(seed)))
        ab[path] = {
            "wire_to_grad_p95_ms": r["wire_to_grad_p95_ms"],
            "deal_to_grad_p95_ms": r["deal_to_grad_p95_ms"],
            "sample_path_buffer_acqs":
                r["consumer"]["sample_path_buffer_acqs"],
            "blocks_consumed": r["consumer"]["blocks_consumed"],
            "rows_inserted": r["rows_inserted"],
            "deadlocks": r["deadlocks"],
            "hierarchy_violations": r["hierarchy_violations"],
            "trace_orphans": r["trace_orphans"],
            "sampler": r["sampler"],
            "device": r["device"],
        }
    h = ab["host"]["wire_to_grad_p95_ms"]
    for path in ("dealer", "device"):
        d = ab[path]["wire_to_grad_p95_ms"]
        ab[path]["wire_to_grad_p95_delta_ms"] = (
            round(d - h, 3) if d is not None and h is not None else None)
    chaos_row = run_sampler_chaos(SamplerChaosConfig(
        sample_path="dealer", n_actors=int(n_actors),
        duration_s=float(duration_s), learner_kills=int(learner_kills),
        stale_frames=int(stale_frames), seed=int(seed), **overrides),
        chaos=default_chaos(int(seed)))
    return {"metric": "fleet_sampler", "schema": 1, "n_actors": int(n_actors),
            "ab": ab, "chaos": chaos_row, "seed": int(seed)}


def run_serving(
    lane_counts=(1, 2, 4),
    envs_per_lane: int = 4,
    duration_s: float = 3.0,
    seed: int = 0,
    server_kills: int = 1,
    torn_prob: float = 0.05,
    pair_lanes: int | None = None,
    **overrides,
) -> dict:
    """The serving block (``fleet/serving_chaos.py``):
    actions/s vs lane count from fault-free rows (batch occupancy and
    request latency percentiles per row), ONE batched-vs-unbatched pair
    at ``pair_lanes`` (default ``max(lane_counts)`` floored at 16 —
    continuous batching is a concurrency claim, and at a handful of
    closed-loop single-row lanes the amortization margin sits inside
    one-core scheduling noise) with single-row requests — the continuous-
    batching claim measured on the same wire, BOTH arms at zero window
    so exactly one thing differs: the batched arm coalesces every
    pending request into one dispatch (``max_batch_rows`` default)
    while the unbatched arm pops one request per dispatch
    (``max_batch_rows=1``), i.e. N independent single-row dispatches.
    Zero window is the greedy continuous-batching configuration —
    requests that arrive while a dispatch is in flight coalesce into
    the next one — and is what isolates dispatch amortization from the
    window's latency tax (the nonzero default window only pays off for
    multi-row requests; the sweep rows above measure that default).
    Also one chaos row (seeded server kills + torn responses) with its
    MTTR and run-gating oracles. One-core caveat: lanes, server and
    publisher share the host, so absolute actions/s is conservative;
    the batched/unbatched ratio is the honest headline."""
    from d4pg_tpu_torch.fleet.serving_chaos import run_serving_chaos

    sweep = []
    for n in lane_counts:
        r = run_serving_chaos(
            n_lanes=int(n), envs_per_lane=int(envs_per_lane),
            duration_s=float(duration_s), server_kills=0, torn_prob=0.0,
            seed=int(seed), **overrides)
        sweep.append({
            "n_lanes": int(n),
            "actions_per_sec": r["actions_per_sec"],
            "requests": r["requests"],
            "served": r["served"],
            "fallbacks": r["fallbacks"],
            "batch_occupancy": r["batch_occupancy"],
            "latency_ms": r["latency_ms"],
            "trace_orphans": r["trace"]["orphans"],
            "hierarchy_violations": r["hierarchy_violations"],
        })

    # the batching claim: same lanes, same wire, single-row requests,
    # both arms at zero window; only the coalescing cap differs
    n_pair = int(pair_lanes if pair_lanes is not None
                 else max(max(lane_counts), 16))
    batched = run_serving_chaos(
        n_lanes=n_pair, envs_per_lane=1, duration_s=float(duration_s),
        server_kills=0, torn_prob=0.0, seed=int(seed) + 1,
        batch_window_s=0.0, **overrides)
    unbatched = run_serving_chaos(
        n_lanes=n_pair, envs_per_lane=1, duration_s=float(duration_s),
        server_kills=0, torn_prob=0.0, seed=int(seed) + 1,
        batch_window_s=0.0, max_batch_rows=1, **overrides)
    pair = {
        "n_lanes": n_pair,
        "batched_actions_per_sec": batched["actions_per_sec"],
        "unbatched_actions_per_sec": unbatched["actions_per_sec"],
        "speedup": (round(batched["actions_per_sec"]
                          / unbatched["actions_per_sec"], 3)
                    if unbatched["actions_per_sec"] else None),
        "batched_latency_ms": batched["latency_ms"],
        "unbatched_latency_ms": unbatched["latency_ms"],
        "batched_occupancy": batched["batch_occupancy"],
    }

    chaos_row = run_serving_chaos(
        n_lanes=int(max(lane_counts)), envs_per_lane=int(envs_per_lane),
        duration_s=float(duration_s), server_kills=int(server_kills),
        torn_prob=float(torn_prob), seed=int(seed), **overrides)
    return {"metric": "fleet_serving", "schema": 1, "sweep": sweep,
            "batching": pair, "chaos": chaos_row, "seed": int(seed)}


def run_elastic(seed: int = 0, **overrides) -> dict:
    """The elastic block (``fleet/elastic_chaos.py``): the
    flash-crowd A/B drill — identical seeded offered load (the traffic
    model's schedule is a pure recurrence over each lane's model clock)
    through a static arm and an autoscaler arm — plus the offered-load
    determinism probe (two models from the same config must emit the
    bit-identical fleet curve). The drill's ``ab_gate`` must pass in
    a full-length run: strictly fewer serving SLO breaches AND
    strictly fewer ingest shed rows in the autoscaler arm, with the
    scaling ledger replaying bit-identically from its recorded
    signals."""
    import numpy as np

    from d4pg_tpu_torch.elastic.traffic import TrafficModel
    from d4pg_tpu_torch.fleet.elastic_chaos import (
        ElasticChaosConfig,
        run_elastic_chaos,
    )

    drill = run_elastic_chaos(seed=int(seed), **overrides)
    cfg = ElasticChaosConfig(seed=int(seed))
    tcfg = cfg.serving_traffic()
    dt = cfg.model_horizon_s / 48.0
    offered = TrafficModel(tcfg).fleet_trace(cfg.model_horizon_s, dt)
    replayed = TrafficModel(tcfg).fleet_trace(cfg.model_horizon_s, dt)
    return {
        "metric": "fleet_elastic",
        "schema": 1,
        "offered_rows_per_s": [round(float(x), 2) for x in offered],
        "offered_deterministic": bool(np.array_equal(offered, replayed)),
        "drill": drill,
        "seed": int(seed),
    }


def _lock_wait_ms(row: dict) -> float | None:
    """Total contended-acquisition wait across every tiered lock."""
    locks = row.get("locks")
    if not locks:
        return None
    return round(sum(per["wait_ns"]
                     for per in locks["per_lock"].values()) / 1e6, 3)


# The stage pairs the scaling table surfaces (p95 of each, ms) — the
# full histograms stay in the row's ``latency`` block.
_STAGE_COLUMNS = ("wire_to_admission", "admission_to_decode",
                  "decode_to_stage", "stage_to_merge", "merge_to_commit",
                  "wire_to_commit", "wire_to_grad")


def _stage_attribution(row: dict) -> dict | None:
    """p95 per pipeline stage from the row's trace-span latency block."""
    lat = row.get("latency")
    if not lat or not lat.get("stages"):
        return None
    return {name: lat["stages"][name]["p95"]
            for name in _STAGE_COLUMNS if name in lat["stages"]}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="d4pg_tpu_torch.fleet.sweep")
    ap.add_argument("--ns", type=int, nargs="+", default=list(SWEEP_NS))
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rows_per_sec", type=float, default=20.0)
    ap.add_argument("--block_rows", type=int, default=16)
    ap.add_argument("--mode", choices=("thread", "process", "actor"),
                    default="thread")
    ap.add_argument("--ingest_shards", type=int, default=1,
                    help="receiver-side ingest shards K (SO_REUSEPORT "
                         "listeners + K decode workers + ordered merge)")
    ap.add_argument("--codec", choices=("auto", "npz", "raw"),
                    default="auto")
    ap.add_argument("--shards_sweep", type=int, nargs="+", default=None,
                    metavar="K",
                    help="run the fixed-N shard sweep over these K values "
                         "instead of the N sweep (e.g. --shards_sweep 1 2 4)")
    ap.add_argument("--trace_sample", type=float, default=None,
                    help="wire-to-grad trace sampling rate (raw codec "
                         "only; shard sweep default: obs.trace."
                         "DEFAULT_SAMPLE on K>=2 rows, N sweep default: "
                         "off)")
    ap.add_argument("--weights", action="store_true",
                    help="run the weight-chaos harness (broadcast plane: "
                         "N pullers over a relay tree, torn/stale/kill "
                         "faults) instead of the ingest sweep")
    ap.add_argument("--relay_depth", type=int, default=2)
    ap.add_argument("--learners", type=int, nargs="+", default=None,
                    help="run the multi-learner block instead: updates/s "
                         "vs these replica counts + one replica-kill "
                         "chaos row (fleet/learner_chaos.py)")
    ap.add_argument("--sampler", action="store_true",
                    help="run the sample-on-ingest block instead: a "
                         "dealer-vs-host A/B pair + one dealer chaos row "
                         "(consumer kills, shed pressure, stale-gen "
                         "injection — fleet/sampler_chaos.py)")
    ap.add_argument("--serving", type=int, nargs="+", default=None,
                    metavar="LANES",
                    help="run the serving block instead: actions/s vs "
                         "these lane counts, a batched-vs-unbatched pair "
                         "and one server-kill chaos row "
                         "(fleet/serving_chaos.py)")
    ap.add_argument("--elastic", action="store_true",
                    help="run the elastic block instead: the flash-crowd "
                         "autoscaler-on/off A/B drill at equal seeded "
                         "offered load (fleet/elastic_chaos.py)")
    ap.add_argument("--device", default=None,
                    help="where the serving drill's server, the sampler "
                         "drill's device arm and the elastic drill's "
                         "server run (default: the card, raising without "
                         "one; 'cpu' for a host run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_chaos", action="store_true",
                    help="clean-plane control run (all fault probs 0)")
    ap.add_argument("--out", default=None,
                    help="also write the artifact JSON to this path")
    ns = ap.parse_args(argv)
    chaos = (ChaosConfig(seed=ns.seed) if ns.no_chaos
             else default_chaos(ns.seed))
    on = {} if ns.device is None else {"device": ns.device}
    if ns.elastic:
        artifact = run_elastic(seed=ns.seed, **on)
    elif ns.sampler:
        artifact = run_sampler(
            n_actors=max(ns.ns), duration_s=ns.seconds, seed=ns.seed, **on,
            **({"learner_kills": 0, "stale_frames": 0}
               if ns.no_chaos else {}))
    elif ns.serving:
        artifact = run_serving(
            lane_counts=tuple(ns.serving), duration_s=ns.seconds,
            seed=ns.seed, **on,
            **({"server_kills": 0, "torn_prob": 0.0}
               if ns.no_chaos else {}))
    elif ns.learners:
        artifact = run_learners(
            ns=tuple(ns.learners), duration_s=ns.seconds, seed=ns.seed,
            **({"replica_kills": 0, "torn_prob": 0.0}
               if ns.no_chaos else {}))
    elif ns.weights:
        artifact = run_weights(
            n_pullers=max(ns.ns), relay_depth=ns.relay_depth,
            duration_s=ns.seconds, seed=ns.seed,
            **({"torn_prob": 0.0, "stale_prob": 0.0, "learner_kills": 0,
                "relay_kills": 0} if ns.no_chaos else {}))
    elif ns.shards_sweep:
        artifact = shard_sweep(ks=tuple(ns.shards_sweep),
                               n_actors=max(ns.ns), duration_s=ns.seconds,
                               rows_per_sec=ns.rows_per_sec, chaos=chaos,
                               block_rows=ns.block_rows, codec=ns.codec,
                               trace_sample=ns.trace_sample)
    else:
        artifact = run_sweep(ns=tuple(ns.ns), duration_s=ns.seconds,
                             chaos=chaos, rows_per_sec=ns.rows_per_sec,
                             block_rows=ns.block_rows, mode=ns.mode,
                             ingest_shards=ns.ingest_shards, codec=ns.codec,
                             trace_sample=ns.trace_sample or 0.0)
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump(artifact, f, indent=2)
    print(json.dumps(artifact))


if __name__ == "__main__":
    main()
