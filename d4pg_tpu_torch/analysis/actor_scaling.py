"""Measure local actor-process scaling: env-steps/sec against process count.

Counterpart of ``d4pg_tpu/analysis/actor_scaling.py``. N spawned actor
processes (the port's ``actor_main.run_local_actor_process``, each on the
CPU) stream transitions to the learner's TCP plane (``train.py
--actor_procs``). This tool boots ONLY the ingest plane (replay service,
transition receiver and weight server, no learner) and counts arriving
env steps over a fixed window:

    python -m d4pg_tpu_torch.analysis.actor_scaling --procs 1 2 4 --seconds 10

It also renders the fleet scaling curve from a sweep artifact (the JSON
``python -m d4pg_tpu_torch.fleet.sweep --out FILE`` writes): rows/s
against N with p99 send latency and the per-N loss and recovery
counters, as a table and optionally a PNG:

    python -m d4pg_tpu_torch.analysis.actor_scaling --fleet FILE \\
        --plot fleet.png
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import time


def measure(n_procs: int, seconds: float, env: str = "point",
            num_envs: int = 8, max_steps: int = 200) -> float:
    from d4pg_tpu_torch.actor_main import run_local_actor_process
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.distributed.transport import TransitionReceiver
    from d4pg_tpu_torch.distributed.weight_server import WeightServer
    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.replay.uniform import ReplayBuffer
    from d4pg_tpu_torch.train import infer_dims

    cfg = ExperimentConfig(env=env, num_envs=num_envs, max_steps=max_steps,
                           v_min=-5.0, v_max=0.0)
    obs_dim, act_dim, obs_dtype = infer_dims(cfg)
    service = ReplayService(
        ReplayBuffer(1_000_000, obs_dim, act_dim, obs_dtype=obs_dtype))
    weights = WeightStore()
    receiver = TransitionReceiver(
        lambda b, aid, count: service.add(b, actor_id=aid,
                                          count_env_steps=count),
        host="127.0.0.1")
    weight_server = WeightServer(weights, host="127.0.0.1")

    ctx = mp.get_context("spawn")
    procs = []
    for i in range(n_procs):
        p = ctx.Process(
            target=run_local_actor_process,
            args=(dataclasses.replace(cfg, seed=1000 * (i + 1)), "127.0.0.1",
                  receiver.port, weight_server.port, f"scale-{i}", None),
            daemon=True,
        )
        p.start()
        procs.append(p)

    # let the fleet finish its torch and env startup before the window
    deadline = time.monotonic() + 120.0
    while service.env_steps < n_procs * num_envs and time.monotonic() < deadline:
        time.sleep(0.1)
    start_steps = service.env_steps
    t0 = time.monotonic()
    time.sleep(seconds)
    rate = (service.env_steps - start_steps) / (time.monotonic() - t0)

    for p in procs:
        p.terminate()
    for p in procs:
        p.join(timeout=5.0)
    receiver.close()
    weight_server.close()
    service.close()
    return rate


def measure_budget(obs_dim: int = 376, act_dim: int = 17, rows: int = 8,
                   frames: int = 2000) -> dict:
    """Per-component cost of one transition frame on the streaming plane:
    encode (pickle), socket+decode+ingest-callback (loopback TCP through
    the real ``TransitionReceiver``), and the replay ``service.add`` — the
    measured budget for where actor fan-out saturates. Frame shape = one
    actor tick of ``rows`` Humanoid-sized transitions."""
    import threading

    import numpy as np

    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.distributed.transport import (
        TransitionReceiver,
        TransitionSender,
        _encode,
    )
    from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch

    rng = np.random.default_rng(0)
    batch = TransitionBatch(
        obs=rng.standard_normal((rows, obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (rows, act_dim)).astype(np.float32),
        reward=rng.standard_normal(rows).astype(np.float32),
        next_obs=rng.standard_normal((rows, obs_dim)).astype(np.float32),
        done=np.zeros(rows, np.float32),
        discount=np.full(rows, 0.99, np.float32),
    )
    out = {"rows_per_frame": rows, "obs_dim": obs_dim}

    payload = _encode("budget", batch, True)
    out["frame_bytes"] = len(payload)
    t0 = time.monotonic()
    for _ in range(frames):
        _encode("budget", batch, True)
    out["encode_us_per_frame"] = 1e6 * (time.monotonic() - t0) / frames

    # socket + decode + the PRODUCTION ingest callback (service.add, as
    # measure() and train.py wire it), through the real receiver thread;
    # the clock stops only when every row is INSERTED in the buffer (the
    # service drain thread's work counts — it shares the learner core)
    service = ReplayService(ReplayBuffer(1_000_000, obs_dim, act_dim))
    got = threading.Event()
    n_recv = 0

    def on_batch(b, aid, count):
        nonlocal n_recv
        service.add(b, actor_id=aid, count_env_steps=count)
        n_recv += 1
        if n_recv >= frames:
            got.set()

    receiver = TransitionReceiver(on_batch, host="127.0.0.1")
    sender = TransitionSender("127.0.0.1", receiver.port, actor_id="budget")
    sender.send(batch)  # connection warmup
    while n_recv < 1:
        time.sleep(0.01)
    n_recv, t0 = 0, time.monotonic()
    target = len(service.buffer) + frames * rows
    for _ in range(frames):
        sender.send(batch)
    if not got.wait(timeout=120.0):
        raise RuntimeError(
            f"ingest stalled: {n_recv}/{frames} frames in 120s")
    deadline = time.monotonic() + 30.0
    while len(service.buffer) < target:  # drain-thread completion
        if time.monotonic() > deadline:
            raise RuntimeError("replay drain stalled")
        time.sleep(0.001)
    out["socket_ingest_us_per_frame"] = 1e6 * (time.monotonic() - t0) / frames
    sender.close()
    receiver.close()
    service.close()

    # the raw locked buffer insert alone (the drain thread's inner cost)
    buf = ReplayBuffer(1_000_000, obs_dim, act_dim)
    buf.add(batch)
    t0 = time.monotonic()
    for _ in range(frames):
        buf.add(batch)
    out["buffer_insert_us_per_frame"] = 1e6 * (time.monotonic() - t0) / frames

    total_us = (out["encode_us_per_frame"]
                + out["socket_ingest_us_per_frame"])
    # encode happens actor-side (parallel across procs); the learner-side
    # serial section is socket+decode+service.add+insert — the measured
    # wall above — so IT sets the plane ceiling
    out["plane_ceiling_env_steps_per_sec"] = (
        rows * 1e6 / out["socket_ingest_us_per_frame"])
    out["single_actor_env_steps_per_sec"] = rows * 1e6 / total_us
    return out


def fleet_table(artifact: dict) -> str:
    """Format a sweep artifact (``fleet/sweep.py``) as the
    actor-scaling table: rows/s vs N with latency, losses, recovery."""
    header = (f"{'actors':>7} {'rows/s':>8} {'demand':>8} {'p50ms':>7} "
              f"{'p99ms':>7} {'drops':>7} {'sheds':>6} {'retry':>6} "
              f"{'crash':>6} {'readmit':>8} {'recov_s':>8}")
    lines = [header]
    for row in artifact["sweep"]:
        lat = row["send_latency_ms"]
        drops = row["drops"]
        rec = row["recovery"]
        lines.append(
            f"{row['n_actors']:>7} {row['rows_per_sec']:>8,.0f} "
            f"{row['demand_rows_per_sec']:>8,.0f} "
            f"{lat['p50'] if lat['p50'] is not None else float('nan'):>7.2f} "
            f"{lat['p99'] if lat['p99'] is not None else float('nan'):>7.2f} "
            f"{drops['chaos_rows'] + drops['backpressure_rows']:>7} "
            f"{drops['shed_rows']:>6} {row['retries']:>6} "
            f"{row['crashes']:>6} {row['readmissions']:>8} "
            + (f"{rec['mean_s']:>8.2f}" if rec["mean_s"] is not None
               else f"{'—':>8}"))
    shard = artifact.get("shard_sweep")
    if shard:
        lines.append("")
        lines.append(shard_table(shard))
    return "\n".join(lines)


def shard_table(shard: dict) -> str:
    """Format the ``shard_sweep`` block: rows/s vs ingest shards K at
    fixed N, with per-shard rate, speedup/efficiency vs K=1, and the
    margin over the reference's priced single-core ceiling."""
    ceiling = shard.get("single_core_ceiling_rows_per_sec", 5200.0)
    header = (f"ingest shards @ N={shard['n_actors']} "
              f"(offered {shard['offered_rows_per_sec']:,.0f} rows/s, "
              f"ceiling {ceiling:,.0f}/core)\n"
              f"{'K':>3} {'codec':>6} {'rows/s':>8} {'per-shard':>10} "
              f"{'vs K=1':>7} {'eff':>6} {'vs ceil':>8} {'p99ms':>8} "
              f"{'deadlk':>7}")
    lines = [header]
    for row, sc in zip(shard["sweep"], shard["scaling"]):
        lat = row["send_latency_ms"]
        lines.append(
            f"{row['ingest_shards']:>3} {row['codec']:>6} "
            f"{row['rows_per_sec']:>8,.0f} "
            f"{sc['rows_per_sec_per_shard']:>10,.0f} "
            f"{sc['speedup_vs_k1'] if sc['speedup_vs_k1'] is not None else float('nan'):>6.2f}x "
            f"{sc['efficiency'] if sc['efficiency'] is not None else float('nan'):>6.2f} "
            f"{sc['vs_ceiling']:>7.2f}x "
            f"{lat['p99'] if lat['p99'] is not None else float('nan'):>8.2f} "
            f"{row['deadlocks']:>7}")
    return "\n".join(lines)


def plot_fleet(artifact: dict, out_png: str) -> str:
    """Rows/s-vs-N scaling curve (with the offered demand line) and p99
    send latency on a twin axis; returns the written path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = artifact["sweep"]
    n = [r["n_actors"] for r in rows]
    rate = [r["rows_per_sec"] for r in rows]
    demand = [r["demand_rows_per_sec"] for r in rows]
    p99 = [r["send_latency_ms"]["p99"] for r in rows]
    fig, ax = plt.subplots(figsize=(7, 4.2))
    ax.plot(n, rate, "o-", label="ingested rows/s")
    ax.plot(n, demand, "--", color="gray", label="offered demand")
    ax.set_xscale("log", base=2)
    ax.set_xticks(n, [str(v) for v in n])
    ax.set_xlabel("actors (throttled sender lanes)")
    ax.set_ylabel("rows/s into the replay service")
    ax2 = ax.twinx()
    ax2.plot(n, p99, "s:", color="tab:red", label="p99 send latency")
    ax2.set_ylabel("p99 send latency (ms)")
    h1, l1 = ax.get_legend_handles_labels()
    h2, l2 = ax2.get_legend_handles_labels()
    ax.legend(h1 + h2, l1 + l2, loc="upper left")
    ax.set_title("Fleet plane scaling under chaos "
                 f"(seed {artifact['config']['chaos']['seed']})")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def main(argv=None):
    ap = argparse.ArgumentParser(prog="d4pg_tpu_torch.analysis.actor_scaling")
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--env", default="point",
                    help="'point-slow:<ms>' emulates a physics-bound env "
                         "so the plane, not the host core, is measured")
    ap.add_argument("--num_envs", type=int, default=8)
    ap.add_argument("--budget", action="store_true",
                    help="measure the per-component frame budget instead "
                         "of the scaling table")
    ap.add_argument("--fleet", default=None, metavar="ARTIFACT_JSON",
                    help="render the fleet scaling table from a sweep "
                         "artifact instead of measuring")
    ap.add_argument("--plot", default=None, metavar="OUT_PNG",
                    help="with --fleet: also write the scaling curve PNG")
    ns = ap.parse_args(argv)
    if ns.fleet:
        import json

        with open(ns.fleet) as f:
            artifact = json.load(f)
        print(fleet_table(artifact))
        if ns.plot:
            print(f"wrote {plot_fleet(artifact, ns.plot)}")
        return
    if ns.budget:
        budget = measure_budget()
        for key, val in budget.items():
            sval = f"{val:,.1f}" if isinstance(val, float) else str(val)
            print(f"{key:>34}: {sval}")
        return
    print(f"{'procs':>6} {'env-steps/sec':>14}")
    base = None
    for n in ns.procs:
        rate = measure(n, ns.seconds, env=ns.env, num_envs=ns.num_envs)
        base = base or rate
        print(f"{n:>6} {rate:>14.0f}   ({rate / base:.2f}x)")


if __name__ == "__main__":
    main()
