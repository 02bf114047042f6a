"""Socket-vs-collective aggregation A/B: the ``mesh_learners`` row.

Counterpart of ``d4pg_tpu/fleet/mesh_ab.py``. Both arms run the same
offered load (N replicas with identical networks, their own generators,
identically filled fused rings, ``rounds`` timed rounds of
``steps_per_round`` fused grad steps per replica at the same (k, batch))
and differ only in how a round's updates become the next round's basis:

- **socket** arm: the host-thread plane (``--agg_transport socket``).
  Each replica thread trains through ``FusedLoop`` and then pays the
  host round trip: a device-to-host copy of all four networks
  (``params_of``), the aggregator's host numpy merge, and the
  host-to-device copy of the basis it adopts (``adopt_params``);
- **collective** arm: ``MeshReplicaGroup`` (``--agg_transport
  collective``): the same fused chunk per replica, the merge and the
  adoption on the device.

Per-round aggregation latency (p50/p95 over the timed rounds) is the
headline: the grad work is the same by construction. Each arm's latency
ends in a device synchronize (the socket arm's copies wait for the card
anyway; the collective merge is only queued until then). One warm-up
round per arm comes first. The reference shards the collective arm one
replica per device and refuses more replicas than devices; the port
stacks the replicas on the cards there are (``parallel/mesh.replica_mesh``).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.registry import percentile_summary


@dataclasses.dataclass(frozen=True)
class MeshABConfig:
    """One socket-vs-collective pair at ``n_replicas``. ``(config,
    seed)`` fixes the fills, the initial states and the sampling streams,
    so the two arms train on the same work."""

    n_replicas: int = 2
    rounds: int = 6  # timed rounds (one extra warm-up round each)
    steps_per_round: int = 8
    k: int = 4
    batch_size: int = 32
    n_rows: int = 512
    obs_dim: int = 8
    act_dim: int = 2
    hidden: tuple = (32, 32)
    mode: str = "async"
    clip: float = 8.0
    seed: int = 0


def _learner_config(cfg: MeshABConfig):
    from d4pg_tpu_torch.learner.state import D4PGConfig

    return D4PGConfig(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim,
                      v_min=-10.0, v_max=10.0, n_atoms=51,
                      hidden=tuple(cfg.hidden))


def _fill(cfg: MeshABConfig, device):
    """A deterministically filled fused ring (one per replica in the
    socket arm: ``FusedLoop`` is its ring's single consumer)."""
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_rows
    rows = TransitionBatch(
        obs=rng.standard_normal((n, cfg.obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, cfg.act_dim)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, cfg.obs_dim)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32))
    buf = FusedDeviceReplay(n, cfg.obs_dim, cfg.act_dim, alpha=0.6,
                            device=device)
    for start in range(0, n, buf.block_rows):
        buf.add(TransitionBatch(*[f[start:start + buf.block_rows]
                                  for f in rows]))
        buf.drain()
    return buf


def _replica_states(config, n: int, device, seed: int):
    """The driver's replica construction (``replica_state``)."""
    from d4pg_tpu_torch.learner.replica import replica_state
    from d4pg_tpu_torch.learner.state import init_state

    base = init_state(config, seed, device)
    return [replica_state(base, i, seed) for i in range(n)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_socket_arm(cfg: MeshABConfig, config, device) -> dict:
    """N host-thread replicas through the in-process ``Aggregator`` (the
    driver's socket wiring minus the TCP hop)."""
    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.learner.aggregator import Aggregator
    from d4pg_tpu_torch.learner.loop import FusedLoop
    from d4pg_tpu_torch.learner.replica import adopt_params, params_of

    n = cfg.n_replicas
    agg = Aggregator(WeightStore(), mode=cfg.mode, clip=cfg.clip)
    states = _replica_states(config, n, device, cfg.seed)
    loops = [FusedLoop(config, _fill(cfg, device), k=cfg.k,
                       batch_size=cfg.batch_size,
                       generator=states[i].generator) for i in range(n)]
    epochs = [agg.register(i) for i in range(n)]
    bvs = [0] * n  # each replica's last pulled basis version
    agg_lat: list[float] = []

    def fanout(fn) -> None:
        def runner(i: int) -> None:
            try:
                fn(i)
            except Exception as e:  # noqa: BLE001 — top frame of the lane
                contained_crash("mesh_ab.replica", e)

        threads = [threading.Thread(target=runner, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def round_once(timed: bool) -> None:
        fanout(lambda i: loops[i].run(states[i], cfg.steps_per_round))
        _sync(device)
        t0 = time.perf_counter()

        def submit(i: int) -> None:
            agg.submit(i, epochs[i], params_of(states[i]), bvs[i],
                       step=cfg.steps_per_round)

        fanout(submit)

        def adopt(i: int) -> None:
            bvs[i], basis = agg.basis(i)
            if basis is not None:
                adopt_params(states[i], basis)

        fanout(adopt)
        _sync(device)
        if timed:
            agg_lat.append(time.perf_counter() - t0)

    round_once(timed=False)  # warm-up
    t_start = time.perf_counter()
    for _ in range(cfg.rounds):
        round_once(timed=True)
    wall = time.perf_counter() - t_start
    for loop in loops:
        loop.close()
    agg.close()
    updates = n * cfg.rounds * cfg.steps_per_round
    return {"updates_per_sec": round(updates / wall, 1),
            "wall_s": round(wall, 4),
            "agg_latency_s": percentile_summary(agg_lat)}


def _run_collective_arm(cfg: MeshABConfig, config, device) -> dict:
    """The same load through ``MeshReplicaGroup``."""
    from d4pg_tpu_torch.learner.mesh_replicas import MeshReplicaGroup

    group = MeshReplicaGroup(
        config, _replica_states(config, cfg.n_replicas, device, cfg.seed),
        k=cfg.k, batch_size=cfg.batch_size, mode=cfg.mode, clip=cfg.clip)
    group.load(_fill(cfg, device))
    group.run_round(cfg.steps_per_round)  # warm-up
    merge_lat: list[float] = []
    t_start = time.perf_counter()
    for _ in range(cfg.rounds):
        group._fused_steps(cfg.steps_per_round)
        _sync(device)
        t0 = time.perf_counter()
        group.merge()
        _sync(device)
        merge_lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_start
    group.close()
    updates = cfg.n_replicas * cfg.rounds * cfg.steps_per_round
    return {"updates_per_sec": round(updates / wall, 1),
            "wall_s": round(wall, 4),
            "agg_latency_s": percentile_summary(merge_lat)}


def run_mesh_ab(cfg: MeshABConfig | None = None, *, device=None,
                **overrides) -> dict:
    """One A/B pair at ``cfg.n_replicas`` on ``device`` (the card by
    default; raises without one): both arms over the same offered load,
    and the ratios."""
    cfg = dataclasses.replace(cfg or MeshABConfig(), **overrides)
    device = resolve_device(device)
    config = _learner_config(cfg)
    socket = _run_socket_arm(cfg, config, device)
    collective = _run_collective_arm(cfg, config, device)
    p50_s, p50_c = (socket["agg_latency_s"]["p50"],
                    collective["agg_latency_s"]["p50"])
    return {
        "metric": "mesh_learners_ab",
        "schema": 1,
        "n_replicas": cfg.n_replicas,
        "mode": cfg.mode,
        "clip": cfg.clip,
        "backend": device.type,
        "load": {
            "rounds": cfg.rounds,
            "steps_per_round": cfg.steps_per_round,
            "k": cfg.k,
            "batch_size": cfg.batch_size,
            "obs_dim": cfg.obs_dim,
            "act_dim": cfg.act_dim,
            "hidden": list(cfg.hidden),
        },
        "socket": socket,
        "collective": collective,
        "speedup_updates_per_sec": round(
            collective["updates_per_sec"] / socket["updates_per_sec"], 3)
        if socket["updates_per_sec"] else None,
        "agg_latency_ratio_p50": round(p50_s / p50_c, 3)
        if p50_s and p50_c else None,
        "seed": cfg.seed,
    }
