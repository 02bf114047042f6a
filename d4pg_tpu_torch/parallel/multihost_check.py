"""Scripted multi-rank check: N processes form one rank mesh and run the
data-parallel D4PG update.

Counterpart of ``d4pg_tpu/parallel/multihost_check.py``. Every process
runs this same program, e.g. for two ranks on the CPU:

    python -m d4pg_tpu_torch.parallel.multihost_check --device cpu \\
        --coordinator 127.0.0.1:29781 --num_processes 2 --process_id 0 &
    python -m d4pg_tpu_torch.parallel.multihost_check --device cpu \\
        --coordinator 127.0.0.1:29781 --num_processes 2 --process_id 1

(by default each rank runs on ``cuda:0`` of its host). Without
``--fused`` each rank stages its own block of the global batch and runs
two sharded updates; with ``--fused 1`` each rank fills its own shards of
a ``ShardedFusedReplay`` and runs two sharded fused chunks (the descent
per shard per step), then round-trips its shard-set through
``state_dict``. Rows and uniforms come from seeded numpy streams keyed by
the global shard, so one process holding every shard (``--n_local``) sees
the inputs the ranks see. Each rank prints ``multihost_check OK`` with its
losses; every rank must print the same losses, and the replicas must be
bitwise equal: a CRC of every parameter, all-reduced as its max and its
min, must agree. A ``RESULT`` line carries the numbers as JSON, and
``--out`` writes rank 0's parameters and losses (``.npz``).
"""

from __future__ import annotations

import argparse
import json
import time
import zlib

import numpy as np
import torch

SEED = 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="d4pg_tpu_torch.parallel.multihost_check")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:0 of this host, raising when there "
                         "is no card), or cpu")
    ap.add_argument("--fused", type=int, default=0,
                    help="run the sharded fused replay plane instead of "
                         "the host-batch sharded update")
    ap.add_argument("--n_local", type=int, default=1,
                    help="data-axis shards per rank")
    ap.add_argument("--obs_dim", type=int, default=6)
    ap.add_argument("--act_dim", type=int, default=2)
    ap.add_argument("--hidden", default="16,16")
    ap.add_argument("--n_atoms", type=int, default=11)
    ap.add_argument("--bsize", type=int, default=16,
                    help="global batch of the fused chunk")
    ap.add_argument("--k", type=int, default=2, help="steps per chunk")
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--out", default="", help="rank 0's .npz")
    return ap


def _config(ns):
    from d4pg_tpu_torch.learner.state import D4PGConfig

    return D4PGConfig(obs_dim=ns.obs_dim, act_dim=ns.act_dim, v_min=-5.0,
                      v_max=0.0, n_atoms=ns.n_atoms,
                      hidden=tuple(int(h) for h in ns.hidden.split(",")),
                      projection="einsum")


def _rows(ns, n: int, stream: int):
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    rng = np.random.default_rng(SEED + 100 + stream)
    done = np.zeros(n, np.float32)
    return TransitionBatch(
        obs=rng.standard_normal((n, ns.obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ns.act_dim)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, ns.obs_dim)).astype(np.float32),
        done=done,
        discount=(0.99 * (1.0 - done)).astype(np.float32),
    )


def _shard_rows(ns, mesh, n: int):
    """``n`` rows per local shard from each global shard's own stream,
    interleaved so the round-robin drain hands shard s exactly its rows."""
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    per = [_rows(ns, n, mesh.local_start + s) for s in range(mesh.n_local)]
    return TransitionBatch(*[
        np.stack([p[f] for p in per], axis=1).reshape(
            n * mesh.n_local, *per[0][f].shape[1:])
        for f in range(len(TransitionBatch._fields))])


def param_crc(state) -> int:
    """CRC-32 of every parameter and target parameter, in order."""
    crc = 0
    for m in (state.actor, state.critic, state.target_actor,
              state.target_critic):
        for t in m.state_dict().values():
            crc = zlib.crc32(t.detach().cpu().numpy().tobytes(), crc)
    return crc


def reduce_ms_per_step(state, mesh, reps: int = 20) -> float:
    """Host ms per grad step of the gradient average (two reductions, the
    critic's and the actor's, on the gradients the last step left),
    synchronized at both ends of each."""
    from d4pg_tpu_torch.parallel.data_parallel import grad_reducer

    reduce = grad_reducer(mesh)
    if reduce is None:
        return 0.0
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda *a: None))
    sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        reduce(state.critic.parameters())
        reduce(state.actor.parameters())
        sync(mesh.device)
    return 1e3 * (time.perf_counter() - t0) / reps


def run_check(ns, mesh) -> dict:
    """The check's body on ``mesh`` (every rank calls it); returns the
    losses, the step, the parameter CRC, the descent launches and the
    gradient average's host ms per step."""
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.ops.sampler_descent import descend
    from d4pg_tpu_torch.parallel.data_parallel import make_sharded_update
    from d4pg_tpu_torch.parallel.multihost import replicate_state_global
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    config = _config(ns)
    # a different seed per rank: rank 0's broadcast must make them equal
    state = replicate_state_global(
        lambda: init_state(config, SEED + mesh.rank, mesh.device), mesh)
    losses: list[float] = []
    launches = descend.launches
    if ns.fused:
        from d4pg_tpu_torch.learner.fused import make_sharded_fused_chunk
        from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay

        buf = ShardedFusedReplay(ns.capacity, ns.obs_dim, ns.act_dim, mesh,
                                 alpha=0.6)
        rows = _shard_rows(ns, mesh, 4 * max(1, ns.bsize // mesh.n_shards))
        for _ in range(2):
            buf.add(rows)
            buf.drain()
        fn = make_sharded_fused_chunk(config, mesh, k=ns.k,
                                      batch_size=ns.bsize, alpha=0.6)
        b_local = ns.bsize // mesh.n_shards
        # one global stream of uniforms, each rank taking its shards'
        u = torch.from_numpy(np.random.default_rng(SEED).random(
            (2, ns.k, mesh.n_shards, b_local), dtype=np.float32))
        for c in range(2):
            buf.trees, metrics = fn(state, buf.trees, buf.storage, buf.size,
                                    u=u[c])
            losses += [float(x) for x in metrics["critic_loss"].cpu()]
        snap = buf.state_dict()
        buf2 = ShardedFusedReplay(ns.capacity, ns.obs_dim, ns.act_dim, mesh,
                                  alpha=0.6)
        buf2.load_state_dict(snap)
        if not len(buf2) == len(buf) > 0:
            raise RuntimeError(f"shard-set round trip: {len(buf2)} rows "
                               f"restored of {len(buf)}")
        if not torch.equal(buf2.trees.sum_tree, buf.trees.sum_tree):
            raise RuntimeError("shard-set round trip: trees differ")
        steps = 2 * ns.k
    else:
        update = make_sharded_update(config, mesh, use_is_weights=False)
        # this rank's block of the global batch, on its device
        local = TransitionBatch(*[torch.as_tensor(f, device=mesh.device)
                                  for f in _shard_rows(ns, mesh, 2)])
        for _ in range(2):
            metrics = update(state, local)
            losses.append(float(metrics["critic_loss"]))
        steps = 2
    if state.step != steps or not np.isfinite(losses).all():
        raise RuntimeError(f"step {state.step} (want {steps}), losses "
                           f"{losses}")
    crc = param_crc(state)
    ends = [mesh.all_reduce(torch.tensor([float(crc)], dtype=torch.float64),
                            op)[0].item() for op in ("max", "min")]
    if ends[0] != ends[1]:
        raise RuntimeError(f"replicas differ: parameter CRCs span {ends}")
    return {"losses": losses, "step": state.step, "crc": crc,
            "descent_launches": descend.launches - launches,
            "reduce_ms_per_step": reduce_ms_per_step(state, mesh),
            "backend": mesh.backend, "n_shards": mesh.n_shards,
            "state": state}


def main(argv=None) -> dict:
    ns = build_parser().parse_args(argv)
    from d4pg_tpu_torch import resolve_device
    from d4pg_tpu_torch.parallel import multihost

    device = resolve_device("cuda:0" if ns.device == "cuda" else ns.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize(ns.coordinator, ns.num_processes, ns.process_id)
    try:
        mesh = multihost.global_mesh(device, n_local=ns.n_local)
        multihost.barrier(mesh)
        res = run_check(ns, mesh)
        multihost.barrier(mesh)
    finally:
        multihost.shutdown()
    state = res.pop("state")
    if ns.out and mesh.rank == 0:
        np.savez(ns.out, losses=np.asarray(res["losses"], np.float64),
                 **{f"{m}/{n}": t.detach().cpu().numpy()
                    for m in ("actor", "critic")
                    for n, t in getattr(state, m).state_dict().items()})
    print(f"multihost_check OK: process {ns.process_id}/{ns.num_processes},"
          f" mesh {mesh.n_shards} shards ({mesh.n_local} local), backend "
          f"{mesh.backend}, losses "
          + " ".join(repr(x) for x in res["losses"]), flush=True)
    print("multihost_check RESULT " + json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
