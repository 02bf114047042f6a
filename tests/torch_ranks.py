"""Rank bodies for the port's multi-rank tests.

``parallel.multihost.spawn_local`` runs each of these in ``spawn``ed gloo
CPU ranks, which import this module by name: it imports torch and the
port only, never JAX (the test modules that call it import both)."""

from __future__ import annotations

import numpy as np
import torch

from d4pg_tpu_torch.learner.state import D4PGConfig, init_state

_PARTS = ("actor", "critic", "target_actor", "target_critic", "actor_opt",
          "critic_opt")


def pack_state(state) -> dict:
    """A port state as picklable CPU payload (what a rank rebuilds)."""
    return {"parts": {name: getattr(state, name).state_dict()
                      for name in _PARTS},
            "step": int(state.step),
            "generator": state.generator.get_state()}


def unpack_state(config: D4PGConfig, payload: dict, device="cpu"):
    state = init_state(config, 0, device)
    for name in _PARTS:
        getattr(state, name).load_state_dict(payload["parts"][name])
    state.step = payload["step"]
    state.generator.set_state(payload["generator"])
    return state


def params(state) -> dict:
    """``{module: {torch name: numpy}}`` of the four networks."""
    return {m: {n: t.detach().cpu().numpy().copy()
                for n, t in getattr(state, m).state_dict().items()}
            for m in ("actor", "critic", "target_actor", "target_critic")}


def _numpy(metrics: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()}


def batch_of(fields: dict):
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    return TransitionBatch(**{k: torch.from_numpy(np.asarray(v))
                              for k, v in fields.items()})


# -- parallel ---------------------------------------------------------------


def replicate_and_shard(mesh, config, fields):
    """Each rank seeds its own state, then ``replicate_state``; and takes
    its block of a global batch with ``shard_batch``."""
    from d4pg_tpu_torch.parallel import replicate_state, shard_batch

    state = init_state(config, seed=10 + mesh.rank, device=mesh.device)
    for p in state.critic.parameters():  # give Adam a state on rank 0 only
        if mesh.rank == 0:
            state.critic_opt.state[p] = {
                "step": torch.tensor(3.0),
                "exp_avg": torch.full_like(p, 0.5),
                "exp_avg_sq": torch.full_like(p, 0.25)}
    state.step = 7 if mesh.rank == 0 else 0
    replicate_state(state, mesh)
    block = shard_batch(batch_of(fields), mesh)
    adam = [state.critic_opt.state[p]["exp_avg"].sum().item()
            for p in state.critic.parameters()]
    return {"params": params(state), "step": state.step, "adam": adam,
            "generator": state.generator.get_state().numpy(),
            "obs": block.obs.numpy(), "world": mesh.world,
            "backend": mesh.backend}


def sharded_update(mesh, config, payload, fields, w, steps):
    """``steps`` sharded updates on this rank's block of the same global
    batch (IS-weighted when ``w`` is given)."""
    from d4pg_tpu_torch.parallel import make_sharded_update, shard_batch

    state = unpack_state(config, payload, mesh.device)
    update = make_sharded_update(config, mesh, use_is_weights=w is not None)
    batch = shard_batch(batch_of(fields), mesh)
    wl = None if w is None else shard_batch(torch.from_numpy(w), mesh)
    out = []
    for _ in range(steps):
        out.append(_numpy(update(state, batch, wl)))
    return {"metrics": out, "params": params(state), "step": state.step}


def sharded_multi_update(mesh, config, payload, fields, w):
    """The K-step sharded update over this rank's block of a [K, B]
    stack."""
    from d4pg_tpu_torch.parallel import (make_sharded_multi_update,
                                         shard_stacked)

    state = unpack_state(config, payload, mesh.device)
    update = make_sharded_multi_update(config, mesh)
    metrics = update(state, shard_stacked(batch_of(fields), mesh),
                     shard_stacked(torch.from_numpy(w), mesh))
    return {"metrics": _numpy(metrics), "params": params(state),
            "step": state.step}


# -- sharded replay ---------------------------------------------------------


def fill(buf, blocks):
    for fields in blocks:
        buf.add(batch_of(fields))
        buf.drain()


def sharded_chunk(mesh, config, payload, capacity, blocks, k, batch_size,
                  injected, prioritized=True):
    """This rank's shards filled with ``blocks`` (each rank its own), then
    one sharded fused chunk with the injected draws."""
    from d4pg_tpu_torch.learner.fused import make_sharded_fused_chunk
    from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay

    buf = ShardedFusedReplay(capacity, config.obs_dim, config.act_dim, mesh,
                             alpha=0.6, prioritized=prioritized)
    fill(buf, blocks[mesh.rank])
    state = unpack_state(config, payload, mesh.device)
    fn = make_sharded_fused_chunk(config, mesh, k=k, batch_size=batch_size,
                                  prioritized=prioritized, alpha=0.6)
    inj = torch.from_numpy(injected)
    if prioritized:
        trees, metrics = fn(state, buf.trees, buf.storage, buf.size, u=inj)
        trees = [t.numpy() for t in trees]
    else:
        trees, metrics = None, fn(state, buf.storage, buf.size, slots=inj)
    return {"metrics": _numpy(metrics), "params": params(state),
            "trees": trees, "storage": [v.numpy() for v in buf.storage],
            "step": state.step}


# -- multi-rank plumbing ----------------------------------------------------


def synced_normalizer(mesh, streams):
    """Each rank folds its own stream (two batches), then ``sync``."""
    from d4pg_tpu_torch.envs.normalizer import SyncedRunningMeanStd

    norm = SyncedRunningMeanStd(streams[0][0].shape[1], mesh)
    for batch in streams[mesh.rank]:
        norm.update(batch)
    before = norm.state_dict()
    norm.sync()
    return {"before": before, "after": norm.state_dict()}


def global_batches(mesh, config, fields_per_rank, batch_size):
    """The two paths' global batches: the host-sampled ``ChunkPipeline``
    over the sharded multi update, each rank sampling its own B rows
    (``fields_per_rank[rank]``: a global batch of W * B), and the sharded
    fused chunk (B over every shard). Returns the rows each update saw,
    the td shapes written back, the parameters after the pipeline and
    the fused chunk's td shape."""
    from d4pg_tpu_torch.learner.fused import make_sharded_fused_chunk
    from d4pg_tpu_torch.learner.pipeline import ChunkPipeline
    from d4pg_tpu_torch.parallel import make_sharded_multi_update
    from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay

    state = init_state(config, 0, mesh.device)
    update = make_sharded_multi_update(config, mesh)
    seen, written = [], []

    def chunk_update(st, batches, w):
        seen.append((tuple(batches.obs.shape), tuple(w.shape)))
        return st, update(st, batches, w)

    fields_k = fields_per_rank[mesh.rank]
    k = fields_k["obs"].shape[0]
    sample = lambda: ((batch_of(fields_k),
                       torch.ones(k, batch_size)), "aux")
    pipe = ChunkPipeline(
        chunk_update, sample, write_back=lambda aux, td: written.append(
            td.shape), device=mesh.device)
    state, _ = pipe.run(state, 2)
    after = params(state)
    buf = ShardedFusedReplay(64, config.obs_dim, config.act_dim, mesh)
    flat = {f: v.reshape(-1, *v.shape[2:]) for f, v in fields_k.items()}
    fill(buf, [flat])
    fn = make_sharded_fused_chunk(config, mesh, k=2, batch_size=batch_size)
    _, m = fn(state, buf.trees, buf.storage, buf.size,
              generator=torch.Generator().manual_seed(mesh.rank))
    return {"pipeline": seen, "written": written, "params": after,
            "fused_td": tuple(m["td_error"].shape)}
