"""The fused replay+learn chunk: K grad steps with no host round trip.

Counterpart of ``d4pg_tpu/learner/fused.py``'s ``fused_chunk_step`` and
``make_fused_chunk``. Each of the K steps, with PER trees:

    stratified PER sample -> ring gather -> IS weights ->
    D4PG update -> priority write-back

and without them (``trees=None``, uniform replay): uniform slots ->
ring gather -> D4PG update, with no IS weights.

The JAX chunk is one ``lax.scan`` in one dispatch; here it is a Python
loop of eager ops on the device with no host sync inside (no ``.item()``,
``size`` and the step counter stay host ints), so the host only queues
kernels. Within a chunk step t+1 already samples from step t's
priorities, as in the reference.

``make_sharded_fused_chunk`` is the chunk over the data-sharded replay
(``replay/sharded_per.py``): each rank samples its own shards, and only
the gradients and one IS normalizer per step cross ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState
from d4pg_tpu_torch.learner.update import UpdateDraws, update_step
from d4pg_tpu_torch.parallel.data_parallel import (
    check_mesh_compatible,
    grad_reducer,
    replicated_metrics,
)
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.uniform import TransitionBatch

_METRICS = ("critic_loss", "actor_loss", "q_mean", "td_error", "idx")


def fused_chunk_step(
    config: D4PGConfig,
    state: D4PGState,
    trees: dper.PerTrees | None,
    storage: TransitionBatch,
    size: int,
    *,
    k: int,
    batch_size: int,
    generator: torch.Generator | None = None,
    u: torch.Tensor | None = None,
    slots: torch.Tensor | None = None,
    draws: UpdateDraws | None = None,
    alpha: float = 0.6,
    beta0: float = 0.4,
    beta_steps: int = 100_000,
) -> tuple[dper.PerTrees | None, dict[str, torch.Tensor]]:
    """K fused sample+update steps; ``state`` is updated in place.

    Random draws come from ``generator`` (on the storage's device), or are
    injected (tests hand the same draws to the reference): PER uniforms
    ``u`` [K, B], or, for uniform replay (``trees=None``), the slots
    ``slots`` [K, B] themselves, which ``torch.randint(0, size)`` draws
    otherwise; the updates' own draws (DrQ offsets, MoG samples) come
    from the state's generator or are injected as ``draws`` [K, ...].
    ``storage`` is the ring's [capacity + shadow, ...] tensors and
    ``size`` the live row count. Returns the new trees (``None`` for
    uniform replay) and the per-step metrics stacked along K
    (``td_error`` and ``idx`` [K, B])."""
    if trees is None and u is not None:
        raise ValueError("u (PER uniforms) does not apply to uniform "
                         "replay: inject slots")
    if trees is not None and slots is not None:
        raise ValueError("slots apply to uniform replay only: inject u")
    injected, what = (u, "u") if trees is not None else (slots, "slots")
    if injected is None and generator is None:
        raise ValueError(f"fused_chunk_step needs a generator or injected "
                         f"{what}")
    if injected is not None and tuple(injected.shape) != (k, batch_size):
        raise ValueError(f"{what} must be [{k}, {batch_size}], got "
                         f"{tuple(injected.shape)}")
    out = {name: [] for name in _METRICS}
    for t in range(k):
        w = None
        if trees is None:
            idx = injected[t] if injected is not None else torch.randint(
                0, max(int(size), 1), (batch_size,), generator=generator,
                dtype=torch.int32, device=storage.obs.device)
        else:
            if injected is None:
                idx = dper.sample(trees, generator, batch_size, size)
            else:
                idx = dper.sample_from_uniforms(trees, injected[t], size)
            beta = dper.beta_schedule(state.step, beta0, beta_steps)
            w = dper.is_weights(trees, idx, beta, size)
        batch = TransitionBatch(*[arr[idx] for arr in storage])
        metrics = update_step(config, state, batch, w,
                              None if draws is None else draws.at(t))
        if trees is not None:
            trees = dper.update_from_td(trees, idx, metrics["td_error"],
                                        alpha)
        metrics["idx"] = idx
        for name in _METRICS:
            out[name].append(metrics[name])
    return trees, {name: torch.stack(v) for name, v in out.items()}


def make_fused_chunk(
    config: D4PGConfig,
    *,
    k: int,
    batch_size: int,
    prioritized: bool = True,
    projection: str | None = None,
    alpha: float = 0.6,
    beta0: float = 0.4,
    beta_steps: int = 100_000,
):
    """The fused chunk. PER: ``fn(state, trees, storage, size,
    generator=None, u=None) -> (trees, metrics)``; uniform
    (``prioritized=False``): ``fn(state, storage, size, generator=None,
    slots=None) -> metrics``. ``state`` is updated in place. ``projection``
    overrides the config's projection arm name (``einsum`` runs the plain
    projection, ``pallas`` ``ops/projection.py``, ``pallas_ce``
    ``ops/projection_ce.py``)."""
    if projection is not None:
        config = dataclasses.replace(config, projection=projection)

    if not prioritized:
        def uniform(state, storage, size, generator=None, slots=None,
                    draws=None):
            return fused_chunk_step(
                config, state, None, storage, size, k=k,
                batch_size=batch_size, generator=generator, slots=slots,
                draws=draws)[1]

        return uniform

    def fn(state, trees, storage, size, generator=None, u=None, draws=None):
        return fused_chunk_step(
            config, state, trees, storage, size, k=k, batch_size=batch_size,
            generator=generator, u=u, draws=draws, alpha=alpha, beta0=beta0,
            beta_steps=beta_steps)

    return fn


def shard_weights(trees, idx: torch.Tensor, beta: float,
                  mesh) -> torch.Tensor:
    """IS weights of the local shards' draws ``idx`` [n_local, b_local]:
    each row i's per-draw probability is ``q_i = p_i / total_s /
    n_shards``, and the weights ``(q / q_min) ** -beta`` take ONE
    normalizer over every shard of every rank (``q_min``, an
    ``all_reduce(MIN)``), so every rank's gradient contribution is on the
    same scale. ``N_rows`` cancels, so no sizes cross ranks. Returns
    [n_local, b_local] float32."""
    dev = idx.device
    n = torch.full((), float(mesh.n_shards), dtype=torch.float32, device=dev)
    cap = trees.cap_shard
    total = torch.clamp_min(trees.sum_tree[:, 1], 1e-30)  # [n_local]
    leaf = torch.gather(trees.sum_tree, 1, cap + idx.long())
    q = leaf / total[:, None] / n
    q_min = torch.min(trees.min_tree[:, 1] / total / n).reshape(1)
    mesh.all_reduce(q_min, "min")
    neg_beta = torch.full((), -float(np.float32(beta)), dtype=torch.float32,
                          device=dev)
    return torch.pow(q / q_min, neg_beta)


def make_sharded_fused_chunk(
    config: D4PGConfig,
    mesh,
    *,
    k: int,
    batch_size: int,
    prioritized: bool = True,
    alpha: float = 0.6,
    beta0: float = 0.4,
    beta_steps: int = 100_000,
):
    """The fused chunk over the data-sharded replay of
    ``replay/sharded_per.ShardedFusedReplay`` (``mesh`` its
    ``parallel/mesh.RankMesh``). Each step, for each local shard s: the
    descent of ``b_local = batch_size / n_shards`` stratified uniforms
    through s's own tree (``device_per.sample_from_uniforms``: the descent
    kernel once per shard on the card), the gather of its rows and their
    per-draw probabilities; then once: the IS weights over the global
    normalizer (``shard_weights``), the local shards' rows joined in
    shard order, ``update_step`` with the gradients averaged over ranks,
    and each shard's TD errors written back into its own tree.

    Rejects the kernel projection arms, as the reference does
    (``parallel/data_parallel.check_mesh_compatible``). Uniforms (or, for
    uniform replay, slots) are injected as [K, n_shards, b_local] (this
    rank takes its shards' columns) or drawn from ``generator``, per
    rank. PER: ``fn(state, trees, storage, size, generator=None, u=None,
    draws=None) -> (trees, metrics)``; uniform: ``fn(state, storage,
    size, generator=None, slots=None, draws=None) -> metrics``. ``size``
    is the local shards' live rows [n_local]; the input trees are left
    untouched. Metrics are stacked along K: the losses and ``q_mean``
    averaged over ranks, ``td_error`` and ``idx`` (local slots) this
    rank's rows [K, n_local * b_local] in shard order."""
    check_mesh_compatible(config)
    n_shards, n_local = mesh.n_shards, mesh.n_local
    if batch_size % n_shards:
        raise ValueError(
            f"batch_size {batch_size} not divisible by data axis {n_shards}")
    b_local = batch_size // n_shards
    lo = mesh.local_start
    reduce = grad_reducer(mesh)

    def chunk(state, trees, storage, size, generator, injected, draws):
        if injected is None and generator is None:
            raise ValueError("the sharded chunk needs a generator or "
                             "injected draws")
        if injected is not None:
            if tuple(injected.shape) != (k, n_shards, b_local):
                raise ValueError(
                    f"injected draws must be [{k}, {n_shards}, {b_local}], "
                    f"got {tuple(injected.shape)}")
            injected = injected[:, lo:lo + n_local]
        dev = storage.obs.device
        trees = None if trees is None else trees.clone()
        out = {name: [] for name in _METRICS}
        for t in range(k):
            idx = []
            for s in range(n_local):
                limit = max(int(size[s]), 1)
                if trees is None:
                    idx.append(injected[t, s].to(dev) if injected is not None
                               else torch.randint(
                                   0, limit, (b_local,), generator=generator,
                                   dtype=torch.int32, device=dev))
                    continue
                u = (injected[t, s].to(dev) if injected is not None
                     else torch.rand(b_local, generator=generator,
                                     device=dev))
                idx.append(dper.sample_from_uniforms(trees.shard(s), u,
                                                     size[s]))
            idx = torch.stack(idx)  # [n_local, b_local]
            w = None
            if trees is not None:
                beta = dper.beta_schedule(state.step, beta0, beta_steps)
                w = shard_weights(trees, idx, beta, mesh).reshape(-1)
            batch = TransitionBatch(*[
                torch.cat([arr[s][idx[s]] for s in range(n_local)])
                for arr in storage])
            metrics = update_step(config, state, batch, w,
                                  None if draws is None else draws.at(t),
                                  grad_reduce=reduce)
            if trees is not None:
                td = metrics["td_error"].reshape(n_local, b_local)
                for s in range(n_local):
                    trees.set_shard(s, dper.update_from_td(
                        trees.shard(s), idx[s], td[s], alpha))
            metrics["idx"] = idx.reshape(-1)
            for name in _METRICS:
                out[name].append(metrics[name])
        stacked = {name: torch.stack(v) for name, v in out.items()}
        return trees, replicated_metrics(stacked, mesh)

    if not prioritized:
        def uniform(state, storage, size, generator=None, slots=None,
                    draws=None):
            return chunk(state, None, storage, size, generator, slots,
                         draws)[1]

        return uniform

    def fn(state, trees, storage, size, generator=None, u=None, draws=None):
        return chunk(state, trees, storage, size, generator, u, draws)

    return fn
