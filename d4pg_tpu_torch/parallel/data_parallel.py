"""Synchronous data-parallel learner over the rank mesh.

Counterpart of ``d4pg_tpu/parallel/data_parallel.py``. The reference jits
``update_step`` with the state replicated and the batch split over the
``data`` axis, and XLA all-reduces the loss mean over the global batch.
Here every rank holds the whole state (``replicate_state``: built on rank
0, then every tensor broadcast, the Adam moments and step counts
included), runs ``update_step`` on its own rows, and averages the
gradients over ranks between each ``backward()`` and its Adam step
(``grad_reducer``: one flat ``all_reduce(SUM)``, then a division by the
world size). With equal rows per rank that average IS the gradient of
the loss mean over the global batch, so every replica takes the same
Adam step. The losses' summation order differs from XLA's: parity holds
at the reference's ``tests/test_parallel.py`` bars, not bitwise.

The kernel arms keep the reference's refusal on a mesh
(``check_mesh_compatible``, the rule table in its message): under
``torch.distributed`` each rank could launch its own projection kernels,
but lifting the refusal would be a feature the JAX package lacks.
"""

from __future__ import annotations

from typing import Iterable

import torch

from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState
from d4pg_tpu_torch.learner.update import multi_update_step, update_step
from d4pg_tpu_torch.parallel import partition
from d4pg_tpu_torch.parallel.mesh import RankMesh
from d4pg_tpu_torch.replay.uniform import TransitionBatch

_MODULES = ("actor", "critic", "target_actor", "target_critic")
_OPTIMIZERS = (("actor_opt", "actor"), ("critic_opt", "critic"))


def _adam_tensors(state: D4PGState) -> list[torch.Tensor]:
    """Every Adam tensor of ``state`` in a fixed order; a parameter with no
    Adam state yet gets the zeros optax would hold. Step counts are put
    on the CPU on every rank: a checkpoint restored with
    ``map_location`` leaves them on the card, a fresh state holds them on
    the CPU, and the broadcasts must pair the same tensors on each
    rank."""
    out = []
    for opt_attr, module_attr in _OPTIMIZERS:
        opt = getattr(state, opt_attr)
        for p in getattr(state, module_attr).parameters():
            st = opt.state[p]
            if not st:
                st.update(step=torch.zeros((), dtype=torch.float32),
                          exp_avg=torch.zeros_like(p),
                          exp_avg_sq=torch.zeros_like(p))
            st["step"] = st["step"].to("cpu", torch.float32)
            out += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return out


@torch.no_grad()
def replicate_state(state: D4PGState, mesh: RankMesh) -> D4PGState:
    """Make every rank's ``state`` rank 0's, in place: the networks and
    targets, the Adam moments and step counts, the step counter and the
    state's generator. Collective; a no-op on a world of 1."""
    if mesh.world == 1:
        return state
    meta = mesh.broadcast_object(
        {"step": int(state.step), "generator": state.generator.get_state(),
         "adam": any(getattr(state, o).state for o, _ in _OPTIMIZERS)})
    state.step = meta["step"]
    state.generator.set_state(meta["generator"])
    tensors = [t for m in _MODULES
               for t in getattr(state, m).state_dict().values()]
    if meta["adam"]:
        tensors += _adam_tensors(state)
    # one flat broadcast per (device, dtype): device tensors over the
    # device group, the Adam step counts (CPU) over the host group
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for group in groups.values():
        flat = mesh.broadcast(torch.cat([t.reshape(-1) for t in group]))
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view(t.shape))
            offset += n
    return state


def grad_reducer(mesh: RankMesh):
    """``update_step``'s ``grad_reduce`` hook for ``mesh``: the gradients
    of the given parameters averaged over ranks in place (one flat
    ``all_reduce(SUM)``, then a division by the world size). ``None`` on
    a world of 1, where the update stays bit for bit the single
    learner's."""
    if mesh.world == 1:
        return None

    @torch.no_grad()
    def reduce(params: Iterable[torch.nn.Parameter]) -> None:
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.mean(flat)
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view(g.shape))
            offset += n

    return reduce


def shard_batch(batch, mesh: RankMesh):
    """This rank's block of a global [B, ...] batch (rows split over the
    ``data`` axis), on its device. B must divide by the world size."""
    return _block(batch, mesh, axis=0)


def shard_stacked(batches, mesh: RankMesh):
    """This rank's block of a [K, B, ...] stack: K whole, B split."""
    return _block(batches, mesh, axis=1)


def _block(tree, mesh: RankMesh, axis: int):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_block(v, mesh, axis) for v in tree])
    if tree is None:
        return None
    t = torch.as_tensor(tree)
    if t.shape[axis] % mesh.world:
        raise ValueError(f"{t.shape[axis]} rows do not divide over "
                         f"{mesh.world} ranks")
    return torch.chunk(t, mesh.world, dim=axis)[mesh.rank].to(mesh.device)


def check_mesh_compatible(config: D4PGConfig) -> None:
    """The kernel arms are single-device in the reference (``pallas_call``
    does not partition under a sharded jit); the port keeps the refusal
    and its message, with the rule table the mesh resolves."""
    if config.projection in ("pallas", "pallas_ce"):
        raise ValueError(
            f"--projection {config.projection} is single-device only "
            "(pallas_call does not partition under a sharded jit); use "
            "--projection einsum with a device mesh. Resolved partition "
            "rules for this mesh:\n" + partition.format_rules())


def replicated_metrics(metrics: dict, mesh: RankMesh) -> dict:
    """The scalar metrics averaged over ranks (the reference returns them
    replicated); ``td_error`` stays this rank's rows."""
    names = [n for n in ("critic_loss", "actor_loss", "q_mean")
             if n in metrics]
    if mesh.world > 1 and names:
        stacked = mesh.mean(torch.stack([metrics[n] for n in names]))
        for i, n in enumerate(names):
            metrics[n] = stacked[i]
    return metrics


def make_sharded_update(config: D4PGConfig, mesh: RankMesh,
                        use_is_weights: bool = True):
    """The D4PG update on this rank's rows with the gradients averaged
    over ranks: ``fn(state, batch[, w]) -> metrics`` (``state`` in place;
    ``batch``/``w`` this rank's block on its device)."""
    check_mesh_compatible(config)
    reduce = grad_reducer(mesh)

    def fn(state, batch, w=None):
        if use_is_weights and w is None:
            raise ValueError("use_is_weights=True needs IS weights")
        metrics = update_step(config, state, TransitionBatch(*batch),
                              w if use_is_weights else None,
                              grad_reduce=reduce)
        return replicated_metrics(metrics, mesh)

    return fn


def make_sharded_multi_update(config: D4PGConfig, mesh: RankMesh,
                              use_is_weights: bool = True):
    """K sharded updates over stacked [K, B_local, ...] batches (and
    weights): ``fn(state, batches[, w]) -> metrics`` stacked along K,
    ``td_error`` [K, B_local] this rank's rows."""
    check_mesh_compatible(config)
    reduce = grad_reducer(mesh)

    def fn(state, batches, w=None):
        if use_is_weights and w is None:
            raise ValueError("use_is_weights=True needs IS weights")
        metrics = multi_update_step(
            config, state, TransitionBatch(*batches),
            w if use_is_weights else None, grad_reduce=reduce)
        return replicated_metrics(metrics, mesh)

    return fn
