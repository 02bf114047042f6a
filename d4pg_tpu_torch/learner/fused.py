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
"""

from __future__ import annotations

import dataclasses

import torch

from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState
from d4pg_tpu_torch.learner.update import update_step
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
    alpha: float = 0.6,
    beta0: float = 0.4,
    beta_steps: int = 100_000,
) -> tuple[dper.PerTrees | None, dict[str, torch.Tensor]]:
    """K fused sample+update steps; ``state`` is updated in place.

    Random draws come from ``generator`` (on the storage's device), or are
    injected (tests hand the same draws to the reference): PER uniforms
    ``u`` [K, B], or, for uniform replay (``trees=None``), the slots
    ``slots`` [K, B] themselves, which ``torch.randint(0, size)`` draws
    otherwise. ``storage`` is the ring's [capacity + shadow, ...] tensors
    and ``size`` the live row count. Returns the new trees (``None`` for
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
        metrics = update_step(config, state, batch, w)
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
        def uniform(state, storage, size, generator=None, slots=None):
            return fused_chunk_step(
                config, state, None, storage, size, k=k,
                batch_size=batch_size, generator=generator, slots=slots)[1]

        return uniform

    def fn(state, trees, storage, size, generator=None, u=None):
        return fused_chunk_step(
            config, state, trees, storage, size, k=k, batch_size=batch_size,
            generator=generator, u=u, alpha=alpha, beta0=beta0,
            beta_steps=beta_steps)

    return fn
