"""The fused PER replay+learn chunk: K grad steps with no host round trip.

Counterpart of ``d4pg_tpu/learner/fused.py``'s PER ``fused_chunk_step``.
Each of the K steps:

    stratified PER sample -> ring gather -> IS weights ->
    D4PG update -> priority write-back

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
    trees: dper.PerTrees,
    storage: TransitionBatch,
    size: int,
    *,
    k: int,
    batch_size: int,
    generator: torch.Generator | None = None,
    u: torch.Tensor | None = None,
    alpha: float = 0.6,
    beta0: float = 0.4,
    beta_steps: int = 100_000,
) -> tuple[dper.PerTrees, dict[str, torch.Tensor]]:
    """K fused sample+update steps; ``state`` is updated in place.

    Uniforms come from ``generator`` (on the trees' device), or from
    ``u`` [K, B] when given (tests inject the same uniforms into the
    reference). ``storage`` is the ring's [capacity + shadow, ...] tensors
    and ``size`` the live row count. Returns the new trees and the
    per-step metrics stacked along K (``td_error`` and ``idx`` [K, B])."""
    if u is None and generator is None:
        raise ValueError("fused_chunk_step needs a generator or injected u")
    if u is not None and tuple(u.shape) != (k, batch_size):
        raise ValueError(f"u must be [{k}, {batch_size}], got "
                         f"{tuple(u.shape)}")
    out = {name: [] for name in _METRICS}
    for t in range(k):
        if u is None:
            idx = dper.sample(trees, generator, batch_size, size)
        else:
            idx = dper.sample_from_uniforms(trees, u[t], size)
        beta = dper.beta_schedule(state.step, beta0, beta_steps)
        w = dper.is_weights(trees, idx, beta, size)
        batch = TransitionBatch(*[arr[idx] for arr in storage])
        metrics = update_step(config, state, batch, w)
        trees = dper.update_from_td(trees, idx, metrics["td_error"], alpha)
        metrics["idx"] = idx
        for name in _METRICS:
            out[name].append(metrics[name])
    return trees, {name: torch.stack(v) for name, v in out.items()}


def make_fused_chunk(
    config: D4PGConfig,
    *,
    k: int,
    batch_size: int,
    projection: str | None = None,
    alpha: float = 0.6,
    beta0: float = 0.4,
    beta_steps: int = 100_000,
):
    """The fused chunk as ``fn(state, trees, storage, size, generator=None,
    u=None) -> (trees, metrics)``. ``projection`` overrides the config's
    projection arm name (``einsum`` or ``pallas``; both run the one
    projection of ``ops/projection.py``)."""
    if projection is not None:
        config = dataclasses.replace(config, projection=projection)

    def fn(state, trees, storage, size, generator=None, u=None):
        return fused_chunk_step(
            config, state, trees, storage, size, k=k, batch_size=batch_size,
            generator=generator, u=u, alpha=alpha, beta0=beta0,
            beta_steps=beta_steps)

    return fn
