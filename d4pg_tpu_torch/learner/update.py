"""The D4PG update and action functions.

Counterpart of ``d4pg_tpu/learner/update.py``. One ``update_step``:

  - with ``augment='shift'``, the DrQ shift of obs and next_obs at
    independent offsets (``ops.augment.random_shift``); both losses see
    the shifted batch;
  - target distribution Z'(s', pi'(s')) under ``no_grad`` (the reference
    stop-gradients the target, so nothing flows into it);
  - the categorical family's per-sample cross-entropy against the
    projected Bellman target: ``einsum`` projects with the plain
    ``categorical_projection`` on every device, ``pallas`` with the
    projection kernel (``ops.projection.projection``), each followed by
    the plain cross-entropy; ``pallas_ce`` fuses both in
    ``ops.projection_ce`` (forward and backward kernels). On the CPU each
    kernel wrapper runs its plain version. The MoG family takes the
    sampled cross-entropy against the Bellman-mapped target mixture
    (``core.mog``) and no kernel;
  - IS-weighted mean critic loss, critic Adam step; with
    ``share_encoder`` the actor's encoder becomes a copy of the stepped
    critic's;
  - policy loss -E[Z(s, pi(s))] through the critic AFTER its Adam step
    (the reference's documented choice, ``learner/update.py:217-225``),
    with gradients taken w.r.t. the actor's parameters only, so no
    critic ``.grad`` is written by the actor loss. A parameter the loss
    does not reach (the detached shared encoder) gets a zero gradient,
    as optax gives it, so every Adam step counter advances together;
  - actor Adam step, the encoder tie again (it overwrites what stale
    Adam moments would move), soft target updates (tau), the target
    actor's encoder tied to the target critic's, step counter + 1.

The random draws (DrQ offsets, MoG components and normals) come from
the state's generator, or are injected as ``UpdateDraws`` (the tests
hand both packages the same draws). The state is updated in place; the
metrics are detached tensors. ``multi_update_step`` runs K such updates
over stacked batches; ``act``, ``act_deterministic`` and ``act_ou``
choose actions.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import torch

from d4pg_tpu_torch.core import noise
from d4pg_tpu_torch.core.distribution import categorical_projection
from d4pg_tpu_torch.core.losses import (
    cross_entropy_per_sample,
    expected_q,
    weighted_mean,
)
from d4pg_tpu_torch.core.mog import mog_mean, mog_target, mog_td_loss
from d4pg_tpu_torch.core.updates import soft_update, tie_encoder
from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState
from d4pg_tpu_torch.ops.augment import random_shift
from d4pg_tpu_torch.ops.projection import projection
from d4pg_tpu_torch.ops.projection_ce import projection_ce
from d4pg_tpu_torch.replay.uniform import TransitionBatch


class UpdateDraws(NamedTuple):
    """Random draws of one update step, injected in place of the state's
    generator (``None`` fields are drawn from it). With a leading K axis
    they serve ``multi_update_step`` and the fused chunk."""

    obs_shift: torch.Tensor | None = None  # [B, 2] DrQ offsets of obs
    next_shift: torch.Tensor | None = None  # [B, 2] of next_obs
    gumbel: torch.Tensor | None = None  # [B, S, K] MoG component draws
    normal: torch.Tensor | None = None  # [B, S] MoG standard normals

    def at(self, t: int) -> "UpdateDraws":
        """Step ``t`` of stacked draws."""
        return UpdateDraws(*[None if d is None else d[t] for d in self])


def update_step(
    config: D4PGConfig,
    state: D4PGState,
    batch: TransitionBatch,
    is_weights: torch.Tensor | None = None,
    draws: UpdateDraws | None = None,
    grad_reduce: Callable[[Iterable[torch.nn.Parameter]], None] | None
    = None,
) -> dict[str, torch.Tensor]:
    """One full D4PG update of ``state`` in place. Returns scalar
    ``critic_loss`` / ``actor_loss`` / ``q_mean`` and the per-sample
    ``td_error`` [B] (the PER priority signal), all detached.
    ``grad_reduce(params)``, when given, runs between each ``backward``
    and its Adam step on that network's parameters (the data-parallel
    learner averages their gradients over ranks there,
    ``parallel/data_parallel.grad_reducer``)."""
    draws = UpdateDraws() if draws is None else draws
    gen = state.generator
    if config.augment == "shift":
        # obs and next_obs get independent offsets (DrQ's convention)
        batch = batch._replace(
            obs=random_shift(batch.obs, config.augment_pad, gen,
                             offsets=draws.obs_shift),
            next_obs=random_shift(batch.next_obs, config.augment_pad, gen,
                                  offsets=draws.next_shift))
    mog = config.critic_family == "mog"

    # --- critic step ------------------------------------------------------
    with torch.no_grad():
        next_action = state.target_actor(batch.next_obs)
        target = state.target_critic(batch.next_obs, next_action)
    pred = state.critic(batch.obs, batch.action)
    if mog:
        critic_loss, td_error = mog_td_loss(
            pred, mog_target(target, batch.reward, batch.discount), gen,
            config.mog_samples, is_weights, gumbel=draws.gumbel,
            normal=draws.normal)
    else:
        if config.projection == "pallas_ce":
            td_error = projection_ce(config.support, target, batch.reward,
                                     batch.discount, pred)
        else:
            project = (projection if config.projection == "pallas"
                       else categorical_projection)
            with torch.no_grad():
                proj = project(config.support, target, batch.reward,
                               batch.discount)
            td_error = cross_entropy_per_sample(proj, pred)
        critic_loss = weighted_mean(td_error, is_weights)
    state.critic_opt.zero_grad(set_to_none=True)
    critic_loss.backward()
    if grad_reduce is not None:
        grad_reduce(state.critic.parameters())
    state.critic_opt.step()
    if config.share_encoder:
        tie_encoder(state.actor, state.critic)

    # --- actor step, through the stepped critic ---------------------------
    action = state.actor(batch.obs)
    if mog:
        q = mog_mean(state.critic(batch.obs, action))
    else:
        q = expected_q(config.support, state.critic(batch.obs, action))
    actor_loss = -torch.mean(q)
    if config.action_l2:
        actor_loss = actor_loss + config.action_l2 * torch.mean(action**2)
    params = list(state.actor.parameters())
    grads = torch.autograd.grad(actor_loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    if grad_reduce is not None:
        grad_reduce(params)
    state.actor_opt.step()
    if config.share_encoder:
        tie_encoder(state.actor, state.critic)

    # --- soft target updates ----------------------------------------------
    soft_update(state.target_actor, state.actor, config.tau)
    soft_update(state.target_critic, state.critic, config.tau)
    if config.share_encoder:
        tie_encoder(state.target_actor, state.target_critic)
    state.step += 1
    actor_loss = actor_loss.detach()
    return {
        "critic_loss": critic_loss.detach(),
        "actor_loss": actor_loss,
        "q_mean": -actor_loss,
        "td_error": td_error.detach(),
    }


def multi_update_step(
    config: D4PGConfig,
    state: D4PGState,
    batches: TransitionBatch,
    weights: torch.Tensor | None = None,
    draws: UpdateDraws | None = None,
    grad_reduce: Callable[[Iterable[torch.nn.Parameter]], None] | None
    = None,
) -> dict[str, torch.Tensor]:
    """K sequential :func:`update_step` calls over batches stacked along a
    leading K axis (fields [K, B, ...], ``weights`` [K, B], injected
    ``draws`` [K, ...]); ``state`` is updated in place, each step through
    ``grad_reduce`` when given. Returns the
    metrics stacked along K (``td_error`` [K, B] feeds a batched priority
    write-back)."""
    steps = []
    for t in range(batches.obs.shape[0]):
        batch = TransitionBatch(*[field[t] for field in batches])
        steps.append(update_step(config, state, batch,
                                 None if weights is None else weights[t],
                                 None if draws is None else draws.at(t),
                                 grad_reduce))
    return {name: torch.stack([m[name] for m in steps]) for name in steps[0]}


@torch.no_grad()
def act(actor: torch.nn.Module, obs: torch.Tensor,
        generator: torch.Generator, epsilon: float = 0.3) -> torch.Tensor:
    """Exploratory action ``clip(pi(s) + eps * N(0, I), -1, 1)``; the noise
    comes from ``generator`` (which must live on ``obs``'s device)."""
    action = actor(obs)
    noise = torch.randn(action.shape, generator=generator,
                        device=action.device) * epsilon
    return torch.clamp(action + noise, -1.0, 1.0)


@torch.no_grad()
def act_deterministic(actor: torch.nn.Module,
                      obs: torch.Tensor) -> torch.Tensor:
    """Greedy action for evaluation."""
    return actor(obs)


@torch.no_grad()
def act_ou(
    actor: torch.nn.Module,
    obs: torch.Tensor,
    ou_state: noise.OUNoiseState,
    generator: torch.Generator | None = None,
    epsilon: float = 1.0,
    theta: float = 0.25,
    mu: float = 0.0,
    sigma: float = 0.05,
    dt: float = 0.01,
    *,
    normal: torch.Tensor | None = None,
) -> tuple[torch.Tensor, noise.OUNoiseState]:
    """Exploratory action with Ornstein-Uhlenbeck noise: the greedy action,
    an OU advance (``core.noise.ou.sample``, its standard-normal draw from
    ``generator`` or the injected ``normal``), then
    ``clip(greedy + epsilon * noise, -1, 1)``. Returns ``(action,
    new_ou_state)``; the caller threads the state and resets it at episode
    boundaries."""
    greedy = actor(obs)
    new_state, ou_noise = noise.ou.sample(ou_state, generator, theta=theta,
                                          mu=mu, sigma=sigma, dt=dt,
                                          normal=normal)
    return torch.clamp(greedy + epsilon * ou_noise, -1.0, 1.0), new_state
