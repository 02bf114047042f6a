"""The D4PG update and action functions.

Counterpart of ``d4pg_tpu/learner/update.py``. One ``update_step``:

  - target distribution Z'(s', pi'(s')) under ``no_grad`` (the reference
    stop-gradients the projected target, so nothing flows into it);
  - the per-sample cross-entropy against the projected Bellman target:
    ``einsum`` projects with the plain ``categorical_projection`` on every
    device, ``pallas`` with the projection kernel
    (``ops.projection.projection``), each followed by the plain
    cross-entropy; ``pallas_ce`` fuses both in ``ops.projection_ce``
    (forward and backward kernels). On the CPU each kernel wrapper runs
    its plain version;
  - IS-weighted mean critic loss, critic Adam step;
  - policy loss -E[Z(s, pi(s))] through the critic AFTER its Adam step
    (the reference's documented choice, ``learner/update.py:217-225``),
    with gradients taken w.r.t. the actor's parameters only, so no
    critic ``.grad`` is written by the actor loss;
  - actor Adam step, soft target updates (tau), step counter + 1.

The state is updated in place; the metrics are detached tensors.
``multi_update_step`` runs K such updates over stacked batches; ``act``,
``act_deterministic`` and ``act_ou`` choose actions.
"""

from __future__ import annotations

import torch

from d4pg_tpu_torch.core import noise
from d4pg_tpu_torch.core.distribution import categorical_projection
from d4pg_tpu_torch.core.losses import (
    cross_entropy_per_sample,
    expected_q,
    weighted_mean,
)
from d4pg_tpu_torch.core.updates import soft_update
from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState
from d4pg_tpu_torch.ops.projection import projection
from d4pg_tpu_torch.ops.projection_ce import projection_ce
from d4pg_tpu_torch.replay.uniform import TransitionBatch


def update_step(
    config: D4PGConfig,
    state: D4PGState,
    batch: TransitionBatch,
    is_weights: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """One full D4PG update of ``state`` in place. Returns scalar
    ``critic_loss`` / ``actor_loss`` / ``q_mean`` and the per-sample
    ``td_error`` [B] (the PER priority signal), all detached."""
    # --- critic step ------------------------------------------------------
    with torch.no_grad():
        next_action = state.target_actor(batch.next_obs)
        target_probs = state.target_critic(batch.next_obs, next_action)
    pred_probs = state.critic(batch.obs, batch.action)
    if config.projection == "pallas_ce":
        td_error = projection_ce(config.support, target_probs, batch.reward,
                                 batch.discount, pred_probs)
    else:
        project = (projection if config.projection == "pallas"
                   else categorical_projection)
        with torch.no_grad():
            proj = project(config.support, target_probs, batch.reward,
                           batch.discount)
        td_error = cross_entropy_per_sample(proj, pred_probs)
    critic_loss = weighted_mean(td_error, is_weights)
    state.critic_opt.zero_grad(set_to_none=True)
    critic_loss.backward()
    state.critic_opt.step()

    # --- actor step, through the stepped critic ---------------------------
    action = state.actor(batch.obs)
    probs = state.critic(batch.obs, action)
    actor_loss = -torch.mean(expected_q(config.support, probs))
    if config.action_l2:
        actor_loss = actor_loss + config.action_l2 * torch.mean(action**2)
    params = list(state.actor.parameters())
    for p, g in zip(params, torch.autograd.grad(actor_loss, params)):
        p.grad = g
    state.actor_opt.step()

    # --- soft target updates ----------------------------------------------
    soft_update(state.target_actor, state.actor, config.tau)
    soft_update(state.target_critic, state.critic, config.tau)
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
) -> dict[str, torch.Tensor]:
    """K sequential :func:`update_step` calls over batches stacked along a
    leading K axis (fields [K, B, ...], ``weights`` [K, B]); ``state`` is
    updated in place. Returns the metrics stacked along K (``td_error``
    [K, B] feeds a batched priority write-back)."""
    steps = []
    for t in range(batches.obs.shape[0]):
        batch = TransitionBatch(*[field[t] for field in batches])
        steps.append(update_step(config, state, batch,
                                 None if weights is None else weights[t]))
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
