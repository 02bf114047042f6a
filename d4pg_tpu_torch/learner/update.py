"""The D4PG update and action functions.

Counterpart of ``d4pg_tpu/learner/update.py``. One ``update_step``:

  - target distribution Z'(s', pi'(s')) under ``no_grad`` (the reference
    stop-gradients the projected target, so nothing flows into it);
  - Bellman projection through ``ops.projection.projection`` (the CUDA
    kernel on the card, its plain version on the CPU) under either
    configured arm name;
  - IS-weighted cross-entropy critic loss, critic Adam step;
  - policy loss -E[Z(s, pi(s))] through the critic AFTER its Adam step
    (the reference's documented choice, ``learner/update.py:217-225``),
    with gradients taken w.r.t. the actor's parameters only, so no
    critic ``.grad`` is written by the actor loss;
  - actor Adam step, soft target updates (tau), step counter + 1.

The state is updated in place; the metrics are detached tensors.
"""

from __future__ import annotations

import torch

from d4pg_tpu_torch.core.losses import categorical_td_loss, expected_q
from d4pg_tpu_torch.core.updates import soft_update
from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState
from d4pg_tpu_torch.ops.projection import projection
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
        proj = projection(config.support, target_probs, batch.reward,
                          batch.discount)
    pred_probs = state.critic(batch.obs, batch.action)
    critic_loss, td_error = categorical_td_loss(proj, pred_probs, is_weights)
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
