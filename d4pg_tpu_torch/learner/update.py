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
  - IS-weighted mean critic loss, critic Adam step, the tie;
  - policy loss -E[Z(s, pi(s))] through the critic AFTER its Adam step
    (the reference's documented choice, ``learner/update.py:217-225``),
    with gradients taken w.r.t. the actor's parameters only, so no
    critic ``.grad`` is written by the actor loss. A parameter the loss
    does not reach (a shared encoder part) gets a zero gradient, as
    optax gives it, so every Adam step counter advances together;
  - actor Adam step, the tie again (it overwrites what stale Adam
    moments would move), soft target updates (tau), the target tie,
    step counter + 1.

The tie and the tied path. ``config.shares`` names what the actor's
encoder shares with the critic's: the whole encoder
(``share_encoder``, DrQ's) or the convolutions (CURL's). After each
step that writes the critic or the targets, the actor's shared part is
made a copy of the critic's (``core.updates.tie_shared``). The target
then runs one ``shared_part`` forward of the target critic's encoder
on ``next_obs`` for both target heads, each through its ``own_part``,
once the targets are tied (``D4PGState.targets_tied``). The actor step
runs one ``shared_part`` forward of the stepped critic's encoder on
``obs`` and detaches it: the actor's own part reads it with gradient
and the critic's under ``no_grad``, so the policy loss reaches no
shared parameter. That forward keeps its graph under CURL alone, as
the contrastive step's anchor; under DrQ it runs under ``no_grad``.

CURL (``contrastive='curl'``, Srinivas, Laskin and Abbeel 2020,
``curl_sac.py``'s update order) adds three random crops
(``ops.augment.random_crop``) in place of the shift: ``obs`` (also the
anchor), ``next_obs`` and ``pos``, a second crop of the ``obs`` frames;
``encoder_tau`` on the encoder leaves in the soft updates (the target
critic's encoder is the momentum key encoder); and, last, the
contrastive step: the critic's trunk on the actor step's attached map
(the anchor, with gradient), the momentum key encoder on ``pos``
(under ``no_grad``), the [B, B] bilinear logits and their
cross-entropy (``core.losses.contrastive_loss``), its backward through
the trunk and the map's graph, ``encoder_opt`` then ``curl_opt`` on the
one gradient, and the tie. Four encoder forwards and two backwards a
step. The actor step, soft updates and ties write only the actor's
parameters and the targets, so the map is the one the anchor's own
forward would compute; an in-place write to the critic's convolutions
before its backward fails autograd's saved-tensor version check.

Each encoder forward the tied path saves (two a ``share_encoder`` step,
three a CURL step, the anchor's counted by the contrastive step; one
fewer while the targets are not tied, on the first step after
``share_encoder`` is turned on over an unshared state or after a
restore; none without a shared part) adds one to
``update_step.encoder_reused``, reported per grad step as
``encoder.reused`` in ``spans.summary()``; each contrastive step adds
one to ``update_step.contrastive_steps`` (``contrastive.steps``).

The random draws (DrQ offsets, CURL crops, MoG components and normals)
come from the state's generator, or are injected as ``UpdateDraws`` (the
tests hand both packages the same draws). The state is updated in place; the
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
    contrastive_loss,
    cross_entropy_per_sample,
    expected_q,
    weighted_mean,
)
from d4pg_tpu_torch.core.mog import mog_mean, mog_target, mog_td_loss
from d4pg_tpu_torch.core.updates import soft_update, tie_shared
from d4pg_tpu_torch.io.profiling import span, spans
from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState
from d4pg_tpu_torch.ops.augment import random_crop, random_shift
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
    obs_crop: torch.Tensor | None = None  # [B, 2] crop offsets of obs
    next_crop: torch.Tensor | None = None  # of next_obs
    pos_crop: torch.Tensor | None = None  # of pos, CURL's second obs crop

    def at(self, t: int) -> "UpdateDraws":
        """Step ``t`` of stacked draws."""
        return UpdateDraws(*[None if d is None else d[t] for d in self])


@span("update")
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
    ``critic_loss`` / ``actor_loss`` / ``q_mean`` (and ``curl_loss`` with
    CURL) and the per-sample ``td_error`` [B] (the PER priority signal),
    all detached.
    ``grad_reduce(params)``, when given, runs between each ``backward``
    and its Adam step on that network's parameters (the data-parallel
    learner averages their gradients over ranks there,
    ``parallel/data_parallel.grad_reducer``). The update is an ``update``
    span with ``update.augment``, ``update.target``, ``update.critic``,
    ``update.actor``, ``update.soft_targets`` and, with CURL,
    ``update.contrastive`` inside; each encoder tie belongs to the step
    before it."""
    draws = UpdateDraws() if draws is None else draws
    gen = state.generator
    curl = config.contrastive == "curl"
    shares = config.shares
    if config.augment == "shift":
        # obs and next_obs get independent offsets (DrQ's convention)
        with span("update.augment"):
            batch = batch._replace(
                obs=random_shift(batch.obs, config.augment_pad, gen,
                                 offsets=draws.obs_shift),
                next_obs=random_shift(batch.next_obs, config.augment_pad,
                                      gen, offsets=draws.next_shift))
    elif curl:
        # three independent crops, drawn in this order (CURL's sample_cpc)
        with span("update.augment"):
            size = config.crop_size
            obs = random_crop(batch.obs, size, gen, offsets=draws.obs_crop)
            next_obs = random_crop(batch.next_obs, size, gen,
                                   offsets=draws.next_crop)
            pos = random_crop(batch.obs, size, gen, offsets=draws.pos_crop)
            batch = batch._replace(obs=obs, next_obs=next_obs)
    mog = config.critic_family == "mog"

    # --- critic step ------------------------------------------------------
    with span("update.target"), torch.no_grad():
        if shares and state.targets_tied:
            # both target heads on one forward of the tied part
            tc, ta = state.target_critic.encoder, state.target_actor.encoder
            h = tc.shared_part(batch.next_obs, shares)
            next_action = state.target_actor.actor(ta.own_part(h, shares))
            target = state.target_critic.critic(tc.own_part(h, shares),
                                                next_action)
            update_step.encoder_reused += 1
        else:
            next_action = state.target_actor(batch.next_obs)
            target = state.target_critic(batch.next_obs, next_action)
    with span("update.critic"):
        pred = state.critic(batch.obs, batch.action)
        if mog:
            critic_loss, td_error = mog_td_loss(
                pred, mog_target(target, batch.reward, batch.discount), gen,
                config.mog_samples, is_weights, gumbel=draws.gumbel,
                normal=draws.normal)
        else:
            if config.projection == "pallas_ce":
                td_error = projection_ce(config.support, target,
                                         batch.reward, batch.discount, pred)
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
        if shares:
            tie_shared(state.actor, state.critic, shares)

    # --- actor step, through the stepped critic ---------------------------
    with span("update.actor"):
        if shares:
            # one forward of the stepped critic's shared part; CURL's keeps
            # its graph as the contrastive step's anchor
            with torch.set_grad_enabled(curl):
                anchor = state.critic.encoder.shared_part(batch.obs, shares)
            h = anchor.detach()
            with torch.no_grad():
                z = state.critic.encoder.own_part(h, shares)
            action = state.actor.actor(state.actor.encoder.own_part(h, shares))
            q = expected_q(config.support, state.critic.critic(z, action))
            update_step.encoder_reused += 1
        else:
            action = state.actor(batch.obs)
            if mog:
                q = mog_mean(state.critic(batch.obs, action))
            else:
                q = expected_q(config.support,
                               state.critic(batch.obs, action))
        actor_loss = -torch.mean(q)
        if config.action_l2:
            actor_loss = actor_loss + config.action_l2 * torch.mean(
                action**2)
        params = list(state.actor.parameters())
        grads = torch.autograd.grad(actor_loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        if grad_reduce is not None:
            grad_reduce(params)
        state.actor_opt.step()
        if shares:
            tie_shared(state.actor, state.critic, shares)

    # --- soft target updates ----------------------------------------------
    with span("update.soft_targets"):
        encoder_tau = config.encoder_tau if curl else None
        soft_update(state.target_actor, state.actor, config.tau, encoder_tau)
        soft_update(state.target_critic, state.critic, config.tau,
                    encoder_tau)
        if shares:
            tie_shared(state.target_actor, state.target_critic, shares)
    state.targets_tied = shares is not None
    metrics = {}
    if curl:
        metrics["curl_loss"] = _contrastive_step(state, anchor, pos)
    state.step += 1
    actor_loss = actor_loss.detach()
    return {
        "critic_loss": critic_loss.detach(),
        "actor_loss": actor_loss,
        "q_mean": -actor_loss,
        "td_error": td_error.detach(),
        **metrics,
    }


update_step.encoder_reused = 0
update_step.contrastive_steps = 0
spans.count_launches("encoder.reused", lambda: update_step.encoder_reused)
spans.count_launches("contrastive.steps",
                     lambda: update_step.contrastive_steps)


@span("update.contrastive")
def _contrastive_step(state: D4PGState, h: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """CURL's ``update_cpc``: the InfoNCE loss of the critic's encoder on
    the anchors against the momentum key encoder on the positives, one
    backward, ``encoder_opt`` then ``curl_opt`` on its gradient (the
    encoder stepped by both, from their own moments), and the actor's
    convolutions tied again. ``h`` is the anchors' conv map with its
    graph (the actor step's, one forward saved): the critic's trunk runs
    on it here. Returns the detached loss."""
    z_a = state.critic.encoder.trunk(h)
    with torch.no_grad():
        z_pos = state.target_critic.encoder(pos)
    loss = contrastive_loss(state.curl.logits(z_a, z_pos))
    state.encoder_opt.zero_grad(set_to_none=True)
    state.curl_opt.zero_grad(set_to_none=True)
    loss.backward()
    state.encoder_opt.step()
    state.curl_opt.step()
    tie_shared(state.actor, state.critic, "convs")
    update_step.encoder_reused += 1
    update_step.contrastive_steps += 1
    return loss.detach()


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
