"""The in-process policy client: the query half of acting.

Counterpart of ``ActorConfig``, ``resolve_act_device`` and
``LocalPolicyClient`` in ``d4pg_tpu/serving/client.py``. The client pulls
published actor weights from a ``WeightStore`` into its own copy of the
actor network and answers noisy exploration actions (``actions``) or
greedy ones (``greedy_actions``); it owns the exploration noise and the
epsilon schedule. Interface, as in the reference:

    pull() -> bool            refresh params if a newer version exists
    actions(obs) -> [B, A]    noisy exploration actions (numpy)
    greedy_actions(obs)       deterministic mu(s) for evaluation
    reset_noise(done_mask)    zero per-env OU state on episode end
    decay_epsilon()           episode-boundary epsilon schedule step
    close()                   no-op locally
    obs_norm                  read-only normalizer view (or None); the
                              caller normalizes the policy input with it

Random draws: the reference holds a JAX key; the client here owns a
``torch.Generator`` seeded from ``seed`` (uniform warm-up actions before
the first publish, Gaussian or OU noise after), and keeps the reference's
numpy generator at ``seed + 17`` for the ``random_eps`` branch.

Where acting runs (``ActorConfig.device``) keeps the reference's flag
and meaning: ``cpu``, the default, runs the policy forward on the host
CPU, because the card belongs to the learner and a per-tick round trip
costs more than a small MLP forward (the reference's production shape);
``default`` follows the learner's device. This is that flag, chosen by
the caller, not a fallback: nothing here moves to the CPU because a card
is missing. The remote client waits for the serving slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.core.noise import ou
from d4pg_tpu_torch.envs.normalizer import FrozenNormalizer, RunningMeanStd
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.learner.update import act, act_deterministic, act_ou


@dataclasses.dataclass
class ActorConfig:
    """Acting-plane config (exploration and env-loop knobs)."""

    epsilon_0: float = 0.3
    min_epsilon: float = 0.01
    epsilon_horizon: int = 5000  # episodes to decay over
    n_step: int = 3
    gamma: float = 0.99
    reward_scale: float = 1.0
    weight_poll_every: int = 1  # pool ticks between version checks
    noise: str = "gaussian"  # 'gaussian' | 'ou'
    # per env per tick probability of a uniform random action
    random_eps: float = 0.0
    ou_theta: float = 0.25
    ou_sigma: float = 0.05
    ou_mu: float = 0.0
    ou_dt: float = 0.01
    # where inference runs: 'cpu' (default) or 'default' (the learner's
    # device); see the module docstring
    device: str = "cpu"

    def __post_init__(self):
        if self.noise not in ("gaussian", "ou"):
            raise ValueError(f"unknown noise process {self.noise!r}")
        if self.device not in ("cpu", "default"):
            raise ValueError(f"unknown actor device {self.device!r}")


def resolve_act_device(kind: str,
                       learner_device: str | torch.device | None = None,
                       ) -> torch.device:
    """The inference device of an acting or eval component: the host CPU
    for ``'cpu'``; the learner's device for ``'default'`` (``cuda`` when
    the caller names none, raising without a card, as every entry point
    of the port does)."""
    if kind not in ("cpu", "default"):
        raise ValueError(f"unknown actor device {kind!r}")
    if kind == "cpu":
        return torch.device("cpu")
    return resolve_device(learner_device)


class LocalPolicyClient:
    """In-process policy queries against a ``WeightStore``-shaped handle."""

    def __init__(
        self,
        config: D4PGConfig,
        actor_cfg: ActorConfig,
        weights,
        seed: int = 0,
        learner_device: str | torch.device | None = None,
        obs_norm=None,
    ):
        self.config = config
        self.cfg = actor_cfg
        self.weights = weights
        # read-only view for the policy input: in-process actors share the
        # service's live RunningMeanStd; a remote actor's client builds a
        # FrozenNormalizer from the statistics its weight pulls carry
        self.obs_norm = obs_norm
        self.device = resolve_act_device(actor_cfg.device, learner_device)
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self._actor = config.build_actor(torch.Generator().manual_seed(0))
        self._actor.to(self.device).requires_grad_(False)
        self._version = 0
        self._has_params = False
        self._epsilon = actor_cfg.epsilon_0
        self._explore_rng = np.random.default_rng(seed + 17)
        self._episodes = 0
        self._ou = None  # lazily sized OU state when cfg.noise == 'ou'

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @property
    def version(self) -> int:
        return self._version

    def _adopt(self, params: dict[str, torch.Tensor]) -> None:
        # load_state_dict copies into the client's own tensors (and onto
        # its device): later publishes never alias them
        self._actor.load_state_dict(params)
        self._has_params = True

    def pull(self) -> bool:
        """Refresh params if the store has a newer version."""
        got = self.weights.get_if_newer(self._version)
        if got is None:
            return False
        self._version, params = got
        self._adopt(params)
        # a remote store (WeightClient) hands over the learner's statistics
        # with the weights; a live in-process RunningMeanStd stays in charge
        ns = getattr(self.weights, "norm_stats", None)
        if ns is not None and not isinstance(self.obs_norm, RunningMeanStd):
            if self.obs_norm is None:
                self.obs_norm = FrozenNormalizer(*ns)
            else:
                self.obs_norm.set(*ns)
        return True

    def snapshot_pull(self) -> tuple[int, int]:
        """Adopt the store's current params whatever their version (the
        evaluator's pull); returns (version, published step)."""
        version, params, published_step = self.weights.snapshot()
        if params is None:
            raise RuntimeError("no weights published yet")
        self._version = version
        self._adopt(params)
        return version, published_step

    def _obs(self, obs: np.ndarray) -> torch.Tensor:
        # each frame keeps its own dtype, as the reference's jnp.asarray:
        # uint8 pixels reach the encoder as uint8 (a quarter of float32's
        # bytes), and the networks cast to their compute dtype
        return torch.as_tensor(np.asarray(obs), device=self.device)

    def actions(self, obs: np.ndarray) -> np.ndarray:
        """Noisy policy actions for a [B, obs_dim] (or [B, H, W, C]) batch;
        uniform random
        in (-1, 1) before the first weight publish (warm-up)."""
        n = obs.shape[0]
        if not self._has_params:
            u = torch.rand((n, self.config.act_dim), generator=self._generator,
                           device=self.device)
            return (2.0 * u - 1.0).cpu().numpy()
        if self.cfg.noise == "ou":
            if self._ou is None or self._ou.x.shape[0] != n:
                self._ou = ou.init(self.config.act_dim, (n,),
                                   device=self.device)
            actions, self._ou = act_ou(
                self._actor, self._obs(obs), self._ou, self._generator,
                epsilon=self._epsilon, theta=self.cfg.ou_theta,
                mu=self.cfg.ou_mu, sigma=self.cfg.ou_sigma, dt=self.cfg.ou_dt)
        else:
            actions = act(self._actor, self._obs(obs), self._generator,
                          self._epsilon)
        actions = actions.cpu().numpy()
        if self.cfg.random_eps > 0.0:
            rng = self._explore_rng
            mask = rng.random(actions.shape[0]) < self.cfg.random_eps
            if mask.any():
                actions = np.array(actions)
                actions[mask] = rng.uniform(
                    -1.0, 1.0, (int(mask.sum()), actions.shape[1])
                ).astype(actions.dtype)
        return actions

    def greedy_actions(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic mu(s) for a [B, obs_dim] (or [B, H, W, C]) batch
        (evaluation)."""
        if not self._has_params:
            raise RuntimeError("no weights pulled yet")
        return act_deterministic(self._actor, self._obs(obs)).cpu().numpy()

    def reset_noise(self, done_mask: np.ndarray) -> None:
        """Zero the OU state of envs whose episode ended."""
        if self._ou is not None and done_mask.any():
            keep = torch.as_tensor(~done_mask, dtype=torch.float32,
                                   device=self.device)[:, None]
            self._ou = self._ou._replace(x=self._ou.x * keep)

    def decay_epsilon(self) -> None:
        """eps = min + (eps0 - min) * exp(-5k / horizon) on episode end."""
        self._episodes += 1
        c = self.cfg
        self._epsilon = c.min_epsilon + (c.epsilon_0 - c.min_epsilon) * float(
            np.exp(-5.0 * self._episodes / c.epsilon_horizon))

    def close(self) -> None:
        pass
