"""Policy clients: the query half of acting, behind one interface.

Counterpart of ``d4pg_tpu/serving/client.py`` (``ActorConfig``,
``resolve_act_device``, ``LocalPolicyClient``, ``RemotePolicyClient``).
The local client pulls published actor weights from a ``WeightStore``
into its own copy of the actor network and answers noisy exploration
actions (``actions``) or greedy ones (``greedy_actions``); it owns the
exploration noise and the epsilon schedule. The remote client asks a
``serving.server.PolicyInferenceServer`` for greedy actions over the
serving wire and adds its own noise. Interface, as in the reference:

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
numpy generator at ``seed + 17`` for the ``random_eps`` branch. The
remote client draws all its noise from numpy generators, the reference's
(``seed + 17``, ``seed + 29``), so given the same served actions it acts
as the reference's client does.

Where acting runs (``ActorConfig.device``) keeps the reference's flag
and meaning: ``cpu``, the default, runs the policy forward on the host
CPU, because the card belongs to the learner and a per-tick round trip
costs more than a small MLP forward (the reference's production shape);
``default`` follows the learner's device. This is that flag, chosen by
the caller, not a fallback: nothing here moves to the CPU because a card
is missing.

The remote client's degradation ladder is the reference's, every rung
counted in ``stats()``: (1) served greedy actions; (2) on a timeout, a
torn (CRC) response, a wire error or EOF the connection is dropped (the
protocol is in order per connection, so a late reply must never match a
newer request); (3) then ``act_deterministic`` on the client's acting
device against the params cached from an optional ``weights`` handle;
(4) with no params anywhere, uniform warm-up actions. The env loop never
blocks past ``timeout`` per request.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.core.noise import ou
from d4pg_tpu_torch.distributed import transport
from d4pg_tpu_torch.envs.normalizer import FrozenNormalizer, RunningMeanStd
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.learner.update import act, act_deterministic, act_ou
from d4pg_tpu_torch.obs.trace import new_trace_id
from d4pg_tpu_torch.serving import protocol


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
        self.obs_norm = adopt_norm_stats(self.weights, self.obs_norm)
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


def adopt_norm_stats(weights, obs_norm):
    """The normalizer view a client acts with after a pull: a remote
    store (``WeightClient``) hands over the learner's statistics with the
    weights; a live in-process ``RunningMeanStd`` stays in charge."""
    ns = getattr(weights, "norm_stats", None)
    if ns is None or isinstance(obs_norm, RunningMeanStd):
        return obs_norm
    if obs_norm is None:
        return FrozenNormalizer(*ns)
    obs_norm.set(*ns)
    return obs_norm


class RemotePolicyClient:
    """Policy queries over the serving wire protocol with the counted
    degradation ladder of the module docstring. Exploration noise stays
    on the client (the server computes greedy actions only), so one
    shared server never correlates exploration across lanes. One lane,
    one client: the request counter, the socket and the generators are
    not shared."""

    def __init__(
        self,
        config: D4PGConfig,
        actor_cfg: ActorConfig,
        host: str,
        port: int,
        *,
        secret: str | None = None,
        lane_id: int = 0,
        seed: int = 0,
        timeout: float = 0.5,
        connect_timeout: float = 1.0,
        reconnect_backoff: float = 0.05,
        weights=None,
        obs_norm=None,
        trace_sample: float = 0.0,
        record_ledger: bool = False,
        learner_device: str | torch.device | None = None,
    ):
        if actor_cfg.noise != "gaussian":
            raise ValueError("RemotePolicyClient supports gaussian noise only")
        self.config = config
        self.cfg = actor_cfg
        self.host, self.port = host, int(port)
        self.secret = secret
        self.lane_id = int(lane_id)
        self.weights = weights
        self.obs_norm = obs_norm
        self.timeout = float(timeout)
        self.connect_timeout = float(connect_timeout)
        self.reconnect_backoff = float(reconnect_backoff)
        self.device = resolve_act_device(actor_cfg.device, learner_device)
        self._epsilon = actor_cfg.epsilon_0
        self._episodes = 0
        self._explore_rng = np.random.default_rng(seed + 17)
        self._noise_rng = np.random.default_rng(seed + 29)
        self._req_counter = 0
        self._sock: socket.socket | None = None
        self._next_connect = 0.0
        self._version = 0
        self._generation = 0
        # rung 3: the actor network of the last pulled params (None until
        # a pull brings some)
        self._fallback_actor = None
        self._fallback_version = 0
        self._trace_sample = float(trace_sample)
        self._trace_rng = np.random.default_rng((seed << 8) ^ 0xD4E2)
        # req_ids whose responses this client acted on: intersected with
        # a ServingChaos ledger, it shows torn responses are rejected
        self.accepted_req_ids: set[int] | None = set() if record_ledger else None
        self.stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "served": 0, "timeouts": 0, "torn_rejected": 0,
            "wire_errors": 0, "no_params": 0, "overload_rejected": 0,
            "fallbacks": 0, "warmup_fallbacks": 0, "reconnects": 0,
        }

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @property
    def version(self) -> int:
        """Version of the params that last acted for this lane (the
        server's snapshot, or the cached fallback's)."""
        return self._version

    @property
    def generation(self) -> int:
        return self._generation

    def _count(self, key: str, n: int = 1) -> None:
        with self.stats_lock:
            self._stats[key] += n

    def stats(self) -> dict:
        with self.stats_lock:
            return dict(self._stats)

    # -- connection ---------------------------------------------------------
    def _ensure_conn(self) -> socket.socket | None:
        if self._sock is not None:
            return self._sock
        now = time.monotonic()
        if now < self._next_connect:
            return None
        try:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.connect_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            transport.client_handshake(s, self.secret)
            s.settimeout(self.timeout)
            self._sock = s
            self._count("reconnects")
            return s
        except (OSError, transport.ProtocolError):
            self._next_connect = now + self.reconnect_backoff
            return None

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- weight pulls (the fallback cache) ----------------------------------
    def pull(self) -> bool:
        """Refresh the fallback params (and the normalizer view) from the
        optional weights handle; the server feeds itself."""
        if self.weights is None:
            return False
        got = self.weights.get_if_newer(self._fallback_version)
        if got is None:
            return False
        self._fallback_version, params = got
        if self._fallback_actor is None:
            self._fallback_actor = self.config.build_actor(
                torch.Generator().manual_seed(0)).to(self.device)
            self._fallback_actor.requires_grad_(False)
        self._fallback_actor.load_state_dict(params)
        self.obs_norm = adopt_norm_stats(self.weights, self.obs_norm)
        return True

    # -- the request path ---------------------------------------------------
    def _request_mu(self, obs: np.ndarray) -> np.ndarray | None:
        """One round trip; None on any failure (each counted)."""
        sock = self._ensure_conn()
        if sock is None:
            return None
        self._req_counter += 1
        req_id = ((self.lane_id & 0xFFF) << 20) | (self._req_counter & 0xFFFFF)
        trace = None
        if self._trace_sample > 0.0 and \
                self._trace_rng.random() < self._trace_sample:
            trace = (new_trace_id(self.lane_id), time.monotonic())
        self._count("requests")
        try:
            sock.sendall(protocol.encode_request(req_id, obs, trace=trace))
            body = protocol.read_frame(sock, protocol.MAGIC_RESPONSE,
                                       transport._recv_exact)
            if body is None:
                raise ConnectionError("server closed")
            rsp = protocol.decode_response(body)
        except protocol.TornFrameError:
            self._count("torn_rejected")
            self._drop_conn()
            return None
        except (TimeoutError, socket.timeout):
            self._count("timeouts")
            self._drop_conn()
            return None
        except (OSError, protocol.ProtocolError, ConnectionError):
            self._count("wire_errors")
            self._drop_conn()
            return None
        if rsp["req_id"] != req_id:
            # in-order protocol: this connection no longer lines up with
            # our requests
            self._count("wire_errors")
            self._drop_conn()
            return None
        if rsp["status"] != protocol.STATUS_OK:
            self._count("overload_rejected"
                        if rsp["status"] == protocol.STATUS_OVERLOAD
                        else "no_params")
            return None
        self._count("served")
        self._generation = rsp["generation"]
        self._version = rsp["version"]
        if self.accepted_req_ids is not None:
            self.accepted_req_ids.add(req_id)
        return rsp["actions"]

    def _fallback_mu(self, obs: np.ndarray) -> np.ndarray | None:
        if self._fallback_actor is None:
            self.pull()
        if self._fallback_actor is None:
            return None
        self._count("fallbacks")
        self._version = self._fallback_version
        return act_deterministic(
            self._fallback_actor,
            torch.as_tensor(obs, device=self.device)).cpu().numpy()

    def actions(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        mu = self._request_mu(obs)
        if mu is None:
            mu = self._fallback_mu(obs)
        if mu is None:
            # rung 4: uniform warm-up, already maximal exploration
            self._count("warmup_fallbacks")
            return self._noise_rng.uniform(
                -1.0, 1.0, (obs.shape[0], self.config.act_dim)
            ).astype(np.float32)
        noise = self._noise_rng.standard_normal(mu.shape).astype(np.float32)
        actions = np.clip(mu + self._epsilon * noise, -1.0, 1.0)
        if self.cfg.random_eps > 0.0:
            rng = self._explore_rng
            mask = rng.random(actions.shape[0]) < self.cfg.random_eps
            if mask.any():
                actions[mask] = rng.uniform(
                    -1.0, 1.0, (int(mask.sum()), actions.shape[1])
                ).astype(actions.dtype)
        return actions

    def greedy_actions(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        mu = self._request_mu(obs)
        if mu is None:
            mu = self._fallback_mu(obs)
        if mu is None:
            raise RuntimeError("no server response and no cached params")
        return mu

    def reset_noise(self, done_mask: np.ndarray) -> None:
        pass  # gaussian noise is memoryless

    def decay_epsilon(self) -> None:
        self._episodes += 1
        c = self.cfg
        self._epsilon = c.min_epsilon + (c.epsilon_0 - c.min_epsilon) * float(
            np.exp(-5.0 * self._episodes / c.epsilon_horizon))

    def close(self) -> None:
        self._drop_conn()
