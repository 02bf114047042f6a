"""Typed experiment configuration and CLI front end.

Counterpart of ``d4pg_tpu/config.py``: the same ``ExperimentConfig``
fields and defaults, the same flags with the same spellings (``--bsize``,
``--rmsize``, ``--n_eps``), defaults and choices, the same ``resolve``
(env presets) and ``run_name``, so one command line means the same run in
both packages. ``learner_config`` builds the port's ``D4PGConfig``.
The fields are documented where the reference defines
them (``d4pg_tpu/config.py``); the port reads three of them differently:

  - ``platform``: ``auto`` and ``accel`` mean the CUDA card and raise
    without one (no probe and no fallback to the CPU); only ``cpu`` runs
    the learner on the CPU;
  - ``replay_storage='auto'`` resolves to ``device`` only when the learner
    is on the card, as the reference resolves it only off the CPU
    backend;
  - ``actor_device``: ``cpu`` acts on the host CPU, ``default`` on the
    learner's device.

The port alone has CURL (Srinivas, Laskin and Abbeel 2020):
``--contrastive curl`` with ``--crop_size``, ``--encoder_tau`` and
``--lr_encoder`` (see ``learner/state.D4PGConfig``, which derives CURL's
crops and encoder from ``contrastive``). The README gives the flag line
of CURL's cheetah-run sizes.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from d4pg_tpu_torch.envs.presets import get_preset, has_preset
from d4pg_tpu_torch.learner.state import D4PGConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    env: str = "Pendulum-v1"
    max_steps: int | None = None
    num_envs: int = 4
    her: bool = False
    her_ratio: float = 0.8
    pixel_size: int = 84
    encoder_width: int = 32
    frame_stack: int = 1
    augment: str = "none"
    augment_pad: int = 4
    share_encoder: bool = False
    crop_size: int = 84
    contrastive: str = "none"
    encoder_tau: float = 0.05
    lr_encoder: float = 1e-3
    reward_scale: float = 1.0
    memory_size: int = 1_000_000
    batch_size: int = 64
    warmup: int = 5000
    prioritized_replay: bool = True
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    per_beta_steps: int = 100_000
    n_steps: int | None = None
    replay_storage: str = "auto"
    fused_replay: str = "auto"
    updates_per_dispatch: int = 40
    learners: int = 1
    sample_on_ingest: bool = False
    sampler: str = "auto"
    agg_mode: str = "async"
    agg_clip: float = 8.0
    agg_transport: str = "auto"
    gamma: float = 0.99
    tau: float = 0.001
    action_l2: float = 0.0
    lr_actor: float = 1e-4
    lr_critic: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    v_min: float | None = None
    v_max: float | None = None
    n_atoms: int = 51
    critic_family: str = "categorical"
    projection: str = "auto"
    hidden: tuple = (256, 256, 256)
    compute_dtype: str = "float32"
    noise: str = "gaussian"
    random_eps: float = 0.0
    normalize_obs: bool = False
    normalize_clip: float = 5.0
    epsilon_0: float = 0.3
    min_epsilon: float = 0.01
    epsilon_horizon: int = 5000
    ou_theta: float = 0.25
    ou_sigma: float = 0.05
    ou_mu: float = 0.0
    actor_device: str = "cpu"
    n_epochs: int = 20
    n_cycles: int = 50
    episodes_per_cycle: int = 16
    train_steps_per_cycle: int = 40
    eval_trials: int = 10
    concurrent_eval: bool = True
    n_workers: int = 1
    coordinator: str = ""
    platform: str = "auto"
    num_processes: int = 1
    process_id: int = 0
    actor_procs: int = 0
    data_parallel: int = 1
    async_actors: bool = False
    serve: bool = False
    serve_host: str = "127.0.0.1"
    serve_secret: str = ""
    serve_transitions_port: int = 0
    serve_weights_port: int = 0
    serve_policy: bool = False
    serve_policy_port: int = 0
    serve_policy_window_s: float = 0.002
    serve_policy_max_rows: int = 256
    serve_policy_sla_s: float = 1.0
    autoscale: bool = False
    autoscale_interval_s: float = 0.25
    weight_window: int = 8
    ingest_shards: int = 1
    trace_sample: float = 0.0
    profile_dir: str = ""
    log_dir: str = "runs"
    seed: int = 0
    checkpoint_every: int = 1
    checkpoint_replay: bool = False
    checkpoint_replay_every: int = 10
    resume: bool = False
    debug: bool = False
    strict_reference: bool = False

    def run_name(self) -> str:
        """Config-encoded run dir, ``exp_<env>_[_PER][_HER]_<n>N_<k>Workers``.
        Resolves first so a preset-defaulted n_steps (None until resolve)
        encodes identically on resolved and unresolved configs."""
        cfg = self.resolve()
        return (
            f"exp_{cfg.env}_"
            f"{'_PER' if cfg.prioritized_replay else ''}"
            f"{'_HER' if cfg.her else ''}"
            f"_{cfg.n_steps}N_{cfg.n_workers}Workers"
        )

    def resolve(self) -> "ExperimentConfig":
        """Fill v_min/v_max (+ reward scale / horizon) from the env preset
        when unset. ``strict_reference`` switches to the original
        implementation's preset values and training hyperparameters."""
        preset = get_preset(self.env, strict=self.strict_reference)
        curated = has_preset(self.env, strict=self.strict_reference)
        updates: dict = {}
        if self.v_min is None:
            updates["v_min"] = preset.v_min
        if self.v_max is None:
            updates["v_max"] = preset.v_max
        if self.reward_scale == 1.0 and preset.reward_scale != 1.0:
            updates["reward_scale"] = preset.reward_scale
        # horizon / n-step: unset (None) -> curated preset value, else the
        # reference defaults (200 / 3); explicit values always win, and the
        # fallback preset's own field defaults never masquerade as curation
        if self.max_steps is None:
            updates["max_steps"] = preset.max_steps if curated else 200
        if self.n_steps is None:
            updates["n_steps"] = preset.n_step if curated else 3
        if self.strict_reference:
            updates.update(
                reward_scale=1.0,
                lr_actor=1e-3,
                lr_critic=1e-3,
                adam_b1=0.9,
                adam_b2=0.9,
                updates_per_dispatch=1,
            )
        return dataclasses.replace(self, **updates) if updates else self

    @property
    def mesh_learner(self) -> bool:
        """Whether these flags select the data-parallel learner."""
        return (self.data_parallel > 1 or self.num_processes > 1
                or bool(self.coordinator))

    def learner_config(self, obs_dim, act_dim: int,
                       device: str | torch.device | None = None,
                       ) -> D4PGConfig:
        """The port's learner config. ``obs_dim`` is an int (vector
        observations) or an [H, W, C] tuple, which selects the
        conv-encoder pixel path. ``projection='auto'`` resolves first,
        through the port's autotuner on ``device`` (``cuda`` by default):
        it times the arms on the card and picks the plain arm on the CPU,
        as the reference does off its accelerator. A mesh learner
        (``--data_parallel > 1``, ``--num_processes > 1`` or a
        ``--coordinator``) resolves ``auto`` to ``einsum`` without timing,
        as the reference does."""
        resolved = self.resolve()
        pixels = not np.isscalar(obs_dim)
        projection = self.projection
        if projection == "auto":
            from d4pg_tpu_torch.ops.autotune import select_projection

            projection = select_projection(
                "auto", batch_size=self.batch_size,
                v_min=float(resolved.v_min), v_max=float(resolved.v_max),
                n_atoms=self.n_atoms, mesh=self.mesh_learner,
                device=device).selected
        return D4PGConfig(
            obs_dim=int(np.prod(obs_dim)) if pixels else int(obs_dim),
            pixels=pixels,
            obs_shape=tuple(obs_dim) if pixels else (),
            act_dim=int(act_dim),
            v_min=float(resolved.v_min),
            v_max=float(resolved.v_max),
            n_atoms=self.n_atoms,
            hidden=tuple(self.hidden),
            critic_family=self.critic_family,
            projection=projection,
            augment=self.augment,
            augment_pad=self.augment_pad,
            share_encoder=self.share_encoder,
            crop_size=self.crop_size,
            contrastive=self.contrastive,
            encoder_tau=self.encoder_tau,
            lr_encoder=self.lr_encoder,
            encoder_channels=(self.encoder_width,) * 4,
            lr_actor=self.lr_actor,
            lr_critic=self.lr_critic,
            adam_b1=self.adam_b1,
            adam_b2=self.adam_b2,
            compute_dtype=self.compute_dtype,
            tau=self.tau,
            gamma=self.gamma,
            action_l2=self.action_l2,
        )


def _add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool, help_: str):
    """0/1 int flags (``--p_replay 1``, ``--her 0``, ...)."""
    parser.add_argument(f"--{name}", type=int, choices=(0, 1),
                        default=int(default), help=help_)


def build_parser() -> argparse.ArgumentParser:
    d = ExperimentConfig()
    p = argparse.ArgumentParser(
        prog="d4pg_tpu_torch.train",
        description="D4PG on PyTorch and CUDA (the port of d4pg_tpu)",
    )
    p.add_argument("--env", default=d.env)
    p.add_argument("--max_steps", type=int, default=d.max_steps)
    p.add_argument("--num_envs", type=int, default=d.num_envs)
    _add_bool_flag(p, "her", d.her, "hindsight experience replay")
    p.add_argument("--her_ratio", type=float, default=d.her_ratio)
    p.add_argument("--pixel_size", type=int, default=d.pixel_size,
                   help="dm_control pixel render height/width")
    p.add_argument("--encoder_width", type=int, default=d.encoder_width,
                   help="conv-encoder channel width (4 layers)")
    p.add_argument("--frame_stack", type=int, default=d.frame_stack,
                   help="frames stacked channel-wise for pixel envs "
                        "(1 = raw frames; 3 = DrQ/D4PG-pixels convention "
                        "— single frames hide velocities)")
    p.add_argument("--augment", choices=("none", "shift"), default=d.augment,
                   help="batch image augmentation in the update (pixel "
                        "envs): 'shift' = DrQ random shift")
    p.add_argument("--augment_pad", type=int, default=d.augment_pad,
                   help="shift radius in pixels (DrQ uses 4 at 84px; "
                        "scale with --pixel_size)")
    _add_bool_flag(p, "share_encoder", d.share_encoder,
                   "critic-trained shared conv encoder (SAC-AE/DrQ; "
                   "pixel envs)")
    p.add_argument("--contrastive", choices=("none", "curl"),
                   default=d.contrastive,
                   help="'curl': CURL's contrastive step (bilinear "
                        "InfoNCE against the momentum key encoder) with "
                        "its random crops, unpadded encoder without tanh "
                        "and the actor's own trunk; one learner, no "
                        "--augment")
    p.add_argument("--crop_size", type=int, default=d.crop_size,
                   help="--contrastive curl: the encoders' square input, "
                        "cut from the stored --pixel_size frames (CURL: "
                        "84 of 100)")
    p.add_argument("--encoder_tau", type=float, default=d.encoder_tau,
                   help="--contrastive curl: soft-update rate of the "
                        "target encoders (the key encoder)")
    p.add_argument("--lr_encoder", type=float, default=d.lr_encoder,
                   help="--contrastive curl: lr of the encoder's and the "
                        "contrastive head's Adams")
    p.add_argument("--hidden", type=int, nargs="+", default=d.hidden,
                   help="the actor's and critic's hidden widths (port "
                        "only; CURL's cheetah-run: 1024 1024)")
    p.add_argument("--rmsize", type=int, default=d.memory_size, dest="memory_size")
    p.add_argument("--bsize", type=int, default=d.batch_size, dest="batch_size")
    p.add_argument("--warmup", type=int, default=d.warmup)
    _add_bool_flag(p, "p_replay", d.prioritized_replay, "prioritized replay")
    p.add_argument("--per_alpha", type=float, default=d.per_alpha)
    p.add_argument("--per_beta0", type=float, default=d.per_beta0)
    p.add_argument("--per_beta_steps", type=int, default=d.per_beta_steps)
    p.add_argument("--n_steps", type=int, default=d.n_steps)
    p.add_argument("--replay_storage", choices=("auto", "host", "device"),
                   default=d.replay_storage)
    p.add_argument("--fused_replay", choices=("auto", "on", "off"),
                   default=d.fused_replay)
    p.add_argument("--updates_per_dispatch", type=int,
                   default=d.updates_per_dispatch)
    p.add_argument("--gamma", type=float, default=d.gamma)
    p.add_argument("--tau", type=float, default=d.tau)
    p.add_argument("--action_l2", type=float, default=d.action_l2)
    p.add_argument("--lr_actor", type=float, default=d.lr_actor)
    p.add_argument("--lr_critic", type=float, default=d.lr_critic)
    p.add_argument("--adam_b1", type=float, default=d.adam_b1)
    p.add_argument("--adam_b2", type=float, default=d.adam_b2)
    p.add_argument("--v_min", type=float, default=None)
    p.add_argument("--v_max", type=float, default=None)
    p.add_argument("--n_atoms", type=int, default=d.n_atoms)
    p.add_argument("--critic_family", choices=("categorical", "mog"),
                   default=d.critic_family)
    p.add_argument("--projection",
                   choices=("auto", "einsum", "pallas", "pallas_ce"),
                   default=d.projection,
                   help="categorical Bellman-projection arm: 'auto' "
                        "(default) times the arms on the card at startup; "
                        "'einsum' runs the plain projection and 'pallas' "
                        "the projection kernel, each then the "
                        "cross-entropy, 'pallas_ce' the "
                        "projection fused into the cross-entropy "
                        "(forward and backward kernels)")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"),
                   default=d.compute_dtype)
    p.add_argument("--noise", choices=("gaussian", "ou"), default=d.noise)
    p.add_argument("--epsilon_0", type=float, default=d.epsilon_0)
    p.add_argument("--random_eps", type=float, default=d.random_eps)
    _add_bool_flag(p, "normalize_obs", d.normalize_obs,
                   "running observation standardization")
    p.add_argument("--normalize_clip", type=float, default=d.normalize_clip)
    p.add_argument("--ou_theta", type=float, default=d.ou_theta)
    p.add_argument("--ou_sigma", type=float, default=d.ou_sigma)
    p.add_argument("--ou_mu", type=float, default=d.ou_mu)
    p.add_argument("--actor_device", choices=("cpu", "default"),
                   default=d.actor_device)
    p.add_argument("--n_eps", type=int, default=d.n_epochs, dest="n_epochs")
    p.add_argument("--n_cycles", type=int, default=d.n_cycles)
    p.add_argument("--episodes_per_cycle", type=int, default=d.episodes_per_cycle)
    p.add_argument("--train_steps_per_cycle", type=int,
                   default=d.train_steps_per_cycle)
    p.add_argument("--eval_trials", type=int, default=d.eval_trials)
    _add_bool_flag(p, "concurrent_eval", d.concurrent_eval,
                   "evaluate on a background thread")
    p.add_argument("--n_workers", type=int, default=d.n_workers)
    p.add_argument("--actor_procs", type=int, default=d.actor_procs)
    p.add_argument("--coordinator", default=d.coordinator)
    p.add_argument("--platform", choices=("auto", "accel", "cpu"),
                   default=d.platform)
    p.add_argument("--num_processes", type=int, default=d.num_processes)
    p.add_argument("--process_id", type=int, default=d.process_id)
    p.add_argument("--data_parallel", type=int, default=d.data_parallel)
    _add_bool_flag(p, "async_actors", d.async_actors,
                   "decoupled actor/learner loop")
    _add_bool_flag(p, "serve", d.serve, "accept remote actors over TCP")
    p.add_argument("--serve_host", default=d.serve_host)
    p.add_argument("--serve_secret", default=d.serve_secret)
    p.add_argument("--serve_transitions_port", type=int,
                   default=d.serve_transitions_port)
    p.add_argument("--serve_weights_port", type=int, default=d.serve_weights_port)
    _add_bool_flag(p, "serve_policy", d.serve_policy,
                   "serve greedy actions to remote actors "
                   "(--policy_port) via the continuous-batching "
                   "policy server")
    p.add_argument("--serve_policy_port", type=int,
                   default=d.serve_policy_port)
    p.add_argument("--serve_policy_window_s", type=float,
                   default=d.serve_policy_window_s,
                   help="continuous-batching window: the first pending "
                        "request waits at most this long for riders")
    p.add_argument("--serve_policy_max_rows", type=int,
                   default=d.serve_policy_max_rows,
                   help="row budget per fused serving dispatch")
    p.add_argument("--serve_policy_sla_s", type=float,
                   default=d.serve_policy_sla_s,
                   help="declared params-freshness SLA: batches served "
                        "from an older snapshot count sla_breaches")
    _add_bool_flag(p, "autoscale", d.autoscale,
                   "run the obs-driven autoscaler (elastic/autoscaler): "
                   "live-adjust serving batch limits, ingest depth, "
                   "dealer pacing and active replica count from "
                   "registry signals, every decision ledgered")
    p.add_argument("--autoscale_interval_s", type=float,
                   default=d.autoscale_interval_s,
                   help="autoscaler control-loop period")
    p.add_argument("--weight_window", type=int, default=d.weight_window,
                   help="weight-broadcast delta window: recent versions "
                        "kept server-side so in-window pullers get "
                        "per-tensor deltas instead of full snapshots")
    p.add_argument("--ingest_shards", type=int, default=d.ingest_shards,
                   help="receiver-side ingest shards: K SO_REUSEPORT "
                        "listeners + K decode/stage workers + one ordered "
                        "merge-commit thread (1 = legacy single drain)")
    p.add_argument("--trace_sample", type=float, default=d.trace_sample,
                   help="arm wire-to-grad trace spans (obs/trace): the "
                        "learner records per-stage latency histograms for "
                        "frames remote actors sample at this rate over "
                        "the raw codec (0 = off)")
    p.add_argument("--learners", type=int, default=d.learners,
                   help="learner replicas: N>1 runs each on its own "
                        "thread against the shared replay service, with "
                        "an aggregator merging their updates into the "
                        "single versioned weight stream (1 = legacy "
                        "fused single-learner loop)")
    p.add_argument("--agg_mode", choices=("async", "sync"),
                   default=d.agg_mode,
                   help="update aggregation: 'async' = IMPACT-style "
                        "clipped staleness-weighted correction, 'sync' = "
                        "N-way averaging barrier")
    p.add_argument("--agg_clip", type=float, default=d.agg_clip,
                   help="staleness-weight clip (async mode): a stale "
                        "update's weight is max(1/(1+lag), 1/clip)")
    p.add_argument("--agg_transport", choices=("auto", "socket", "collective"),
                   default=d.agg_transport,
                   help="how replica updates reach the merge: "
                        "'collective' = mesh-native on-device merge over "
                        "the 'replica' mesh axis (replicas share one "
                        "single-host mesh), 'socket' = host-thread "
                        "aggregator over the update plane (cross-host "
                        "fallback), 'auto' = collective when a mesh is "
                        "present and single-host")
    _add_bool_flag(p, "sample_on_ingest", d.sample_on_ingest,
                   "fuse PER sampling into the receive path: the commit "
                   "thread deals ready-to-train blocks to the learner "
                   "replicas (host replay + prioritized only)")
    p.add_argument("--sampler", choices=("auto", "scan", "pallas", "host"),
                   default=d.sampler,
                   help="sample-path arm for --sample_on_ingest (not "
                        "ported yet)")
    p.add_argument("--profile_dir", default=d.profile_dir)
    p.add_argument("--log_dir", default=d.log_dir)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--reward_scale", type=float, default=d.reward_scale)
    _add_bool_flag(p, "checkpoint_replay", d.checkpoint_replay,
                   "include the replay buffer in checkpoints")
    p.add_argument("--checkpoint_replay_every", type=int,
                   default=d.checkpoint_replay_every)
    _add_bool_flag(p, "resume", d.resume, "resume from latest checkpoint")
    _add_bool_flag(p, "debug", d.debug, "debug logging")
    _add_bool_flag(p, "strict_reference", d.strict_reference,
                   "reference hyperparameter parity mode")
    return p


def parse_args(argv=None) -> ExperimentConfig:
    ns = vars(build_parser().parse_args(argv))
    ns["her"] = bool(ns["her"])
    ns["prioritized_replay"] = bool(ns.pop("p_replay"))
    ns["resume"] = bool(ns["resume"])
    ns["checkpoint_replay"] = bool(ns["checkpoint_replay"])
    ns["debug"] = bool(ns["debug"])
    ns["async_actors"] = bool(ns["async_actors"])
    ns["serve"] = bool(ns["serve"])
    ns["serve_policy"] = bool(ns["serve_policy"])
    ns["concurrent_eval"] = bool(ns["concurrent_eval"])
    ns["strict_reference"] = bool(ns["strict_reference"])
    ns["normalize_obs"] = bool(ns["normalize_obs"])
    ns["sample_on_ingest"] = bool(ns["sample_on_ingest"])
    ns["autoscale"] = bool(ns["autoscale"])
    ns["hidden"] = tuple(ns["hidden"])
    return ExperimentConfig(**ns)
