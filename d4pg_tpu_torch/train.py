"""Training driver: ``python -m d4pg_tpu_torch.train --env point ...``

Counterpart of the single-learner branches of ``d4pg_tpu/train.py`` and
its ``main()``. The loop is the reference's: epochs x cycles, each cycle
collecting episodes into the central ``ReplayService`` (vectorized actor
pools, n-step folding), then ``train_steps_per_cycle`` grad steps, then a
weight publish, a greedy eval (on a background thread by default),
metrics, and a checkpoint every ``checkpoint_every`` cycles; ``--resume
1`` goes on from the latest checkpoint. ``--async_actors 1`` runs the
actors on threads the whole time instead (publishing after each chunk),
with a supervisor that restarts a dead actor thread once per cycle.

The grad steps take one of two replay paths, resolved from
``--replay_storage`` and ``--fused_replay`` as the reference resolves
them (``resolve_storage``):

  - fused (``device`` storage, fused replay not ``off``): the ring and
    PER trees live on the card (``replay/fused_buffer``) and
    ``learner/loop.FusedLoop`` samples, learns and writes priorities back
    inside each chunk, rows streaming in between chunks;
  - host-sampled (``host`` storage, or ``--fused_replay off``): a
    ``PrioritizedReplayBuffer`` (or a uniform ``ReplayBuffer``) whose PER
    trees are on the host and whose ring is host RAM or a non-fused
    device ring; ``learner/pipeline.ChunkPipeline`` stages K-step chunks
    and writes the priorities back two chunks late, and the ``n % K``
    remainder runs one step at a time with its write-back at once.

``--platform cpu`` with the default flags resolves to the host-sampled
path (``auto`` storage on the CPU is ``host``).

The HER recipe: ``--her 1`` runs ``GoalActorWorker``s on a
goal-conditioned env (``fake-goal``, or a gymnasium_robotics id such as
``FetchReach-v4``) whole episodes at a time, streaming originals and
relabels (the relabels add no env steps); ``--normalize_obs 1`` gives the
replay service a ``RunningMeanStd`` that it folds and normalizes every
row with, which actors and the eval read, which rides the weight
publishes and the checkpoint (two resume refusals keep a run from mixing
raw and normalized space). ``--serve 1`` serves remote
``python -m d4pg_tpu_torch.actor_main`` processes (transitions over TCP,
v1 weight pulls, ``RemotePlanes``), and ``--actor_procs N`` spawns N of
them on this host, supervised once per cycle.

Observability: ``--trace_sample f`` enables the wire-to-grad trace
recorder (``obs/trace``); in-process adds carry no trace id, so no trace
opens until the wire codec is ported and ``wire_to_grad_p95_ms`` stays
absent, as in the reference's in-process run. ``--profile_dir d`` writes
a ``torch.profiler`` trace (Chrome trace JSON) of the first cycle's grad
steps into ``d``, where the reference writes an XLA trace.

Devices. The learner runs on the CUDA card for ``--platform auto`` and
``accel``, and raises when there is none: unlike the reference's
``main()``, the port never falls back to the CPU. Only ``--platform cpu``
runs the learner on the CPU (the tests do). Acting and eval run where
``--actor_device`` says (the host CPU by default).

Every flag value that selects a path the port does not have yet raises
``NotImplementedError`` naming its ROADMAP item (``check_ported``); none
is skipped quietly. gymnasium is imported only inside ``make_env_fn``,
for gymnasium ids, and dm_control only inside ``envs/dmc.DMControlEnv``,
for ``dmc:*`` and ``*-pixels`` ids. Pixel envs (``pixel-point``, the
dm_control pixel tasks, 3-D gymnasium observations) store uint8 [H, W,
C] rows (``--frame_stack k`` stacks k frames on the channels) and train
the conv encoder; ``--critic_family mog`` and ``--compute_dtype
bfloat16`` select the MoG critic and bfloat16 products.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import traceback

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.config import ExperimentConfig, parse_args
from d4pg_tpu_torch.distributed.actor import ActorWorker, GoalActorWorker
from d4pg_tpu_torch.distributed.evaluator import AsyncEvaluator, Evaluator
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.envs.dmc import DMControlEnv, parse_dmc_id
from d4pg_tpu_torch.envs.fake import (
    FakeGoalEnv,
    PixelPointEnv,
    PointMassEnv,
    SlowEnv,
)
from d4pg_tpu_torch.envs.normalizer import RunningMeanStd
from d4pg_tpu_torch.envs.wrappers import FrameStack
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.io.checkpoint import CheckpointManager
from d4pg_tpu_torch.io.metrics import CsvLogger, MetricsBus, TensorBoardSink
from d4pg_tpu_torch.io.profiling import StepTimer
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.learner.pipeline import ChunkPipeline
from d4pg_tpu_torch.learner.state import init_state
from d4pg_tpu_torch.learner.update import multi_update_step, update_step
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.trace import RECORDER as trace_recorder
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.schedule import LinearSchedule
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch
from d4pg_tpu_torch.serving.client import ActorConfig


def _unported(cfg: ExperimentConfig) -> list[tuple[bool, str, str]]:
    """(selected, flag value, ROADMAP item) for each unported path."""
    return [
        (cfg.learners > 1, f"--learners {cfg.learners}", "Queue 1 item 15"),
        (cfg.sample_on_ingest, "--sample_on_ingest 1", "Queue 1 item 14"),
        (cfg.data_parallel > 1, f"--data_parallel {cfg.data_parallel}",
         "Queue 1 item 16"),
        (bool(cfg.coordinator) or cfg.num_processes > 1,
         "--coordinator / --num_processes > 1 (multi-host)",
         "Queue 1 item 16"),
        (cfg.serve_policy, "--serve_policy 1", "Queue 1 item 13"),
        (cfg.autoscale, "--autoscale 1", "Queue 1 item 17"),
        (cfg.ingest_shards > 1, f"--ingest_shards {cfg.ingest_shards}",
         "Queue 1 item 12"),
        (cfg.checkpoint_replay, "--checkpoint_replay 1", "Queue 1 item 17"),
    ]


def check_ported(cfg: ExperimentConfig) -> None:
    """Raise ``NotImplementedError`` for the first flag value that selects
    a path the port does not have yet, naming its ROADMAP item."""
    for selected, what, item in _unported(cfg):
        if selected:
            raise NotImplementedError(
                f"{what} selects a path the PyTorch port does not have yet "
                f"(ROADMAP {item})")


def learner_device(cfg: ExperimentConfig) -> torch.device:
    """``cpu`` for ``--platform cpu``; the CUDA card otherwise, raising
    when there is none (no fallback)."""
    if cfg.platform == "cpu":
        return torch.device("cpu")
    return resolve_device("cuda")


def make_env_fn(cfg: ExperimentConfig, seed: int):
    """A constructor of one env: the fake point mass for ``point`` and
    ``point-slow:<ms>`` (a fixed wall cost per step), the fake pixel env
    for ``pixel-point``, a ``dm_control`` task for ``dmc:*`` and
    ``*-pixels`` ids, else a gymnasium id (gymnasium imported here, only
    then). ``--frame_stack k > 1`` stacks the frames of a pixel env and
    is an error on any other, as in the reference."""
    if ((cfg.env in ("point", "fake-goal")
         or cfg.env.startswith("point-slow:")) and cfg.frame_stack > 1):
        raise ValueError(
            f"--frame_stack {cfg.frame_stack} requires a pixel env; "
            f"{cfg.env!r} is state-observation")
    if cfg.env == "point":
        return lambda: PointMassEnv(horizon=cfg.max_steps, seed=seed)
    if cfg.env.startswith("point-slow:"):
        step_ms = float(cfg.env.split(":", 1)[1])
        return lambda: SlowEnv(PointMassEnv(horizon=cfg.max_steps, seed=seed),
                               step_ms / 1e3)
    if cfg.env == "fake-goal":
        return lambda: FakeGoalEnv(horizon=cfg.max_steps, seed=seed)

    def stack(make_pixel_env):
        if cfg.frame_stack <= 1:
            return make_pixel_env
        return lambda: FrameStack(make_pixel_env(), cfg.frame_stack)

    if cfg.env == "pixel-point":
        return stack(lambda: PixelPointEnv(horizon=cfg.max_steps, seed=seed))
    dmc = parse_dmc_id(cfg.env)
    if dmc is not None:
        domain, task, pixels = dmc
        if not pixels and cfg.frame_stack > 1:
            raise ValueError(
                f"--frame_stack {cfg.frame_stack} requires a pixel env; "
                f"{cfg.env!r} is state-observation")
        make = lambda: DMControlEnv(domain, task, pixels=pixels, seed=seed,
                                    height=cfg.pixel_size,
                                    width=cfg.pixel_size)
        return stack(make) if pixels else make
    import gymnasium as gym

    def make():
        try:
            env = gym.make(cfg.env)
        except (gym.error.NameNotFound, gym.error.VersionNotFound):
            # Fetch, Adroit and Shadow-Hand live in gymnasium_robotics,
            # which registers its ids once imported; their MuJoCo-2 MJCF
            # loads under MuJoCo 3 through the apirate shim
            import gymnasium_robotics

            from d4pg_tpu_torch.envs.robotics_compat import install

            install()
            gym.register_envs(gymnasium_robotics)
            env = gym.make(cfg.env)
        if cfg.frame_stack > 1:
            # stack 3-D (pixel) observations; anything else is a config
            # error, not a flag to drop quietly
            if len(env.observation_space.shape or ()) != 3:
                env.close()
                raise ValueError(
                    f"--frame_stack {cfg.frame_stack} requires pixel "
                    f"[H, W, C] observations; {cfg.env!r} has shape "
                    f"{env.observation_space.shape}")
            return FrameStack(env, cfg.frame_stack)
        return env

    return make


def infer_dims(cfg: ExperimentConfig) -> tuple[int | tuple, int, np.dtype]:
    """obs spec, act dim and obs storage dtype: an int and float32 for
    vector observations (observation plus desired goal for HER's dict
    observations), the [H, W, C] tuple and the dtype of a real reset
    observation for pixels (a float frame is stored as float32; rank
    alone must not decide the dtype)."""
    env = make_env_fn(cfg, seed=0)()
    try:
        shape = env.observation_space.shape
        obs_dtype = np.dtype(np.float32)
        if cfg.her:
            obs, _ = env.reset(seed=0)
            obs_dim = (obs["observation"].shape[-1]
                       + obs["desired_goal"].shape[-1])
        elif len(shape) == 3:  # pixels
            obs_dim = tuple(int(s) for s in shape)
            obs, _ = env.reset(seed=0)
            obs_dtype = np.asarray(obs).dtype
            if np.issubdtype(obs_dtype, np.floating):
                obs_dtype = np.dtype(np.float32)
        else:
            obs_dim = int(np.prod(shape))
        act_dim = int(np.prod(env.action_space.shape))
    finally:
        env.close()
    return obs_dim, act_dim, obs_dtype


def norm_payload(obs_norm: RunningMeanStd) -> dict:
    """The normalizer's state for the checkpoint's ``extra``: its arrays
    as float64 tensors (``torch.load(weights_only=True)`` reads tensors
    and Python scalars, not numpy arrays)."""
    d = obs_norm.state_dict()
    return {**d, "mean": torch.from_numpy(d["mean"]),
            "m2": torch.from_numpy(d["m2"])}


def norm_state_from_payload(payload: dict) -> dict:
    """Invert ``norm_payload``: the ``RunningMeanStd.state_dict`` (the
    checkpoint restores its tensors onto the learner's device)."""
    return {**payload, "mean": payload["mean"].cpu().numpy(),
            "m2": payload["m2"].cpu().numpy()}


class RemotePlanes:
    """``--serve 1`` and ``--actor_procs N``: the transition receiver
    (frames into ``service.add``, the count flag honoured, the service's
    generation in the greeting) and the v1 weight server, their ports
    printed; then N spawned ``actor_main`` processes, seeded
    ``seed + 1000 * (i + 1) + 101 * respawn`` so a respawned child does not
    stream its predecessor's trajectories again. With ``--n_workers 0``
    the learner waits for them to fill the warm-up. ``supervise``, once
    per cycle, respawns a dead child and gives up on a slot after 5
    consecutive failed cycles. The reference serves v1 and v2 weight
    frames from one ``WeightPlaneServer`` port; this serves v1 only
    (ROADMAP Queue 1 item 12)."""

    def __init__(self, cfg: ExperimentConfig, service: ReplayService,
                 weights: WeightStore):
        from d4pg_tpu_torch.distributed.transport import TransitionReceiver

        self.cfg = cfg
        secret = cfg.serve_secret or None
        self.procs: list = []
        self.weight_server = None
        self.receiver = TransitionReceiver(
            lambda b, aid, count: service.add(b, actor_id=aid,
                                              count_env_steps=count),
            host=cfg.serve_host, port=cfg.serve_transitions_port,
            secret=secret, generation=lambda: service.generation)
        try:
            self._start(service, weights, secret)
        except BaseException:
            # what started so far must not outlive a failed start
            self.close()
            raise

    def _start(self, service: ReplayService, weights: WeightStore,
               secret: str | None) -> None:
        from d4pg_tpu_torch.distributed.weight_server import WeightServer

        cfg = self.cfg
        self.weight_server = WeightServer(weights, host=cfg.serve_host,
                                          port=cfg.serve_weights_port,
                                          secret=secret)
        print(f"serving: transitions :{self.receiver.port} weights "
              f":{self.weight_server.port}", flush=True)
        self._gen = [0] * cfg.actor_procs
        self._fails = [0] * cfg.actor_procs
        if cfg.actor_procs <= 0:
            return
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self._host = ("127.0.0.1" if cfg.serve_host in ("0.0.0.0",
                                                        "127.0.0.1")
                      else cfg.serve_host)
        for i in range(cfg.actor_procs):
            self.procs.append(self._spawn(i))
        print(f"spawned {len(self.procs)} actor processes", flush=True)
        if cfg.n_workers == 0 and not service.wait_until(cfg.warmup,
                                                         timeout=300.0):
            raise RuntimeError("actor processes did not reach warmup")

    def _spawn(self, i: int):
        from d4pg_tpu_torch.actor_main import run_local_actor_process

        cfg = self.cfg
        proc_cfg = dataclasses.replace(
            cfg, seed=cfg.seed + 1000 * (i + 1) + 101 * self._gen[i],
            actor_procs=0, serve=False)
        p = self._ctx.Process(
            target=run_local_actor_process,
            args=(proc_cfg, self._host, self.receiver.port,
                  self.weight_server.port, f"proc-{i}",
                  cfg.serve_secret or None, True),
            daemon=True)
        p.start()
        return p

    def supervise(self) -> None:
        for i, p in enumerate(self.procs):
            if p is None:  # slot retired after repeated failures
                continue
            if p.is_alive():
                self._fails[i] = 0
                continue
            self._fails[i] += 1
            if self._fails[i] > 5:
                print(f"supervisor: actor process {i} died "
                      f"{self._fails[i]} consecutive cycles (exitcode "
                      f"{p.exitcode}); giving up on this slot", flush=True)
                self.procs[i] = None
                continue
            self._gen[i] += 1
            print(f"supervisor: restarting actor process {i} (exitcode "
                  f"{p.exitcode}, respawn #{self._gen[i]})", flush=True)
            self.procs[i] = self._spawn(i)

    def close(self) -> None:
        for p in self.procs:
            if p is not None:
                p.terminate()
        for p in self.procs:
            if p is not None:
                p.join(timeout=5.0)
        self.receiver.close()
        if self.weight_server is not None:
            self.weight_server.close()


def resolve_storage(cfg: ExperimentConfig, obs_dim, act_dim: int,
                    device: torch.device,
                    obs_dtype=np.float32) -> tuple[str, bool]:
    """``(storage, fused)`` as the reference resolves ``replay_storage``
    and ``fused_replay`` for one single-host learner
    (``d4pg_tpu/train.py``), with ``device != cpu`` where the reference
    asks ``jax.default_backend() != 'cpu'``: ``auto`` storage is the
    device ring on the card when it fits (under 8e9 bytes, observations
    reckoned at ``obs_dtype``'s itemsize) and host RAM otherwise; the path is fused when the storage is ``device`` and fused
    replay is not ``off``. ``--fused_replay on`` with host storage raises
    ``ValueError``."""
    storage = cfg.replay_storage
    if storage == "auto":
        obs_elems = int(np.prod(obs_dim))
        ring_bytes = cfg.memory_size * (
            2 * obs_elems * np.dtype(obs_dtype).itemsize + (act_dim + 3) * 4)
        # a single-host learner without a mesh keeps the device ring even
        # with fused replay off (the non-fused device ring)
        storage = "device" if device.type != "cpu" and ring_bytes < 8e9 \
            else "host"
    fused = cfg.fused_replay != "off" and storage == "device"
    if cfg.fused_replay == "on" and not fused:
        raise ValueError(
            "--fused_replay on requires device replay storage "
            f"(storage resolved to {storage!r})")
    return storage, fused


def train(cfg: ExperimentConfig) -> dict:
    cfg = cfg.resolve()
    check_ported(cfg)
    device = learner_device(cfg)
    obs_dim, act_dim, obs_dtype = infer_dims(cfg)
    if cfg.normalize_obs and not np.isscalar(obs_dim):
        raise ValueError("--normalize_obs is for vector observations; "
                         "pixel observations are normalized by the encoder")
    run_dir = os.path.join(cfg.log_dir, cfg.run_name())
    os.makedirs(run_dir, exist_ok=True)

    storage, fused = resolve_storage(cfg, obs_dim, act_dim, device,
                                     obs_dtype)
    config = cfg.learner_config(obs_dim, act_dim, device=device)
    state = init_state(config, cfg.seed, device)

    # --- replay, fed through the service ------------------------------------
    if fused:
        buffer = FusedDeviceReplay(cfg.memory_size, obs_dim, act_dim,
                                   alpha=cfg.per_alpha,
                                   prioritized=cfg.prioritized_replay,
                                   device=device, obs_dtype=obs_dtype)
    elif cfg.prioritized_replay:
        buffer = PrioritizedReplayBuffer(cfg.memory_size, obs_dim, act_dim,
                                         alpha=cfg.per_alpha, seed=cfg.seed,
                                         storage=storage, device=device,
                                         obs_dtype=obs_dtype)
    else:
        buffer = ReplayBuffer(cfg.memory_size, obs_dim, act_dim,
                              seed=cfg.seed, storage=storage, device=device,
                              obs_dtype=obs_dtype)
    if cfg.debug:
        print(f"replay storage: {storage} (fused={fused}) on {device}",
              flush=True)
    beta = LinearSchedule(cfg.per_beta_steps, 1.0, cfg.per_beta0)
    # the service's commit thread owns the statistics: it folds every
    # ingested row into them and inserts the rows normalized; actors and
    # the eval read them, remote actors get them with the weights
    obs_norm = (RunningMeanStd(config.obs_dim, clip=cfg.normalize_clip)
                if cfg.normalize_obs else None)
    service = ReplayService(buffer, obs_norm=obs_norm)
    if cfg.trace_sample > 0:
        trace_recorder.enable(cfg.trace_sample)

    # --- io ----------------------------------------------------------------
    bus = MetricsBus(echo=True)
    try:
        bus.add_sink(TensorBoardSink(run_dir))
    except Exception as e:  # tensorboard is optional at run time
        print(f"tensorboard disabled: {e}")
    bus.add_sink(CsvLogger(
        os.path.join(run_dir, "returns.csv"),
        ["avg_test_reward", "ewma_test_reward", "success_rate"]))
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    # the learner's random draws (PER uniforms); checkpointed with the state
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    extra: dict = {}
    if cfg.resume and ckpt.latest_step is not None:
        state, extra = ckpt.restore(state, generator=generator)
        service.set_env_steps(extra.get("env_steps", 0))
        print(f"resumed from step {state.step} ({service.env_steps} env "
              f"steps, {len(service)} replay rows)", flush=True)
    if obs_norm is not None:
        if extra.get("obs_norm"):
            # the statistics the restored policy was trained under
            obs_norm.load_state_dict(norm_state_from_payload(
                extra["obs_norm"]))
        elif cfg.resume and extra.get("env_steps"):
            raise ValueError(
                "--normalize_obs resume from a checkpoint without obs_norm "
                "statistics: the restored policy/replay are in raw space — "
                "resume without the flag, or restart training")
    elif extra.get("obs_norm"):
        raise ValueError(
            "checkpoint was trained with --normalize_obs (its policy and "
            "replay rows live in normalized space); resume with the flag")

    # --- actors + evaluator ------------------------------------------------
    weights = WeightStore()

    def norm_snapshot():
        # (mean, std, clip): the clip travels with the statistics so remote
        # actors standardize exactly as the replay rows were
        return ((*obs_norm.stats(), obs_norm.clip)
                if obs_norm is not None else None)

    weights.publish(state.actor, step=state.step, norm_stats=norm_snapshot())
    actor_cfg = ActorConfig(
        epsilon_0=cfg.epsilon_0, min_epsilon=cfg.min_epsilon,
        epsilon_horizon=cfg.epsilon_horizon, n_step=cfg.n_steps,
        gamma=cfg.gamma, reward_scale=cfg.reward_scale, noise=cfg.noise,
        random_eps=cfg.random_eps, ou_theta=cfg.ou_theta,
        ou_sigma=cfg.ou_sigma, ou_mu=cfg.ou_mu, device=cfg.actor_device)
    actors = []
    for w in range(cfg.n_workers):
        if cfg.her:
            actors.append(GoalActorWorker(
                f"actor-{w}", config, actor_cfg,
                make_env_fn(cfg, seed=cfg.seed + w)(), service, weights,
                her_ratio=cfg.her_ratio, rng_seed=cfg.seed + w,
                seed=cfg.seed + w, obs_norm=obs_norm, learner_device=device))
            continue
        pool = EnvPool([make_env_fn(cfg, seed=cfg.seed + w * cfg.num_envs + i)
                        for i in range(cfg.num_envs)], seed=cfg.seed + w)
        actors.append(ActorWorker(f"actor-{w}", config, actor_cfg, pool,
                                  service, weights, seed=cfg.seed + w,
                                  learner_device=device,
                                  obs_dtype=obs_dtype, obs_norm=obs_norm))
    evaluator = Evaluator(config, make_env_fn(cfg, seed=cfg.seed + 777),
                          weights, max_steps=cfg.max_steps,
                          goal_conditioned=cfg.her, device=cfg.actor_device,
                          obs_norm=obs_norm, learner_device=device)
    async_eval = AsyncEvaluator(evaluator) if cfg.concurrent_eval else None

    # --- warmup (skipped when the buffer already holds enough) -------------
    if len(service) < cfg.warmup:
        warmup_ticks = max(1, cfg.warmup // max(1, cfg.num_envs))
        for actor in actors:
            if cfg.her:
                while actor.env_steps < cfg.warmup // cfg.n_workers:
                    actor.run_episode(cfg.max_steps)
            else:
                actor.run(warmup_ticks // cfg.n_workers)
        service.flush()
    print(f"warmup done: {len(service)} transitions")

    # ``lstep`` is the learner step on the host (the chunks report how
    # many updates they ran), so nothing waits on the card for it
    lstep = state.step
    K = max(1, cfg.updates_per_dispatch)
    fused_loop = (FusedLoop(
        config, buffer, k=K, batch_size=cfg.batch_size, generator=generator,
        prioritized=cfg.prioritized_replay, alpha=cfg.per_alpha,
        beta0=cfg.per_beta0, beta_steps=cfg.per_beta_steps, service=service)
        if fused else None)

    def publish():
        weights.publish(state.actor, step=lstep, norm_stats=norm_snapshot())

    def train_steps_fused(n: int):
        """n fused grad steps (commit -> chunk -> stage per chunk; the
        cycle's staged rows land first)."""

        def on_chunk(chunk_state, k):
            nonlocal lstep
            lstep += k
            if cfg.async_actors:
                # a device copy queued behind the chunk: readers get the
                # weights of this step without the learner waiting
                weights.publish(chunk_state.actor, step=lstep, to_host=False)

        return fused_loop.run(state, n, on_chunk=on_chunk)

    # --- the host-sampled path: K-chunks staged two deep ------------------
    def sample_chunk():
        """One K-chunk: the host tree walks pick [K, B] slots, one storage
        gather fetches the rows (a device ring keeps them on the card)."""
        if cfg.prioritized_replay:
            batches, w, idx, gen = service.sample_chunk(
                K, cfg.batch_size, beta=beta.value(lstep))
            return (batches, w), (idx, gen)
        batches, _, _, _ = service.sample_chunk(K, cfg.batch_size)
        return (batches, None), None

    def per_write_back(aux, td):
        idx, gen = aux
        for i in range(len(idx)):
            service.update_priorities(idx[i], td[i], generation=gen[i])

    def chunk_update(chunk_state, batches, w=None):
        return chunk_state, multi_update_step(config, chunk_state, batches,
                                              w)

    pipeline = (ChunkPipeline(
        chunk_update, sample_chunk,
        write_back=per_write_back if cfg.prioritized_replay else None,
        device=device, use_weights=cfg.prioritized_replay)
        if K > 1 and not fused else None)

    def on_pipeline_chunk(chunk_state):
        nonlocal lstep
        lstep += K
        if cfg.async_actors:
            weights.publish(chunk_state.actor, step=lstep, to_host=False)

    def to_device(batch):
        return TransitionBatch(*[torch.as_tensor(f, device=device)
                                 for f in batch])

    def train_single():
        """One grad step with its priority write-back at once (the
        ``n % K`` remainder, and every step at K = 1)."""
        nonlocal lstep
        if cfg.prioritized_replay:
            batch, w, idx, gen = service.sample(cfg.batch_size,
                                                beta=beta.value(lstep))
            metrics = update_step(config, state, to_device(batch),
                                  torch.as_tensor(w, device=device))
            lstep += 1
            td = metrics["td_error"].cpu().numpy()
            service.update_priorities(idx, np.abs(td) + 1e-6,
                                      generation=gen)
        else:
            metrics = update_step(config, state,
                                  to_device(service.sample(cfg.batch_size)))
            lstep += 1
        return metrics

    def train_steps(n: int):
        """n grad steps on the resolved path; the last step's scalars."""
        if fused:
            metrics = train_steps_fused(n)
        else:
            metrics = None
            n_chunks, remainder = (n // K, n % K) if K > 1 else (0, n)
            if n_chunks:
                if not cfg.async_actors:
                    # sync mode just collected fresh episodes: drop the
                    # chunk sampled before them
                    pipeline.invalidate()
                _, metrics = pipeline.run(state, n_chunks,
                                          on_chunk=on_pipeline_chunk,
                                          final_prefetch=cfg.async_actors)
            for _ in range(remainder):
                metrics = train_single()
        if metrics is None:
            return None
        return {name: (v if v.dim() == 0 else v[-1])
                for name, v in metrics.items()
                if name in ("critic_loss", "actor_loss", "q_mean")}

    stop_actors = threading.Event()
    actor_threads: dict[int, threading.Thread] = {}

    def actor_loop(actor):
        try:
            while not stop_actors.is_set():
                if cfg.her:
                    actor.run_episode(cfg.max_steps)
                else:
                    actor.run(50)
        except Exception as e:  # noqa: BLE001 — an actor crash must not kill training
            # log and exit the thread; the once-per-cycle supervisor
            # restarts it
            print(f"actor {actor.actor_id} crashed:\n"
                  f"{traceback.format_exc()}", flush=True)
            contained_crash(f"actor.{actor.actor_id}", e)

    def start_actor_thread(i: int):
        t = threading.Thread(target=actor_loop, args=(actors[i],),
                             daemon=True)
        t.start()
        actor_threads[i] = t

    def supervise_actors():
        """Actors are stateless-restartable: a dead thread is restarted."""
        for i, t in list(actor_threads.items()):
            if not t.is_alive() and not stop_actors.is_set():
                print(f"supervisor: restarting actor thread {i}", flush=True)
                start_actor_thread(i)

    # --- remote actors over TCP (actor_main) -------------------------------
    remote = RemotePlanes(cfg, service, weights) if (
        cfg.serve or cfg.actor_procs > 0) else None

    try:
        if obs_norm is not None:
            # the warm-up just filled the statistics; remote actors built
            # their normalizer from the pre-warm-up publish: publish again
            # so every actor acts on real statistics from the first grad
            # step
            publish()

        if cfg.async_actors:
            for i in range(len(actors)):
                start_actor_thread(i)

        timer = StepTimer(device=device)
        last_metrics: dict = {}
        for epoch in range(cfg.n_epochs):
            for cycle in range(cfg.n_cycles):
                cycle_t0 = time.monotonic()
                env_steps0 = service.env_steps
                # collect (sync mode; async actors stream in the background)
                if not cfg.async_actors:
                    for actor in actors:
                        if cfg.her:
                            for _ in range(cfg.episodes_per_cycle):
                                actor.run_episode(cfg.max_steps)
                        else:
                            ticks = (cfg.episodes_per_cycle * cfg.max_steps
                                     // max(1, cfg.num_envs))
                            actor.run(ticks)
                    service.flush()
                collect_s = time.monotonic() - cycle_t0
                timer.start()
                if epoch == 0 and cycle == 0 and cfg.profile_dir:
                    metrics = profiled(cfg.profile_dir, device, train_steps,
                                       cfg.train_steps_per_cycle)
                else:
                    metrics = train_steps(cfg.train_steps_per_cycle)
                rate = timer.stop(cfg.train_steps_per_cycle)
                # staleness the actors saw this cycle, before the cycle-end
                # publish
                weight_lag = lstep - weights.step
                publish()
                eval_seed = cfg.seed + epoch * 1000 + cycle
                if async_eval is not None:
                    async_eval.request(cfg.eval_trials, seed=eval_seed)
                    eval_metrics = async_eval.latest()
                else:
                    eval_metrics = evaluator.evaluate(cfg.eval_trials,
                                                      seed=eval_seed)
                last_metrics = {
                    "env_steps": service.env_steps,
                    "weight_lag_steps": weight_lag,
                }
                if metrics is not None:
                    last_metrics["critic_loss"] = float(metrics["critic_loss"])
                    last_metrics["actor_loss"] = float(metrics["actor_loss"])
                if eval_metrics is not None:
                    last_metrics.update({
                        "avg_test_reward": eval_metrics["avg_test_reward"],
                        "ewma_test_reward": eval_metrics["ewma_test_reward"],
                        "success_rate": eval_metrics["success_rate"],
                        "eval_lag_steps": lstep - eval_metrics["learner_step"],
                    })
                if rate is not None:
                    last_metrics["grad_steps_per_sec"] = round(rate, 2)
                if cfg.trace_sample > 0:
                    # the wire-to-grad p95 over the recent trace window
                    lat = trace_recorder.latency_block()
                    if lat["wire_to_grad"]["n"]:
                        last_metrics["wire_to_grad_p95_ms"] = \
                            lat["wire_to_grad"]["p95"]
                cycle_s = time.monotonic() - cycle_t0
                # the collect rate: env steps this cycle over the collect
                # phase (streaming actors, threads or processes: over the
                # whole cycle)
                span = (cycle_s if cfg.async_actors or remote is not None
                        else collect_s)
                if span > 0:
                    last_metrics["env_steps_per_sec"] = round(
                        (service.env_steps - env_steps0) / span, 2)
                last_metrics["cycle_time_s"] = round(cycle_s, 4)
                # heartbeats mean something only for streaming actors
                # (threads, spawned or remote processes): sync actors add once
                # per cycle
                dead = service.dead_actors() if (
                    cfg.async_actors or remote is not None) else []
                last_metrics["dead_actors"] = len(dead)
                if dead:
                    print(f"WARNING: actors missing heartbeats: {dead}",
                          flush=True)
                if remote is not None:
                    remote.supervise()
                if cfg.async_actors:
                    supervise_actors()
                bus.log(lstep, last_metrics)
                if (cycle + 1) % cfg.checkpoint_every == 0:
                    saved = {"env_steps": service.env_steps}
                    if obs_norm is not None:
                        saved["obs_norm"] = norm_payload(obs_norm)
                    ckpt.save(state, extra=saved, generator=generator)
    finally:
        if remote is not None:
            remote.close()
    stop_actors.set()
    for t in actor_threads.values():
        t.join(timeout=10.0)
    if async_eval is not None:
        # the last requested eval, so the result reflects the final weights
        final_eval = async_eval.wait()
        async_eval.close()
        if final_eval is not None:
            last_metrics.update({
                "avg_test_reward": final_eval["avg_test_reward"],
                "ewma_test_reward": final_eval["ewma_test_reward"],
                "success_rate": final_eval["success_rate"],
                "eval_lag_steps": lstep - final_eval["learner_step"],
            })
            bus.log(lstep, last_metrics)
    ckpt.wait()
    bus.close()
    if fused_loop is not None:
        fused_loop.close()
    service.close()
    for actor in actors:
        actor.close()
    return last_metrics


def profiled(profile_dir: str, device: torch.device, fn, *args):
    """``fn(*args)`` under ``torch.profiler`` (host and, on the card,
    device events); the trace goes to ``profile_dir`` as Chrome trace
    JSON (``trace_<pid>_<ns>.json``, viewable in Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace of the first cycle: {path}", flush=True)
    return out


def main(argv=None) -> dict:
    result = train(parse_args(argv))
    print("final:", result)
    return result


if __name__ == "__main__":
    main()
