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
is skipped quietly. gymnasium is imported only
inside ``make_env_fn``, for gymnasium ids.
"""

from __future__ import annotations

import os
import threading
import time
import traceback

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.config import ExperimentConfig, parse_args
from d4pg_tpu_torch.distributed.actor import ActorWorker
from d4pg_tpu_torch.distributed.evaluator import AsyncEvaluator, Evaluator
from d4pg_tpu_torch.distributed.replay_service import ReplayService
from d4pg_tpu_torch.distributed.weights import WeightStore
from d4pg_tpu_torch.envs.fake import PointMassEnv, SlowEnv
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.io.checkpoint import CheckpointManager
from d4pg_tpu_torch.io.metrics import CsvLogger, MetricsBus, TensorBoardSink
from d4pg_tpu_torch.io.profiling import StepTimer
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.learner.pipeline import ChunkPipeline
from d4pg_tpu_torch.learner.state import init_state
from d4pg_tpu_torch.learner.update import multi_update_step, update_step
from d4pg_tpu_torch.obs.trace import RECORDER as trace_recorder
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.schedule import LinearSchedule
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch
from d4pg_tpu_torch.serving.client import ActorConfig


def _unported(cfg: ExperimentConfig) -> list[tuple[bool, str, str]]:
    """(selected, flag value, ROADMAP item) for each unported path."""
    return [
        (cfg.her, "--her 1 (the HER recipe)", "Queue 1 item 11"),
        (cfg.normalize_obs, "--normalize_obs 1", "Queue 1 item 11"),
        (cfg.frame_stack > 1, f"--frame_stack {cfg.frame_stack}",
         "Queue 1 item 9"),
        (cfg.augment != "none", f"--augment {cfg.augment}", "Queue 1 item 9"),
        (cfg.share_encoder, "--share_encoder 1", "Queue 1 item 9"),
        (cfg.critic_family == "mog", "--critic_family mog",
         "Queue 1 item 10"),
        (cfg.compute_dtype != "float32",
         f"--compute_dtype {cfg.compute_dtype}", "Queue 1 item 3"),
        (cfg.learners > 1, f"--learners {cfg.learners}", "Queue 1 item 15"),
        (cfg.sample_on_ingest, "--sample_on_ingest 1", "Queue 1 item 14"),
        (cfg.data_parallel > 1, f"--data_parallel {cfg.data_parallel}",
         "Queue 1 item 16"),
        (bool(cfg.coordinator) or cfg.num_processes > 1,
         "--coordinator / --num_processes > 1 (multi-host)",
         "Queue 1 item 16"),
        (cfg.serve, "--serve 1", "Queue 1 item 12"),
        (cfg.actor_procs > 0, f"--actor_procs {cfg.actor_procs}",
         "Queue 1 item 12"),
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


def _parse_dmc_id(env_id: str):
    """``'dmc:cheetah-run'`` / ``'cheetah-run-pixels'`` -> (domain, task,
    pixels), None when the id is not a dm_control spec (the reference's
    ``envs/dmc.parse_dmc_id``)."""
    name = env_id[4:] if env_id.startswith("dmc:") else env_id
    pixels = name.endswith("-pixels")
    if pixels:
        name = name[: -len("-pixels")]
    elif not env_id.startswith("dmc:"):
        return None
    if "-" not in name:
        return None
    domain, task = name.split("-", 1)
    return domain, task, pixels


def make_env_fn(cfg: ExperimentConfig, seed: int):
    """A constructor of one env: the fake point mass for ``point`` and
    ``point-slow:<ms>`` (a fixed wall cost per step), else a gymnasium id
    (gymnasium imported here, only then)."""
    if cfg.env == "point":
        return lambda: PointMassEnv(horizon=cfg.max_steps, seed=seed)
    if cfg.env.startswith("point-slow:"):
        step_ms = float(cfg.env.split(":", 1)[1])
        return lambda: SlowEnv(PointMassEnv(horizon=cfg.max_steps, seed=seed),
                               step_ms / 1e3)
    if cfg.env == "fake-goal":
        raise NotImplementedError(
            "--env fake-goal (goal-conditioned envs) is not ported yet "
            "(ROADMAP Queue 1 item 11)")
    if cfg.env == "pixel-point" or _parse_dmc_id(cfg.env) is not None:
        raise NotImplementedError(
            f"--env {cfg.env} (pixel and dm_control envs) is not ported "
            "yet (ROADMAP Queue 1 item 9)")
    import gymnasium as gym

    def make():
        try:
            env = gym.make(cfg.env)
        except (gym.error.NameNotFound, gym.error.VersionNotFound) as e:
            raise NotImplementedError(
                f"--env {cfg.env}: not a gymnasium id; the "
                "gymnasium_robotics envs are not ported yet (ROADMAP "
                "Queue 1 item 11)") from e
        if len(env.observation_space.shape or ()) != 1:
            env.close()
            raise NotImplementedError(
                f"--env {cfg.env}: observations of shape "
                f"{env.observation_space.shape}; pixel observations are "
                "not ported yet (ROADMAP Queue 1 item 9)")
        return env

    return make


def infer_dims(cfg: ExperimentConfig) -> tuple[int, int]:
    """obs dim and act dim (vector observations, stored as float32)."""
    env = make_env_fn(cfg, seed=0)()
    try:
        obs_dim = int(np.prod(env.observation_space.shape))
        act_dim = int(np.prod(env.action_space.shape))
    finally:
        env.close()
    return obs_dim, act_dim


def resolve_storage(cfg: ExperimentConfig, obs_dim: int, act_dim: int,
                    device: torch.device) -> tuple[str, bool]:
    """``(storage, fused)`` as the reference resolves ``replay_storage``
    and ``fused_replay`` for one single-host learner
    (``d4pg_tpu/train.py``), with ``device != cpu`` where the reference
    asks ``jax.default_backend() != 'cpu'``: ``auto`` storage is the
    device ring on the card when it fits (under 8e9 bytes) and host RAM
    otherwise; the path is fused when the storage is ``device`` and fused
    replay is not ``off``. ``--fused_replay on`` with host storage raises
    ``ValueError``."""
    storage = cfg.replay_storage
    if storage == "auto":
        ring_bytes = cfg.memory_size * (2 * obs_dim * 4 + (act_dim + 3) * 4)
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
    run_dir = os.path.join(cfg.log_dir, cfg.run_name())
    os.makedirs(run_dir, exist_ok=True)

    obs_dim, act_dim = infer_dims(cfg)
    storage, fused = resolve_storage(cfg, obs_dim, act_dim, device)
    config = cfg.learner_config(obs_dim, act_dim, device=device)
    state = init_state(config, cfg.seed, device)

    # --- replay, fed through the service ------------------------------------
    if fused:
        buffer = FusedDeviceReplay(cfg.memory_size, obs_dim, act_dim,
                                   alpha=cfg.per_alpha,
                                   prioritized=cfg.prioritized_replay,
                                   device=device)
    elif cfg.prioritized_replay:
        buffer = PrioritizedReplayBuffer(cfg.memory_size, obs_dim, act_dim,
                                         alpha=cfg.per_alpha, seed=cfg.seed,
                                         storage=storage, device=device)
    else:
        buffer = ReplayBuffer(cfg.memory_size, obs_dim, act_dim,
                              seed=cfg.seed, storage=storage, device=device)
    if cfg.debug:
        print(f"replay storage: {storage} (fused={fused}) on {device}",
              flush=True)
    beta = LinearSchedule(cfg.per_beta_steps, 1.0, cfg.per_beta0)
    service = ReplayService(buffer)
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
    if cfg.resume and ckpt.latest_step is not None:
        state, extra = ckpt.restore(state, generator=generator)
        service.set_env_steps(extra.get("env_steps", 0))
        print(f"resumed from step {state.step} ({service.env_steps} env "
              f"steps, {len(service)} replay rows)", flush=True)

    # --- actors + evaluator ------------------------------------------------
    weights = WeightStore()
    weights.publish(state.actor, step=state.step)
    actor_cfg = ActorConfig(
        epsilon_0=cfg.epsilon_0, min_epsilon=cfg.min_epsilon,
        epsilon_horizon=cfg.epsilon_horizon, n_step=cfg.n_steps,
        gamma=cfg.gamma, reward_scale=cfg.reward_scale, noise=cfg.noise,
        random_eps=cfg.random_eps, ou_theta=cfg.ou_theta,
        ou_sigma=cfg.ou_sigma, ou_mu=cfg.ou_mu, device=cfg.actor_device)
    actors = []
    for w in range(cfg.n_workers):
        pool = EnvPool([make_env_fn(cfg, seed=cfg.seed + w * cfg.num_envs + i)
                        for i in range(cfg.num_envs)], seed=cfg.seed + w)
        actors.append(ActorWorker(f"actor-{w}", config, actor_cfg, pool,
                                  service, weights, seed=cfg.seed + w,
                                  learner_device=device))
    evaluator = Evaluator(config, make_env_fn(cfg, seed=cfg.seed + 777),
                          weights, max_steps=cfg.max_steps,
                          device=cfg.actor_device, learner_device=device)
    async_eval = AsyncEvaluator(evaluator) if cfg.concurrent_eval else None

    # --- warmup (skipped when the buffer already holds enough) -------------
    if len(service) < cfg.warmup:
        warmup_ticks = max(1, cfg.warmup // max(1, cfg.num_envs))
        for actor in actors:
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
        weights.publish(state.actor, step=lstep)

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
                actor.run(50)
        except Exception:  # noqa: BLE001 — an actor crash must not kill training
            # log and exit the thread; the once-per-cycle supervisor
            # restarts it
            print(f"actor {actor.actor_id} crashed:\n"
                  f"{traceback.format_exc()}", flush=True)

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
                    ticks = cfg.episodes_per_cycle * cfg.max_steps // max(
                        1, cfg.num_envs)
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
            # the collect rate: env steps this cycle over the collect phase
            # (async actors: over the whole cycle)
            span = cycle_s if cfg.async_actors else collect_s
            if span > 0:
                last_metrics["env_steps_per_sec"] = round(
                    (service.env_steps - env_steps0) / span, 2)
            last_metrics["cycle_time_s"] = round(cycle_s, 4)
            # heartbeats mean something only for streaming actors: sync
            # actors add once per cycle
            dead = service.dead_actors() if cfg.async_actors else []
            last_metrics["dead_actors"] = len(dead)
            if dead:
                print(f"WARNING: actors missing heartbeats: {dead}",
                      flush=True)
            if cfg.async_actors:
                supervise_actors()
            bus.log(lstep, last_metrics)
            if (cycle + 1) % cfg.checkpoint_every == 0:
                ckpt.save(state, extra={"env_steps": service.env_steps},
                          generator=generator)
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
        actor.pool.close()
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
