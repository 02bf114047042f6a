"""Training driver: ``python -m d4pg_tpu_torch.train --env point ...``

Counterpart of the single-learner branches of ``d4pg_tpu/train.py`` and
its ``main()``. The loop is the reference's: epochs x cycles, each cycle
collecting episodes into the central ``ReplayService`` (vectorized actor
pools, n-step folding), then ``train_steps_per_cycle`` grad steps, then a
weight publish, a greedy eval (on a background thread by default),
metrics, and a checkpoint every ``checkpoint_every`` cycles; ``--resume
1`` goes on from the latest checkpoint. ``--checkpoint_replay 1`` also
writes the replay service's snapshot (``ReplayService.snapshot``) beside
every ``checkpoint_replay_every``-th checkpoint as a step-stamped sidecar
(``io/checkpoint``), after the checkpoint itself; a resume restores it
into the service (rows, PER state, ticket floor, a generation past the
snapshot's), and a corrupt sidecar, or one ahead of the checkpoint,
leaves the learner to resume alone, which the run prints. ``--async_actors 1`` runs the
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

The learner plane (``--learners N > 1`` or ``--sample_on_ingest 1``, on
the host-sampled path) merges its replicas over one of two transports,
chosen as the reference chooses (``agg_transport``: ``auto`` is
``collective`` exactly when there is a single-host mesh, ``--learners >
1`` and no ``--sample_on_ingest``). ``socket``: N
``learner/replica.LearnerReplica`` threads, each with its own copy of the
state, run one round per cycle (basis, ``ceil(n / N)`` grad steps,
submit) and the in-process ``learner/aggregator.Aggregator``
(``--agg_mode``, ``--agg_clip``) merges them into the one weight stream;
a crashed replica is fenced and respawned, up to 5 cycles in a row.
``collective`` (``--learners N`` with ``--data_parallel M > 1``): one
process drives ``learner/mesh_replicas.MeshReplicaGroup`` (N replicas
placed by ``parallel/mesh.replica_mesh``: all on the card of a one-card
machine, so no M cards are needed; the data mesh is only the gate, as in the
reference, whose collective path never steps its sharded update): each
cycle every replica trains ``ceil(n / N)`` steps on its own
service-sampled chunks, writes its own priorities back, and the round
ends in the on-device merge and its publish (``train_steps_mesh``).
``--sample_on_ingest 1`` deals PER blocks from the replay service's
commit thread into one ring per replica
(``--sampler``, resolved by ``ops/autotune.select_sampler``: ``host``,
the host dealer over the PER buffer; ``scan`` or ``pallas``, the device
dealer over a generation-tracked ``FusedDeviceReplay`` on the learner's
device, ``pallas`` launching the descent kernel once per deal).
``--serve_policy 1`` serves greedy actions to remote actors
(``actor_main --policy_port``) from a ``serving.PolicyInferenceServer``
that adopts the published weights (it acts on the host CPU, as the
reference's driver's does); with ``--n_workers 0`` and no in-process or
spawned actor, the learner waits for remote actors to fill the warm-up.

The elastic plane: ``--autoscale 1`` runs ``elastic.Autoscaler`` beside
the run (``elastic_plane``), every ``--autoscale_interval_s`` seconds
sensing the registry's ``serving`` and ``ingest`` providers and moving the
knobs this run stood up: ``ingest_capacity`` (the service's deques),
``serving_rows`` and ``serving_window_s`` (the policy server's batch
limits, with ``--serve_policy 1``), ``dealer_deals`` (the dealer's pacing,
with ``--sample_on_ingest 1``) and ``replicas`` (the learner plane's
active replicas, ``ReplicaTarget``: the first ``n`` replicas train each
cycle, the rest sit it out, and a parked replica that comes back is
respawned first, fencing its idle epoch). Its set points start at this
run's knobs, and a calm plane moves them down from there, one step per
move (replicas to 1 at the first tick); it is closed first on every exit
path.

The HER recipe: ``--her 1`` runs ``GoalActorWorker``s on a
goal-conditioned env (``fake-goal``, or a gymnasium_robotics id such as
``FetchReach-v4``) whole episodes at a time, streaming originals and
relabels (the relabels add no env steps); ``--normalize_obs 1`` gives the
replay service a ``RunningMeanStd`` that it folds and normalizes every
row with, which actors and the eval read, which rides the weight
publishes and the checkpoint (two resume refusals keep a run from mixing
raw and normalized space). ``--serve 1`` serves remote
``python -m d4pg_tpu_torch.actor_main`` processes (transitions over TCP,
v1 and v2 weight pulls from one ``WeightPlaneServer`` port,
``RemotePlanes``), and ``--actor_procs N`` spawns N of them on this
host, supervised once per cycle. ``--ingest_shards K > 1`` runs the
sharded ingest plane: K receiver listeners on the port, frames handed
undecoded to the replay service's K shard workers
(``ReplayService.add_payload``) and, on the fused path, staged into K
staging rings that merge in admission order
(``FusedDeviceReplay(ingest_shards=K)``); on the host-sampled path the
commit thread inserts.

Observability: ``--trace_sample f`` enables the wire-to-grad trace
recorder (``obs/trace``). A trace opens only for a raw frame that a
remote actor stamped (``actor_main --codec raw --trace_sample``) and
that the sharded plane admitted on its header; in-process adds and the
one-shard receiver, which decodes before the service sees the frame,
carry no trace id, as in the reference. ``--profile_dir d`` writes
a ``torch.profiler`` trace (Chrome trace JSON) of the first cycle's grad
steps into ``d``, where the reference writes an XLA trace, and beside it
``spans_<pid>_<ns>.json``: the summary of the hot path's spans over the
same steps (``io/profiling.spans``: per span its count, host and self
ns and device ms, the host's lead over the device per grad step, kernel
launches per grad step), which the profiler turns on.

Devices. The learner runs on the CUDA card for ``--platform auto`` and
``accel``, and raises when there is none: unlike the reference's
``main()``, the port never falls back to the CPU. Only ``--platform cpu``
runs the learner on the CPU (the tests do). Acting and eval run where
``--actor_device`` says (the host CPU by default).

Data-parallel and multi-process learners (``parallel/``): with
``--data_parallel N`` (spawned local ranks) or ``--coordinator H:P
--num_processes W --process_id r`` the driver runs as one rank of a rank
mesh (``train``, ``run_learner``): the state replicated from rank 0, the
gradients averaged over ranks, on the fused path the rank's own shards
of ``replay/sharded_per.ShardedFusedReplay`` fed by its own actors
(seeded ``seed + 100003 * r``) through ``FusedLoop(mesh=...)``, on the
host-sampled path its own replay sampled B rows a rank (a global batch
of W * B) with one global PER weight base; ``SyncedRunningMeanStd``
under ``--normalize_obs``; rank 0 alone owns io, eval and the state
checkpoint, every rank its replay sidecar ``replay_p<r>.pkl``, and a
resume agrees across ranks (``resume_ranks``).

gymnasium is imported only inside ``make_env_fn``,
for gymnasium ids, and dm_control only inside ``envs/dmc.DMControlEnv``,
for ``dmc:*`` and ``*-pixels`` ids. Pixel envs (``pixel-point``, the
dm_control pixel tasks, 3-D gymnasium observations) store uint8 [H, W,
C] rows (``--frame_stack k`` stacks k frames on the channels) and train
the conv encoder; ``--critic_family mog`` and ``--compute_dtype
bfloat16`` select the MoG critic and bfloat16 products.
"""

from __future__ import annotations

import dataclasses
import json
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
from d4pg_tpu_torch.envs.normalizer import (RunningMeanStd,
                                           SyncedRunningMeanStd)
from d4pg_tpu_torch.envs.wrappers import FrameStack
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.io.checkpoint import (CheckpointManager,
                                          SnapshotCorruptError,
                                          load_replay_sidecar,
                                          save_replay_sidecar)
from d4pg_tpu_torch.io.metrics import CsvLogger, MetricsBus, TensorBoardSink
from d4pg_tpu_torch.io.profiling import StepTimer
from d4pg_tpu_torch.learner.aggregator import Aggregator
from d4pg_tpu_torch.learner.loop import FusedLoop
from d4pg_tpu_torch.learner.pipeline import ChunkPipeline
from d4pg_tpu_torch.learner.replica import LearnerReplica, replica_state
from d4pg_tpu_torch.learner.state import init_state, refuse_contrastive
from d4pg_tpu_torch.learner.update import multi_update_step, update_step
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.trace import RECORDER as trace_recorder
from d4pg_tpu_torch.parallel import multihost
from d4pg_tpu_torch.parallel.mesh import RankMesh
from d4pg_tpu_torch.parallel.data_parallel import (
    check_mesh_compatible,
    make_sharded_multi_update,
    make_sharded_update,
    replicate_state,
)
from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from d4pg_tpu_torch.replay.schedule import LinearSchedule, SharedBetaSchedule
from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, TransitionBatch
from d4pg_tpu_torch.serving.client import ActorConfig


def agg_transport(cfg: ExperimentConfig) -> str | None:
    """The learner plane's merge transport, ``socket`` or ``collective``
    (``None`` without a plane), resolved as the reference resolves it,
    with its four refusals. The reference checks the transport only when
    it stands up a plane (``--learners > 1`` or ``--sample_on_ingest``);
    the port also checks an explicit ``--agg_transport collective``, so
    the flag with one learner is refused, not ignored."""
    if not (cfg.learners > 1 or cfg.sample_on_ingest
            or cfg.agg_transport == "collective"):
        return None
    multi_host = cfg.num_processes > 1 or bool(cfg.coordinator)
    mesh = cfg.mesh_learner
    transport = cfg.agg_transport
    if transport == "auto":
        transport = ("collective" if (mesh and not multi_host
                                      and cfg.learners > 1
                                      and not cfg.sample_on_ingest)
                     else "socket")
    if transport == "collective":
        if not mesh or multi_host:
            raise ValueError(
                "--agg_transport collective needs the replicas on one "
                "single-host device mesh (--data_parallel/"
                "--model_parallel); across hosts the socket update "
                "plane is the fallback")
        if cfg.sample_on_ingest:
            raise ValueError(
                "--sample_on_ingest deals blocks to host-thread "
                "replicas — pair it with --agg_transport socket")
        if cfg.learners < 2:
            raise ValueError(
                "--agg_transport collective needs --learners > 1 "
                "(with one learner the plain mesh path already "
                "covers the device layout)")
    elif multi_host or mesh:
        raise ValueError(
            "--agg_transport socket composes with single-host "
            "unmeshed learners only; replicas sharing a device mesh "
            "take --agg_transport collective (the mesh-native merge)")
    return transport


def learner_device(cfg: ExperimentConfig) -> torch.device:
    """``cpu`` for ``--platform cpu``; the CUDA card otherwise, raising
    when there is none (no fallback)."""
    if cfg.platform == "cpu":
        return torch.device("cpu")
    return resolve_device("cuda")


def _data_parallel_rank(mesh, cfg: ExperimentConfig) -> dict:
    """One ``--data_parallel`` rank: the driver as the reference's process
    r runs it."""
    multihost.barrier(mesh)
    print(f"data-parallel plane: {mesh.describe()}", flush=True)
    return run_learner(cfg, mesh)


def train(cfg: ExperimentConfig) -> dict:
    """Train with the resolved flags. ``--coordinator H:P --num_processes W
    --process_id r`` joins the rank group as rank r of W (on ``cuda:0``
    of this host, or the CPU); ``--data_parallel N`` without a
    coordinator spawns N local ranks (rank r on ``cuda:r``, or the CPU
    with ``--platform cpu``) and returns rank 0's result. Each rank runs
    the driver as the reference's process r does: rank 0 alone owns io,
    eval and the state checkpoint. The collective transport runs one
    process, whatever the mesh flags (see the module docstring)."""
    cfg = cfg.resolve()
    if cfg.learners > 1 or cfg.sample_on_ingest:
        refuse_contrastive(cfg, "the replica group")
    if cfg.mesh_learner:
        # refused before any rank starts, with the rule table
        check_mesh_compatible(cfg)
    if agg_transport(cfg) == "collective":
        # mesh-native replicas: one process, the data mesh only the gate
        return run_learner(cfg, None)
    if cfg.coordinator or cfg.num_processes > 1:
        if not cfg.coordinator:
            raise ValueError(f"--num_processes {cfg.num_processes} needs "
                             "--coordinator host:port (rank 0's address)")
        if cfg.data_parallel not in (1, cfg.num_processes):
            raise ValueError(
                f"--data_parallel {cfg.data_parallel} with a coordinator "
                f"must be 1 or --num_processes ({cfg.num_processes}): one "
                "rank per process")
        device = learner_device(cfg)
        if device.type == "cuda":
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        multihost.initialize(cfg.coordinator, cfg.num_processes,
                             cfg.process_id)
        try:
            mesh = multihost.global_mesh(device)
            # the collective context, while the ranks are in lockstep
            multihost.barrier(mesh)
            print(f"joined the rank group: {mesh.describe()}", flush=True)
            return run_learner(cfg, mesh)
        finally:
            multihost.shutdown()
    if cfg.data_parallel > 1:
        return multihost.spawn_local(
            _data_parallel_rank, cfg.data_parallel, args=(cfg,),
            device_type=learner_device(cfg).type, timeout_s=None)[0]
    return run_learner(cfg, None)


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
    generation in the greeting; with ``--ingest_shards K > 1``, K
    listeners handing undecoded frames to ``service.add_payload``) and the
    weight plane (``WeightPlaneServer``, v1 and v2 pullers on one port,
    ``--weight_window`` versions kept for deltas), their ports printed;
    then N spawned ``actor_main`` processes (v1 pullers, as the
    reference's children are), seeded
    ``seed + 1000 * (i + 1) + 101 * respawn`` so a respawned child does not
    stream its predecessor's trajectories again. With ``--n_workers 0``
    the learner waits for them to fill the warm-up. ``supervise``, once
    per cycle, respawns a dead child and gives up on a slot after 5
    consecutive failed cycles."""

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
            secret=secret, num_shards=cfg.ingest_shards,
            on_payload=(service.add_payload if cfg.ingest_shards > 1
                        else None),
            generation=lambda: service.generation)
        try:
            self._start(service, weights, secret)
        except BaseException:
            # what started so far must not outlive a failed start
            self.close()
            raise

    def _start(self, service: ReplayService, weights: WeightStore,
               secret: str | None) -> None:
        from d4pg_tpu_torch.distributed.weight_plane import WeightPlaneServer

        cfg = self.cfg
        self.weight_server = WeightPlaneServer(
            weights, host=cfg.serve_host, port=cfg.serve_weights_port,
            secret=secret, window=cfg.weight_window)
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
                    device: torch.device, obs_dtype=np.float32,
                    mesh=None) -> tuple[str, bool]:
    """``(storage, fused)`` as the reference resolves ``replay_storage``
    and ``fused_replay`` (``d4pg_tpu/train.py``), with ``device != cpu``
    where the reference asks ``jax.default_backend() != 'cpu'``: ``auto``
    storage is the device ring on the card when it fits (under 8e9 bytes
    per data-axis shard of ``mesh``, observations reckoned at
    ``obs_dtype``'s itemsize) and host RAM otherwise; a mesh learner
    takes device storage only through the fused path. The path is fused
    when the storage is ``device`` and fused replay is not ``off``.
    ``--fused_replay on`` with host storage, and device storage on a mesh
    with fused replay off, raise ``ValueError``."""
    storage = cfg.replay_storage
    n_ring_shards = 1 if mesh is None else mesh.n_shards
    if storage == "auto":
        obs_elems = int(np.prod(obs_dim))
        ring_bytes = cfg.memory_size * (
            2 * obs_elems * np.dtype(obs_dtype).itemsize + (act_dim + 3) * 4)
        # a learner without a mesh keeps the device ring even with fused
        # replay off (the non-fused device ring); a mesh learner only
        # through the fused path
        storage = ("device" if device.type != "cpu"
                   and ring_bytes / n_ring_shards < 8e9
                   and (cfg.fused_replay != "off" or mesh is None)
                   else "host")
    elif storage == "device" and mesh is not None and \
            cfg.fused_replay == "off":
        if cfg.coordinator:
            raise ValueError(
                "--replay_storage device on the multi-host runtime requires "
                "the fused replay path (--fused_replay auto/on); with it "
                "disabled, per-host replay shards stay in host RAM — use "
                "'host' or 'auto'")
        raise ValueError(
            "--replay_storage device with --data_parallel > 1 requires "
            "the fused path (--fused_replay auto/on)")
    fused = cfg.fused_replay != "off" and storage == "device"
    if cfg.fused_replay == "on" and not fused:
        raise ValueError(
            "--fused_replay on requires device replay storage "
            f"(storage resolved to {storage!r})")
    return storage, fused


def _load_host_replay(run_dir: str, process_index: int,
                      step: int) -> tuple[dict | None, int]:
    """``(snap, snap_step)`` of this host's sidecar, ``(None, -1)`` when
    there is none or it is refused, the refusal printed: a corrupt
    sidecar, or one from a step AHEAD of the restored state (the save
    site commits the state before it renames the sidecar, so that means
    mixed-up run directories), resumes the learner alone with an empty
    buffer. A sidecar behind the state is taken with a warning: stale
    rows are still valid experience."""
    try:
        loaded = load_replay_sidecar(run_dir, process_index)
    except SnapshotCorruptError as e:
        print(f"[p{process_index}] replay sidecar is corrupt ({e}); "
              "refusing it — resuming learner-only with an empty buffer",
              flush=True)
        return None, -1
    if loaded is None:
        return None, -1
    snap, snap_step = loaded
    if snap_step > int(step):
        print(f"[p{process_index}] replay sidecar is from step "
              f"{snap_step}, AHEAD of the restored state at step {step}; "
              "refusing it (mixed run dirs?) — starting with an empty "
              "buffer", flush=True)
        return None, -1
    if snap_step < int(step):
        print(f"[p{process_index}] replay sidecar is from step "
              f"{snap_step} ({int(step) - snap_step} steps behind the "
              "restored state); resuming with the slightly-stale buffer",
              flush=True)
    return snap, snap_step


def resume_ranks(mesh, state, generator, ckpt, service: ReplayService,
                 run_dir: str, fused: bool) -> dict:
    """Resume on a rank mesh: rank 0 restores the latest checkpoint into
    ``state`` (and its PER generator) and broadcasts whether it found one,
    the env-step count and the normalizer's statistics; the state itself
    is rank 0's broadcast (``replicate_state``). Every rank then loads
    its own replay sidecar. On the fused path the ranks' shard-sets form
    one logical buffer, so they must come from the same save: when the
    ranks' sidecar steps disagree, or one is missing, every rank starts
    with an empty buffer. Returns the checkpoint's ``extra`` (empty when
    there is none)."""
    found = ckpt is not None and ckpt.latest_step is not None
    extra: dict = {}
    if found:
        _, extra = ckpt.restore(state, generator=generator)
    norm = extra.get("obs_norm")
    meta = mesh.broadcast_object({
        "found": found, "env_steps": int(extra.get("env_steps", 0)),
        "obs_norm": norm_state_from_payload(norm) if norm else None})
    if not meta["found"]:
        return {}
    replicate_state(state, mesh)
    env_steps = meta["env_steps"]
    service.set_env_steps(env_steps)
    snap, snap_step = _load_host_replay(run_dir, mesh.rank, state.step)
    if fused:
        steps = mesh.gather_host(np.array([snap_step], np.int64))[:, 0]
        if steps.min() == steps.max() >= 0:
            _restore_replay(service, snap, env_steps)
        elif snap is not None:
            print(f"[p{mesh.rank}] replay sidecar steps disagree across "
                  f"ranks ({steps.tolist()}); all ranks restart with empty "
                  "replay", flush=True)
    elif snap is not None:
        _restore_replay(service, snap, env_steps)
    print(f"[p{mesh.rank}] resumed from step {state.step} "
          f"({service.env_steps} env steps, {len(service)} replay rows)",
          flush=True)
    out = {"env_steps": env_steps}
    if meta["obs_norm"] is not None:
        d = meta["obs_norm"]
        out["obs_norm"] = {**d, "mean": torch.from_numpy(d["mean"]),
                           "m2": torch.from_numpy(d["m2"])}
    return out


def _restore_replay(service: ReplayService, snap: dict,
                    env_steps: int) -> None:
    """Land a sidecar in the service: a service snapshot through
    ``restore`` (which also moves the generation, fencing frames encoded
    before the crash), a buffer-only dict through ``load_replay_state``.
    The env-step count stays the checkpoint's: a stale sidecar must not
    roll it back."""
    if isinstance(snap, dict) and "buffer" in snap:
        service.restore(snap)
        service.set_env_steps(env_steps)
    else:
        service.load_replay_state(snap)


def run_learner(cfg: ExperimentConfig, mesh) -> dict:
    """The driver on one learner (``mesh`` None) or as one rank of a rank
    mesh (``parallel/mesh.RankMesh``)."""
    device = learner_device(cfg) if mesh is None else mesh.device
    rank = 0 if mesh is None else mesh.rank
    is_main = rank == 0
    if mesh is not None and mesh.world > 1 and device.type == "cpu":
        # CPU ranks share their host's cores with each other and with
        # their actors; at torch's default every rank would start a
        # thread per core. Card ranks keep the default.
        torch.set_num_threads(1)
    obs_dim, act_dim, obs_dtype = infer_dims(cfg)
    if cfg.normalize_obs and not np.isscalar(obs_dim):
        raise ValueError("--normalize_obs is for vector observations; "
                         "pixel observations are normalized by the encoder")
    run_dir = os.path.join(cfg.log_dir, cfg.run_name())
    os.makedirs(run_dir, exist_ok=True)

    transport = agg_transport(cfg)
    # the collective path resolves storage as the reference's mesh
    # learner does (its data mesh is the gate, with the shards it names)
    storage, fused = resolve_storage(
        cfg, obs_dim, act_dim, device, obs_dtype,
        RankMesh.local(device, cfg.data_parallel)
        if transport == "collective" else mesh)
    K = max(1, cfg.updates_per_dispatch)
    dealt_arm = resolve_dealt_arm(cfg, K, device, mesh)
    if dealt_arm in ("scan", "pallas"):
        # the replicas consume dealt blocks: no learner-side fused loop;
        # the service's buffer is the generation-tracked device ring
        fused = False
    config = cfg.learner_config(obs_dim, act_dim, device=device)
    # the same seed on every rank, then rank 0's state broadcast
    state = init_state(config, cfg.seed, device)
    if mesh is not None:
        replicate_state(state, mesh)

    # --- replay, fed through the service ------------------------------------
    if dealt_arm in ("scan", "pallas"):
        # slots pre-assigned on the host; rows, entry priorities and
        # generations landed by the commit thread's dealer, which samples
        # on the device
        buffer = FusedDeviceReplay(cfg.memory_size, obs_dim, act_dim,
                                   alpha=cfg.per_alpha, prioritized=True,
                                   device=device, obs_dtype=obs_dtype,
                                   gen_tracked=True)
    elif fused and mesh is not None:
        if cfg.batch_size % mesh.n_shards:
            # at startup, not after a whole warm-up of rollouts
            raise ValueError(
                f"--bsize {cfg.batch_size} must divide by the mesh's data "
                f"axis ({mesh.n_shards}) for the sharded fused replay path")
        buffer = ShardedFusedReplay(cfg.memory_size, obs_dim, act_dim, mesh,
                                    alpha=cfg.per_alpha,
                                    prioritized=cfg.prioritized_replay,
                                    obs_dtype=obs_dtype)
    elif fused:
        # one staging ring per ingest shard: the service's shard workers
        # stage into them directly (a lone ring would get K pushers)
        buffer = FusedDeviceReplay(cfg.memory_size, obs_dim, act_dim,
                                   alpha=cfg.per_alpha,
                                   prioritized=cfg.prioritized_replay,
                                   device=device, obs_dtype=obs_dtype,
                                   ingest_shards=cfg.ingest_shards)
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
        print(f"replay storage: {storage} (fused={fused}) on {device}"
              + (f", sampler {dealt_arm}" if dealt_arm else ""), flush=True)
    beta = LinearSchedule(cfg.per_beta_steps, 1.0, cfg.per_beta0)
    # the service's commit thread owns the statistics: it folds every
    # ingested row into them and inserts the rows normalized; actors and
    # the eval read them, remote actors get them with the weights
    # (with a mesh, one set of statistics on every rank: each rank folds a
    # delta and ``sync`` merges them at the cycle boundaries)
    obs_norm = None
    if cfg.normalize_obs:
        obs_norm = (RunningMeanStd(config.obs_dim, clip=cfg.normalize_clip)
                    if mesh is None else SyncedRunningMeanStd(
                        config.obs_dim, mesh, clip=cfg.normalize_clip))
    service = ReplayService(buffer, obs_norm=obs_norm,
                            num_ingest_shards=cfg.ingest_shards)
    if cfg.trace_sample > 0:
        trace_recorder.enable(cfg.trace_sample)

    # --- io (rank 0 owns all of it) ----------------------------------------
    bus = MetricsBus(echo=is_main)
    ckpt = None
    if is_main:
        try:
            bus.add_sink(TensorBoardSink(run_dir))
        except Exception as e:  # tensorboard is optional at run time
            print(f"tensorboard disabled: {e}")
        bus.add_sink(CsvLogger(
            os.path.join(run_dir, "returns.csv"),
            ["avg_test_reward", "ewma_test_reward", "success_rate"]))
        ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    # the learner's random draws (PER uniforms), a stream per rank;
    # checkpointed with the state
    generator = torch.Generator(device=device).manual_seed(
        cfg.seed + 100_003 * rank)
    extra: dict = {}
    if cfg.resume and mesh is not None:
        extra = resume_ranks(mesh, state, generator, ckpt, service,
                             run_dir, fused)
    elif cfg.resume and ckpt.latest_step is not None:
        state, extra = ckpt.restore(state, generator=generator)
        service.set_env_steps(extra.get("env_steps", 0))
        # the replay sidecar, when --checkpoint_replay wrote one: stale
        # ones are taken, corrupt or ahead-of-state ones refused (the
        # learner resumes alone, and says so)
        snap, _ = _load_host_replay(run_dir, 0, state.step)
        if snap:
            _restore_replay(service, snap, extra.get("env_steps", 0))
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
    # the learner's seed is every rank's (replicated params); each rank's
    # actors explore from their own
    aseed = cfg.seed + 100_003 * rank
    actors = []
    for w in range(cfg.n_workers):
        if cfg.her:
            actors.append(GoalActorWorker(
                f"actor-{w}", config, actor_cfg,
                make_env_fn(cfg, seed=aseed + w)(), service, weights,
                her_ratio=cfg.her_ratio, rng_seed=aseed + w,
                seed=aseed + w, obs_norm=obs_norm, learner_device=device))
            continue
        pool = EnvPool([make_env_fn(cfg, seed=aseed + w * cfg.num_envs + i)
                        for i in range(cfg.num_envs)], seed=aseed + w)
        actors.append(ActorWorker(f"actor-{w}", config, actor_cfg, pool,
                                  service, weights, seed=aseed + w,
                                  learner_device=device,
                                  obs_dtype=obs_dtype, obs_norm=obs_norm))
    # rank 0 owns eval
    evaluator = (Evaluator(config, make_env_fn(cfg, seed=cfg.seed + 777),
                           weights, max_steps=cfg.max_steps,
                           goal_conditioned=cfg.her,
                           device=cfg.actor_device, obs_norm=obs_norm,
                           learner_device=device)
                 if is_main else None)
    async_eval = (AsyncEvaluator(evaluator)
                  if cfg.concurrent_eval and evaluator is not None else None)

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
    replicas, aggregator, group = [], None, None
    if transport == "collective":
        group = mesh_replica_group(cfg, config, state, weights, fused, K,
                                   norm_snapshot)
    elif transport == "socket":
        replicas, aggregator = learner_plane(cfg, config, state, service,
                                             weights, fused, dealt_arm, K,
                                             norm_snapshot)
    fused_loop = (FusedLoop(
        config, buffer, k=K, batch_size=cfg.batch_size, generator=generator,
        prioritized=cfg.prioritized_replay, alpha=cfg.per_alpha,
        beta0=cfg.per_beta0, beta_steps=cfg.per_beta_steps, service=service,
        mesh=mesh)
        if fused else None)

    def publish():
        if replicas or group is not None:
            # the aggregator or the group owns the version stream (one
            # writer)
            return
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
    # With a mesh every rank samples B rows of its own replay (a global
    # batch of world * B rows) and the updates average the gradients over
    # ranks; every rank normalizes its IS weights by one global base,
    # refreshed once per ``train_steps`` call.
    weight_base: dict = {"z": None}

    def refresh_weight_base():
        if mesh is not None and cfg.prioritized_replay:
            weight_base["z"] = multihost.global_min_scalar(
                mesh, service.weight_base())

    def sample_chunk():
        """One K-chunk: the host tree walks pick [K, B] slots, one storage
        gather fetches the rows (a device ring keeps them on the card)."""
        if cfg.prioritized_replay:
            batches, w, idx, gen = service.sample_chunk(
                K, cfg.batch_size, beta=beta.value(lstep),
                weight_base=weight_base["z"])
            return (batches, w), (idx, gen)
        batches, _, _, _ = service.sample_chunk(K, cfg.batch_size)
        return (batches, None), None

    def per_write_back(aux, td):
        idx, gen = aux
        for i in range(len(idx)):
            service.update_priorities(idx[i], td[i], generation=gen[i])

    sharded_update, sharded_multi = (None, None) if mesh is None else (
        make_sharded_update(config, mesh,
                            use_is_weights=cfg.prioritized_replay),
        make_sharded_multi_update(config, mesh,
                                  use_is_weights=cfg.prioritized_replay))

    def chunk_update(chunk_state, batches, w=None):
        if sharded_multi is not None:
            return chunk_state, sharded_multi(chunk_state, batches, w)
        return chunk_state, multi_update_step(config, chunk_state, batches,
                                              w)

    # with a mesh each rank's chunk is its block of the global
    # [K, world * B] one, and its td rows are the ones it sampled
    pipeline = (ChunkPipeline(
        chunk_update, sample_chunk,
        write_back=per_write_back if cfg.prioritized_replay else None,
        device=device, use_weights=cfg.prioritized_replay)
        if K > 1 and not fused and not replicas else None)

    def on_pipeline_chunk(chunk_state):
        nonlocal lstep
        lstep += K
        if cfg.async_actors:
            weights.publish(chunk_state.actor, step=lstep, to_host=False)

    def to_device(batch):
        return TransitionBatch(*[torch.as_tensor(f, device=device)
                                 for f in batch])

    def single_update(batch, w=None):
        w = None if w is None else torch.as_tensor(w, device=device)
        if sharded_update is not None:
            return sharded_update(state, to_device(batch), w)
        return update_step(config, state, to_device(batch), w)

    def train_single():
        """One grad step with its priority write-back at once (the
        ``n % K`` remainder, and every step at K = 1)."""
        nonlocal lstep
        if cfg.prioritized_replay:
            batch, w, idx, gen = service.sample(
                cfg.batch_size, beta=beta.value(lstep),
                weight_base=weight_base["z"])
            metrics = single_update(batch, w)
            lstep += 1
            # with a mesh, this rank's rows: the ones its own buffer
            # sampled
            td = metrics["td_error"].cpu().numpy()
            service.update_priorities(idx, np.abs(td) + 1e-6,
                                      generation=gen)
        else:
            metrics = single_update(service.sample(cfg.batch_size))
            lstep += 1
        return metrics

    replica_failures: dict[int, int] = {}
    # the autoscaler's ``replicas`` knob (all replicas active without one)
    replica_target = ReplicaTarget(len(replicas))

    def train_steps_multi(n: int):
        """The cycle's n grad steps across the active replicas (the
        ``replica_target`` adopted at this cycle boundary): each runs one
        round of ``ceil(n / N)`` steps on its own thread. A crashed replica
        is fenced (its in-flight submission bounces) and respawned at the
        next epoch; 5 failed cycles in a row end the run."""
        nonlocal state, lstep
        active = replica_target.activate(replicas)
        per = -(-n // len(active))
        failed: dict[int, str] = {}

        def run_replica(r):
            try:
                r.run_round(per)
            except Exception as e:  # noqa: BLE001 — the supervisor decides
                failed[r.replica_id] = traceback.format_exc()
                contained_crash(f"learner.replica{r.replica_id}", e)

        threads = [threading.Thread(target=run_replica, args=(r,),
                                    daemon=True, name=f"replica-{i}")
                   for i, r in enumerate(active)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for r in active:
            if r.replica_id in failed:
                fails = replica_failures.get(r.replica_id, 0) + 1
                replica_failures[r.replica_id] = fails
                print(f"learner replica {r.replica_id} crashed ({fails} "
                      f"consecutive):\n{failed[r.replica_id]}", flush=True)
                if fails >= 5:
                    raise RuntimeError(
                        f"learner replica {r.replica_id} failed {fails} "
                        "cycles in a row; giving up")
                r.respawn()
            else:
                replica_failures[r.replica_id] = 0
        # replica 0's state stands in for the checkpoint and the eval lag;
        # the published params are the aggregate's
        state = replicas[0].state
        lstep = max([lstep] + [r.state.step for r in replicas])
        return replicas[0].last_metrics

    # one anneal clock for the group's replicas (the thread replicas
    # share theirs through ``learner_plane``)
    group_beta = SharedBetaSchedule(beta0=cfg.per_beta0,
                                    beta_steps=cfg.per_beta_steps)

    def train_steps_mesh(n: int):
        """The cycle's grad steps on the mesh-native replica group: each
        replica trains ``ceil(n / N)`` service-sampled steps (N chunks of
        K stacked into one [N, K, B, ...] step), writes the priorities of
        the rows IT sampled back with their generation, then the round
        ends in the on-device merge and its publish. Round-synchronous:
        replica i's update is folded at lag i (async)."""
        nonlocal state, lstep
        per = -(-n // group.n)
        # one beta per round, shared by every replica's sampler
        beta_now = group_beta.beta_at(group_beta.current_step())
        metrics = None
        done = 0
        while done < per:
            k = min(K, per - done)
            if cfg.prioritized_replay:
                chunks = [service.sample_chunk(
                    k, cfg.batch_size, beta=beta_now,
                    weight_base=service.weight_base())
                    for _ in range(group.n)]
                w = np.stack([np.asarray(c[1], np.float32) for c in chunks])
            else:
                chunks = [service.sample_chunk(k, cfg.batch_size)
                          for _ in range(group.n)]
                w = None
            batches = TransitionBatch(*[np.stack(xs) for xs in zip(
                *[c[0] for c in chunks])])
            metrics = group.step_host_chunks(batches, w)
            if cfg.prioritized_replay:
                td = metrics["td_error"].cpu().numpy()  # [N, K, B]
                for i, c in enumerate(chunks):
                    service.update_priorities(
                        c[2], np.abs(td[i]) + 1e-6, generation=c[3])
            done += k
        group_beta.advance(per)
        group.merge()
        # replica 0's state stands in for the checkpoint and the eval lag;
        # the published params are the merged tree
        state = group.state_slice(0)
        lstep = max([lstep] + [group.state_slice(i).step
                               for i in range(group.n)])
        if metrics is None:
            return None
        return {name: metrics[name][0] for name in
                ("critic_loss", "actor_loss", "q_mean")}

    def train_steps(n: int):
        """n grad steps on the resolved path; the last step's scalars."""
        if group is not None:
            metrics = train_steps_mesh(n)
        elif replicas:
            metrics = train_steps_multi(n)
        elif fused:
            metrics = train_steps_fused(n)
        else:
            refresh_weight_base()
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
                if name in ("critic_loss", "actor_loss", "q_mean",
                            "curl_loss")}

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
    policy_server = None
    autoscaler = None

    try:
        if cfg.serve_policy:
            # greedy actions for --policy_port actors, one forward per
            # batching window, from the weights this store publishes
            from d4pg_tpu_torch.serving.server import PolicyInferenceServer

            policy_server = PolicyInferenceServer(
                config, weights, host=cfg.serve_host,
                port=cfg.serve_policy_port, secret=cfg.serve_secret or None,
                batch_window_s=cfg.serve_policy_window_s,
                max_batch_rows=cfg.serve_policy_max_rows,
                sla_staleness_s=cfg.serve_policy_sla_s)
            print(f"serving: policy :{policy_server.port}", flush=True)
        if cfg.autoscale:
            autoscaler = elastic_plane(cfg, service, policy_server,
                                       replicas, replica_target)
        if (remote is not None and cfg.n_workers == 0
                and cfg.actor_procs == 0 and len(service) < cfg.warmup):
            # remote actors only: they fill the warm-up
            if not service.wait_until(cfg.warmup, timeout=300.0):
                raise RuntimeError("remote actors did not reach warmup")

        if obs_norm is not None:
            if mesh is not None:
                # every rank's warm-up rows into the shared statistics
                # before anything trains (collective)
                obs_norm.sync()
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
        n_saves = 0
        if mesh is not None:
            # align the first sharded update (warm-up and io differ by
            # rank)
            multihost.barrier(mesh)
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
                if mesh is not None and obs_norm is not None:
                    # collective: every rank standardizes this cycle with
                    # the same statistics
                    obs_norm.sync()
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
                elif evaluator is not None:
                    eval_metrics = evaluator.evaluate(cfg.eval_trials,
                                                      seed=eval_seed)
                else:
                    eval_metrics = None
                last_metrics = {
                    "env_steps": service.env_steps,
                    "weight_lag_steps": weight_lag,
                }
                if metrics is not None:
                    last_metrics["critic_loss"] = float(metrics["critic_loss"])
                    last_metrics["actor_loss"] = float(metrics["actor_loss"])
                    if "curl_loss" in metrics:
                        last_metrics["curl_loss"] = float(
                            metrics["curl_loss"])
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
                    n_saves += 1
                    if ckpt is not None:
                        saved = {"env_steps": service.env_steps}
                        if obs_norm is not None:
                            saved["obs_norm"] = norm_payload(obs_norm)
                        ckpt.save(state, extra=saved, generator=generator)
                    if (cfg.checkpoint_replay and n_saves
                            % max(1, cfg.checkpoint_replay_every) == 0):
                        # the state checkpoint is on disk before the
                        # sidecar's rename (saves are synchronous), so a
                        # crash between them never leaves a sidecar ahead
                        # of the latest state. The cut holds the buffer
                        # lock across a device-to-host copy of the ring,
                        # hence the coarser cadence. Every rank writes
                        # its own shard-set's sidecar.
                        save_replay_sidecar(
                            run_dir, rank, lstep,
                            service.snapshot(quiesce_timeout=2.0))
    finally:
        if autoscaler is not None:
            # first: a tick during the teardown would actuate knobs of
            # planes already half closed
            autoscaler.close()
        if policy_server is not None:
            policy_server.close()
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
    if ckpt is not None:
        ckpt.wait()
    bus.close()
    for r in replicas:
        r.close()
    if aggregator is not None:
        aggregator.close()
    if group is not None:
        group.close()
    if fused_loop is not None:
        fused_loop.close()
    service.close()
    for actor in actors:
        actor.close()
    if mesh is not None:
        # a rank leaving while a peer still evaluates or checkpoints
        # would break the peer's next collective
        multihost.barrier(mesh)
    return last_metrics


def resolve_dealt_arm(cfg: ExperimentConfig, k: int,
                      device: torch.device, mesh=None) -> str | None:
    """The ``--sampler`` arm of ``--sample_on_ingest 1`` with PER (None
    otherwise), resolved before the buffer is built: ``scan`` and
    ``pallas`` change what the service owns."""
    if not (cfg.sample_on_ingest and cfg.prioritized_replay):
        return None
    from d4pg_tpu_torch.ops.autotune import select_sampler

    arm = select_sampler(cfg.sampler, capacity=cfg.memory_size, k=k,
                         batch_size=cfg.batch_size, device=device).selected
    if arm in ("scan", "pallas"):
        if mesh is not None:
            raise ValueError(
                "--sampler scan/pallas (device-dealt) makes the commit "
                "thread the single owner of every device handle — "
                "mesh/multi-host learners need --sampler host")
        if cfg.ingest_shards != 1:
            raise ValueError(
                "--sampler scan/pallas needs --ingest_shards 1: the "
                "generation-tracked ring pre-assigns slots under the one "
                "commit thread (shard it with --sampler host instead)")
        if cfg.fused_replay == "on":
            raise ValueError(
                "--fused_replay on (the FusedLoop learner) conflicts with "
                "--sample_on_ingest: the device-dealt arm owns the commit "
                "itself; drop --fused_replay on")
    return arm


def _check_host_sampled(fused: bool) -> None:
    if fused:
        raise ValueError(
            "--learners > 1 / --sample_on_ingest need the host-sampled "
            "replay path (the FusedLoop learner is single-consumer: pass "
            "--fused_replay off; device sampling under --sample_on_ingest "
            "is --sampler scan/pallas)")


def mesh_replica_group(cfg: ExperimentConfig, config, state, weights,
                       fused: bool, k: int, norm_snapshot):
    """The collective transport's ``MeshReplicaGroup``: ``--learners``
    replicas built as the socket path builds them (``replica_state``),
    placed by ``replica_mesh`` over the learner's cards (every replica on
    the card of a one-card machine), publishing the merged actor through
    the store."""
    from d4pg_tpu_torch.learner.mesh_replicas import MeshReplicaGroup
    from d4pg_tpu_torch.parallel.mesh import replica_mesh

    _check_host_sampled(fused)
    n = cfg.learners
    device = state.device
    placement = replica_mesh(n, None if device.type == "cuda" else [device])
    states = [replica_state(state, i, cfg.seed, dev)
              for i, dev in enumerate(placement)]
    group = MeshReplicaGroup(
        config, states, k=k, batch_size=cfg.batch_size, mode=cfg.agg_mode,
        clip=cfg.agg_clip, store=weights,
        # actors pull acting params only, as with the aggregator
        extract=lambda tree: tree["actor_params"], norm_stats=norm_snapshot,
        prioritized=cfg.prioritized_replay, alpha=cfg.per_alpha,
        beta0=cfg.per_beta0, beta_steps=cfg.per_beta_steps,
        devices=placement)
    print(f"learner plane: {n} mesh-native replicas (collective merge) on "
          f"{', '.join(str(d) for d in placement)}, mode={cfg.agg_mode} "
          f"clip={cfg.agg_clip}", flush=True)
    return group


def learner_plane(cfg: ExperimentConfig, config, state, service, weights,
                  fused: bool, dealt_arm: str | None, k: int,
                  norm_snapshot):
    """``(replicas, aggregator)`` of the socket transport (``--learners N
    > 1`` or ``--sample_on_ingest 1``): the dealer, when there is one,
    attached to the service with one ring per replica, the in-process
    aggregator and N replicas on their own state copies."""
    _check_host_sampled(fused)
    if cfg.sample_on_ingest and not cfg.prioritized_replay:
        raise ValueError(
            "--sample_on_ingest is the PER dealer: it needs --p_replay "
            "(dealt blocks carry IS weights)")
    n_learners = max(1, cfg.learners)
    # one anneal clock for every sampler in the process
    beta_sched = SharedBetaSchedule(beta0=cfg.per_beta0,
                                    beta_steps=cfg.per_beta_steps)
    rings: list = []
    if cfg.sample_on_ingest:
        from d4pg_tpu_torch.replay.staging import DealtBlockRing

        rings = [DealtBlockRing(4) for _ in range(n_learners)]
        if dealt_arm in ("scan", "pallas"):
            from d4pg_tpu_torch.replay.device_sampler import (
                DeviceSampleDealer)

            dealer = DeviceSampleDealer(
                cfg.memory_size, rings, k=k, batch_size=cfg.batch_size,
                alpha=cfg.per_alpha, beta_schedule=beta_sched,
                min_size=max(1, cfg.batch_size), seed=cfg.seed,
                arm=dealt_arm)
        else:
            from d4pg_tpu_torch.replay.sampler import SampleDealer

            dealer = SampleDealer(
                cfg.memory_size, rings, n_shards=cfg.ingest_shards, k=k,
                batch_size=cfg.batch_size, alpha=cfg.per_alpha,
                beta_schedule=beta_sched, min_size=max(1, cfg.batch_size),
                seed=cfg.seed)
        service.attach_dealer(dealer)
    aggregator = Aggregator(
        weights, mode=cfg.agg_mode, clip=cfg.agg_clip,
        # actors pull acting params; the four-field tree stays between
        # the replicas and the aggregator
        extract=lambda tree: tree["actor_params"], norm_stats=norm_snapshot)
    replicas = [LearnerReplica(
        i, config, aggregator, replica_state(state, i, cfg.seed), k=k,
        batch_size=cfg.batch_size, prioritized=cfg.prioritized_replay,
        alpha=cfg.per_alpha, beta0=cfg.per_beta0,
        beta_steps=cfg.per_beta_steps, service=service,
        dealt_ring=rings[i] if rings else None, beta_schedule=beta_sched)
        for i in range(n_learners)]
    print(f"learner plane: {n_learners} replicas, mode={cfg.agg_mode} "
          f"clip={cfg.agg_clip} sample_on_ingest={cfg.sample_on_ingest}"
          + (f" sampler={dealt_arm}" if dealt_arm else ""), flush=True)
    return replicas, aggregator


class ReplicaTarget:
    """Active-prefix scheduling of the learner replicas (the autoscaler's
    ``replicas`` knob). The autoscaler's thread only records the bounded
    target (``set``); the train loop adopts it at the next cycle boundary
    (``activate``), since re-registering touches the aggregator's epoch
    table, which belongs to the thread that runs the rounds. Replicas past
    the target are parked for the cycle; a parked replica that comes back
    calls ``respawn`` first, so its idle epoch is fenced and a submission
    from before the park bounces at the aggregator."""

    def __init__(self, n_replicas: int):
        self.max = max(1, int(n_replicas))
        self.n = self.max
        self.parked: set[int] = set()

    def set(self, n: int) -> None:
        self.n = max(1, min(self.max, int(n)))

    def activate(self, replicas: list) -> list:
        """The replicas that train this cycle: the first ``n``."""
        active = replicas[:self.n]
        for r in replicas[len(active):]:
            self.parked.add(r.replica_id)
        for r in active:
            if r.replica_id in self.parked:
                self.parked.discard(r.replica_id)
                r.respawn()
        return active


def elastic_plane(cfg: ExperimentConfig, service: ReplayService,
                  policy_server, replicas: list, target: ReplicaTarget):
    """``--autoscale 1``: the started ``elastic.Autoscaler`` over the knobs
    this run stood up (see the module docstring), its set points anchored
    at their start-up values (the service's deque depth, the server's
    batch limits, the dealer's pacing, the replica count) and bounded as
    the reference bounds them. Knobs without an actuator are still decided
    and journaled."""
    from d4pg_tpu_torch.elastic.autoscaler import Autoscaler, AutoscalerConfig

    actuators: dict = {"ingest_capacity": service.set_ingest_depth}
    if policy_server is not None:
        actuators["serving_rows"] = (
            lambda v: policy_server.set_batch_limits(max_rows=v))
        actuators["serving_window_s"] = (
            lambda v: policy_server.set_batch_limits(window_s=v))
    dealer = service.dealer
    if dealer is not None:
        actuators["dealer_deals"] = dealer.set_pacing
    if replicas:
        actuators["replicas"] = target.set
    autoscaler = Autoscaler(
        AutoscalerConfig(
            interval_s=cfg.autoscale_interval_s,
            serving_rows_init=cfg.serve_policy_max_rows,
            serving_rows_min=max(16, cfg.serve_policy_max_rows // 4),
            serving_rows_max=4 * cfg.serve_policy_max_rows,
            serving_window_cold_s=cfg.serve_policy_window_s,
            ingest_capacity_init=service.ingest_stats()["ingest_capacity"],
            ingest_capacity_min=64,
            ingest_capacity_max=1024,
            dealer_deals_init=(1 if dealer is None
                               else dealer.max_deals_per_tick),
            replicas_init=target.max,
            replicas_min=1,
            replicas_max=target.max,
        ),
        actuators=actuators).start()
    print(f"elastic: autoscaler up, knobs={sorted(actuators)}", flush=True)
    return autoscaler


def profiled(profile_dir: str, device: torch.device, fn, *args):
    """``fn(*args)`` under ``torch.profiler`` (host and, on the card,
    device events); the trace goes to ``profile_dir`` as Chrome trace
    JSON (``trace_<pid>_<ns>.json``, viewable in Perfetto or
    chrome://tracing), and the summary of the spans the profiler turned
    on beside it (``spans_<pid>_<ns>.json``)."""
    from torch.profiler import ProfilerActivity, profile

    from d4pg_tpu_torch.io.profiling import spans

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    spans.reset()
    with profile(activities=activities) as prof:
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(profile_dir, exist_ok=True)
    stamp = f"{os.getpid()}_{time.time_ns()}"
    path = os.path.join(profile_dir, f"trace_{stamp}.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(profile_dir, f"spans_{stamp}.json"), "w") as f:
        json.dump(spans.summary(), f)
    print(f"profiler trace of the first cycle: {path}", flush=True)
    return out


def main(argv=None) -> dict:
    result = train(parse_args(argv))
    print("final:", result)
    return result


if __name__ == "__main__":
    main()
