#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; the first call builds the kernels from
``d4pg_tpu_torch/ops/csrc`` into ``d4pg_tpu_torch/ops/_build``.

Phases (any failure raises and exits non-zero; nothing is caught):

  1. the card's name and power limit (nvidia-smi) and torch's CUDA version;
  2. build the CUDA kernels;
  3. projection kernel vs its plain version (max abs error <= 1e-5, rows
     sum to 1): B = 256 and ragged B = 100, A = 51 on [0, 800], and the
     driver's B = 64, A = 51 on the ``point`` preset's support (from
     ``ExperimentConfig(env="point").resolve()``), rewards past both
     ends of the support, ~30% terminal rows; A = 1,100 (a block's
     threads loop over its row); the terminal-delta case; its device
     time at B = 256 and at one row;
  4. descent kernel vs its plain version, bitwise: cap = 262,144,
     Q = 256 and Q = 40 * 256, leaves with zero runs, masses equal to
     left-subtree sums, and the all-zero tree; caps 1, 2, 32, 2^13 and
     2^16 (no level, fewer levels than one round, a ragged last round;
     2^16 is the pixel ring's tree, phase 15) at Q = 256; the
     driver's cap 1,048,576 (20 levels) at Q = 64 and its left sums, and
     the descent's time at that shape;
  5. the fused projection + cross-entropy kernels vs their plain
     versions at A = 2, 51 and 101 atoms on [0, 800] and B = 256, 100
     and 1, at 51 atoms on [-10, 0] (an inexact spacing) and B = 256
     and 1, and at the driver's B = 64, A = 51 on the ``point`` preset's
     support (inputs as phase 3): the forward's td at atol 1e-4 /
     rtol 1e-5, the backward's dq against autograd of the plain loss
     mean(w * CE(stop_grad(proj), q)) with random IS weights at
     atol 1e-5 / rtol 1e-5, no gradient for p, r or d; dq against
     -g * projection kernel / (q + 1e-10) (printed, expected 0); two
     forward calls on the same inputs give bitwise-equal td; and the
     support's atoms from torch.linspace equal on the card and on the
     CPU;
  6. device time of each kernel, its plain version and, where one torch
     call computes the same function, that call (CUDA events, warmed up);
     each kernel's bound from bytes and operations; one row (B = 1, one
     query) beside the main path's shape, and for the descent a
     zero-level launch and its dependent rounds per query;
  7. the projection autotuner: ``select_projection("auto")`` at batch 256,
     51 atoms on [0, 800], its selection and timings;
  8. the fused PER chunk on the card vs the same chunk on the CPU (plain
     versions) under both the ``pallas`` and ``pallas_ce`` arms, and
     ``multi_update_step`` at K = 3 on the card vs the CPU, at full width
     on a small ring with injected uniforms;
  9. the slice: ``FusedDeviceReplay(200_000, 376, 17)`` filled once in
     4,096-row blocks (a ``prioritized=False`` twin beside it); for each
     arm (``pallas``, ``pallas_ce``) a fresh ``init_state`` on cuda driven
     by ``FusedLoop(k=40, batch_size=256)`` and warmed up by one chunk;
     then timed windows of 2 chunks in turns (A B B A A B B A A B, five
     per arm), each with the launch counters set to 0 just
     before and read just after (each kernel of the arm must launch
     exactly K times per chunk, the other arm's kernel 0 times; the
     tree's root the sum of its leaves after each window); then each
     arm's breakdown: host queueing time, and device time by kernel
     from one profiled chunk, which must hold no stream sync (as in
     phases 15 and 16, which run the same ``slice_arm``); then one
     uniform chunk on the twin (no descent);
 10. the block ingest path on the card against the CPU, bitwise: the same
     adds, blocks staged by hand with rows pushed while one is in flight;
 11. the driver: ``d4pg_tpu_torch.train.main(argv)`` in-process on the
     ``point`` env at the default widths (hidden 256x3, 51 atoms, batch
     64, K = 40, a 1,000,000-row ring, PER; logs under ``runs/``): the
     autotuner's choice for ``auto`` at that shape first, then three
     default cycles (3 cycle rows in ``returns.csv`` and a final-eval
     row, a checkpoint at step 120, the descent and the chosen arm's
     kernels launched once per grad step), ``--resume 1`` for one more
     cycle (it goes on from step 120), then two cycles with
     ``--projection pallas`` and two with ``pallas_ce``, the second
     cycle of each profiled for device events (the device-busy share of
     one iteration of the driver's cycle loop); each arm's kernels
     launched once per grad step, the other arm's never; then two
     default cycles with ``--concurrent_eval 0`` (the learner's rate
     without the background eval beside it); per cycle the driver's
     ``grad_steps_per_sec`` (the reference's EWMA, alpha 0.9), the
     cycle's own grad-step rate (40 over its timed span), env steps/s
     and the eval return; a one-cycle Pendulum-v1 run where gymnasium
     is installed;
 12. the host-sampled path (``--fused_replay off``, ``--replay_storage
     host``): first adds through a ``ReplayService``'s commit thread into
     a non-fused device ring, with the learner thread gathering chunks
     from it meanwhile, bitwise equal to the same adds on the CPU; then,
     at the slice's shape (Humanoid width, batch 256, a 200,000-row ring
     from ``random_rows(np.random.default_rng(0), ...)``, K = 40),
     ``ChunkPipeline`` over ``PrioritizedReplayBuffer`` with its ring on
     the card (``storage='device'``) and in host RAM (``'host'``), the
     native tree backend loaded: per storage the first 3 chunks of a
     fresh buffer against a CPU run of the same pipeline (slots and IS
     weights bitwise, losses and TD errors within rtol 1e-4; ``pallas``
     on the device ring, ``pallas_ce`` on host RAM), then both arms timed
     in turns in windows of 2 chunks (the arm's kernels once per grad
     step, the descent never), and one ``einsum`` chunk launching no
     kernel; grad-steps/s, host ms per chunk for the tree walks and the
     gather, host-to-device bytes per chunk (checked against the rows,
     or the int64 slots, and the float32 IS weights) and the waits per
     chunk; the ``pallas_ce`` arm's breakdown (host queueing time, device
     time by kernel in one profiled chunk) on each storage;
 13. the driver on the host-sampled path: ``train.main`` on ``point`` at
     the default widths, two cycles with ``--fused_replay off`` (the
     non-fused device ring) and two with ``--replay_storage host``
     ``--trace_sample 1.0 --profile_dir`` (one profiler trace written,
     ``mark_grad`` once per chunk, no wire-to-grad span in process), then
     a resume for one more cycle; in each run the registry's
     ``ingest.rows_committed`` equals the rows in the buffer and the
     ``ingest`` provider's count; the arm ``auto`` chose launches once
     per grad step, the descent never; own grad-steps/s per cycle, env
     steps/s, launches per grad step;
 14. the pixel model at full width (the ``cheetah-run-pixels`` preset:
     84x84 frames stacked 3 deep as uint8 [84, 84, 9], encoder width 32,
     latent 50, hidden 256x3, 51 atoms on [0, 1000], act 6, DrQ shift of
     4 px, shared encoder, weights from seed 0): ``multi_update_step``
     for K = 3 steps of batch 32 on the card against the CPU with the
     same injected offsets, float32 losses and TD errors within rtol
     1e-4, bfloat16 losses within rtol 2e-2, the actor's encoder
     bitwise the critic's after every step;
 15. the pixel slice: ``FusedDeviceReplay(50_000, (84, 84, 9), 6)`` with
     uint8 rows and PER (filled from two 4,096-row blocks made once; the
     descent on its tree bitwise the plain version),
     ``FusedLoop(k=40, batch_size=256)`` under ``pallas_ce``, float32
     and bfloat16 arms in turns (A B B A A B) in windows of two chunks:
     per arm grad-steps/s, launches per grad step (CE forward and
     backward and the descent once, the projection never), peak device
     memory (``torch.cuda.max_memory_allocated`` over the warm-up
     chunk), the device-busy share and device time by kernel from one
     profiled chunk (which must hold no stream sync: nothing in the
     chunk waits for the card), and achieved FLOP/s against the FLOPs per
     grad step reckoned from the code (``pixel_step_flops``);
 16. the MoG critic at phase 9's Humanoid width (5 components, 32
     samples): its fused PER chunk's first 3 steps on the card against
     the CPU with injected uniforms and draws (slots equal, losses and TD
     errors within rtol 1e-4), then three timed windows over phase 9's
     ring; the descent once per grad step, the projection kernels never;
 17. the driver on the families: ``pixel-point --frame_stack 3 --augment
     shift --share_encoder 1`` for two cycles (uint8 [16, 16, 9] rows),
     ``--resume 1`` for one, one ``--compute_dtype bfloat16`` cycle and
     one ``--fused_replay off`` cycle; ``point --critic_family mog`` for
     two cycles and a resume; own grad-steps/s, env steps/s and launches
     per grad step of each;
 18. the HER recipe on the card: (a) ``GoalActorWorker`` episodes of
     ``FakeGoalEnv`` (seed 0, horizon 50) through a ``ReplayService``
     with a ``RunningMeanStd`` over a ``FusedDeviceReplay`` on the card:
     the ring's ``obs`` and ``next_obs`` rows bitwise ``normalize`` of
     the raw rows on the host in the same fold order, ``env_steps`` the
     env steps taken (relabels uncounted); (b) ``train.main`` with the
     reference's FetchReach recipe on ``fake-goal`` (``--her 1
     --normalize_obs 1 --n_steps 1 --max_steps 50 --bsize 256
     --episodes_per_cycle 4 --train_steps_per_cycle 40 --random_eps
     0.3``) for two cycles and ``--resume 1`` for one: the resumed
     normalizer's count the saved one, the arm ``auto`` picks and the
     descent once per grad step, the last publish's statistics the
     service normalizer's; own grad-steps/s, env steps/s and
     ``success_rate`` per cycle;
 19. remote actors on the card: ``train.main --env point --serve 1
     --actor_procs 2 --n_workers 0`` for three cycles, then ``fake-goal
     --her 1 --normalize_obs 1 --actor_procs 1`` for two: rows from
     every child, a pull of a grad-step publish answered to each, the
     arm's kernels and the descent once per grad step, the learner and
     no child on ``nvidia-smi``'s compute apps, and under HER the
     learner's env_steps below its rows; own grad-steps/s and rows/s
     received per cycle beside phase 11's;
 20. the sharded ingest plane and the v2 weight plane: (a) at Humanoid
     width an 8,192-row ring filled by ragged batches over four rounds
     that wrap it, a block in flight while more rows are pushed: a
     ``ReplayService(FusedDeviceReplay(..., ingest_shards=2),
     num_ingest_shards=2)`` on the card (the direct stage) bitwise the
     K = 1 service on the card and on the CPU (storage, sum and min
     trees) with the same row ledger; (b) the driver's actor published
     from the card, then after 40 grad steps: per codec (f32, bf16,
     int8) full and delta frames over a socket, the reconstruction
     bitwise a fresh full pull's, the oracles holding, bytes per frame
     and encode, decode and apply ms; (c) ``train.main --env point
     --serve 1 --ingest_shards 2 --actor_procs 2 --n_workers 0
     --trace_sample 0.05`` on fixed free ports for three cycles (the
     second profiled) beside one external ``actor_main --codec raw
     --weight_codec bf16 --trace_sample 0.1`` process with no card
     visible: ``reuseport`` true, no shed, refused admission, decode
     error, order break or orphaned ingest trace, the arm's kernels and
     the descent once per grad step, one compute app; own grad-steps/s
     per cycle and its ratio to 19a's, rows/s per shard, the learner's
     CPU per grad step, the weight plane's frames, bytes, delta hit
     rate and staleness, the trace latency block, the device-busy share
     of cycle 2;
 21. the serving plane: (a) a ``PolicyInferenceServer(device='default')``
     on the card at Humanoid width, 8 lanes of 32 rows, 200 requests
     each: responses within 1e-5 of ``act_deterministic`` on the card, no
     fallback, timeout or tear on a client; requests/s, latency p50 and
     p99, bucket occupancy, adoptions; then the same under
     ``ServingChaos(torn_response_rate=0.1)``: every tear rejected and
     counted, a fallback for each, nothing torn acted on; (b)
     ``train.main --env point --serve 1 --serve_policy 1 --n_workers 0``
     for three cycles beside two external ``actor_main --policy_port``
     processes with no card visible: each child's client served every
     request (the counts it prints on SIGINT), rows from both, the arm's
     kernels and the descent once per grad step, one compute app; own
     grad-steps/s against 19a's, rows/s, the server's stats;
 22. the sample-on-ingest dealt plane: (a) the device dealer
     (``pallas``) over a 200,000-row generation-tracked ring at Humanoid
     width, K = 40, B = 256, for 24 ticks of 4,096-row inserts with
     write-backs queued: every block bitwise the float32 twin's on the
     card, and the CPU twin's in slots, rows, generations and beta
     (weights within 1e-6 relative), one descent launch per deal, the
     card's tree leaves the CPU twin's; the descent kernel bitwise its
     plain version at Q = 10,240 over that tree and at the driver's Q =
     2,560 over 2^20 leaves, timed beside the plain version and
     ``searchsorted``, with its bound; device ms per deal and per settle;
     (b) ``train.main --env point --fused_replay off --sample_on_ingest
     1`` for two cycles under ``--sampler pallas``, ``scan`` and
     ``host``, then ``auto --learners 2``: the descent once per deal
     under ``pallas`` and never under ``scan`` or ``host``, the arm's
     kernels once per grad step of every replica, monotone versions; own
     grad-steps/s against phase 13's in the same call, deal-to-grad p50,
     the replica threads' CPU ms per grad step;
 23. crash recovery and the learner update plane: (a) a 200,000-row
     generation-tracked PER ring at Humanoid width filled through a
     ``ReplayService``, three K = 40 chunks, ``snapshot`` (its buffer-lock
     hold, and the ring's device-to-host copy beside the same bytes into
     pinned memory), the sidecar written and read, ``restore`` into a
     fresh service and buffer: rows, both trees, ``max_priority``,
     generations, head and size bitwise, the generation one on; one K =
     40 chunk from each buffer with the same uniforms: slots bitwise,
     params, TD errors and trees bitwise (else reported, rtol 1e-5); (b)
     ``train.main --env point --checkpoint_replay 1
     --checkpoint_replay_every 1`` for two cycles, then ``--resume 1``:
     the sidecar's rows, leaves and ``max_priority`` bitwise in the
     service at generation 1, the resumed cycle's own grad-steps/s beside
     phase 11's learner-only resume, a flipped byte giving a learner-only
     resume that says so; (c) host-sampled replicas at Humanoid width
     submitting through ``UpdateClient`` to an ``AggregatorServer``: N =
     1 bitwise the in-process ``Aggregator`` over 3 rounds; N = 2 under
     f32, bf16 and int8 (rounds/s, submit round trip p50 and p99, frame
     bytes); a replica fenced mid-update, its submit and its replayed
     frame fenced;
 24. the elastic plane: (a) ``train.main --env point --fused_replay off
     --sample_on_ingest 1 --sampler pallas --learners 2 --serve 1
     --serve_policy 1 --autoscale 1 --autoscale_interval_s 0.05`` for
     three cycles at the default widths, four policy lanes querying the
     driver's policy server meanwhile: the banner names the five knobs,
     a tick sensed a non-zero signal, the ledger replays
     (``replay_matches``), every knob read back from its owner equals
     the ledger's last target, the descent once per deal and the arm's
     kernels once per grad step, no lock violation, no contained crash;
     ticks, actuations, decisions per knob, the active replicas per
     cycle, own grad-steps/s per cycle beside 22b's ``auto_learners2``;
     (b) ``run_elastic_chaos(seed=0)`` at the reference's
     ``ElasticChaosConfig``, its policy server on the card: equal draw
     digests, the ledger replays, no lock violation, contained crash or
     trace orphan, every shed and reject attributed to a class, ticks
     and actuations, the elastic arm's knobs read back equal to its last
     targets; the A/B gate is printed, not asserted (a measured claim of
     the reference). Both print the first forward at each new bucket
     shape beside the second (the warm-up of the drill included);
 25. the data-parallel plane: (a) the sharded fused chunk on two local
     shards of a 200,000-row ``ShardedFusedReplay`` at the slice's width
     (``einsum``, the mesh arm): a K = 3 chunk on the card against the
     CPU (slots bitwise, losses, TD errors and roots within rtol 1e-4),
     the K = 40 chunk's bitwise prefix printed, timed windows with the
     descent twice per grad step and nothing else, a profiled chunk, and
     the descent at Q = 128 over 2^17 leaves against its plain version,
     bitwise, timed beside it and ``searchsorted``; (b)
     ``multihost_check --fused 1`` as two ranks on cuda:0 through
     ``--coordinator`` (gloo), two K = 3 chunks: equal losses and
     parameter CRCs, the descent K times a chunk on each, one process
     holding both shards
     within rtol 1e-5 (losses) and 1e-4 / 1e-6 (parameters) of the ranks,
     the host ms per grad step of the gradient average; (c)
     ``--data_parallel 2`` refused on the one card, then the ``point``
     driver as two ranks through ``--coordinator`` with per-rank
     sidecars, two cycles and a resume: equal losses, both resumed at
     step 80 with rows, the descent once per grad step of each rank;
 26. the replica axis: (a) ``MeshReplicaGroup`` at the slice's width
     (``pallas_ce``, B = 256, K = 40, one 200,000-row ring shared by the
     replicas) at N = 1, 2 and 4 replicas on cuda:0: each replica's
     stream bitwise an independent ``FusedLoop``'s, the async merge
     bitwise the host ``Aggregator``'s and the CPU's on the same stacks,
     the sync merge within rtol 1e-6, the descent and the CE kernels
     once per replica per grad step; own grad-steps/s per replica and
     for all N, merge ms per round, a merge under CUDA's sync debug mode
     (no stream sync, no blocking host copy) with its device span and host
     ms, a merge under ``io/profiling.TransferSentinel`` (0 device-to-host
     copies; it counts a non-blocking copy to pinned memory as one), a profiled
     merge (kernels, device ms), peak memory with the ring once; (b)
     ``run_mesh_ab`` at the reference's ``MeshABConfig`` and at the
     slice's width with N = 2: both arms' updates/s and
     aggregation latency p50/p95, printed, not asserted; (c)
     ``train.main --env point --learners 2 --data_parallel 2
     --fused_replay off --agg_transport auto`` (one process on the one
     card): the mesh-native banner, two cycles and a resume, versions
     monotone, both replicas' grad steps counted;
 27. the model axis: (a) ``{data 2, model 2}`` as four ranks sharing
     cuda:0 over gloo at the real pixel shape (84x84x9) with the
     reference's equivalence widths (encoder 8, hidden 16x16, 11 atoms,
     einsum), K = 2, batch 8: the gathered networks and the
     losses within rtol 5e-4 / atol 1e-6 of a single-device update on
     the card from the same state and chunk, the ranks bitwise, the
     encoders tied, the host ms per grad step of the collectives, then a
     sharded fused chunk per rank (the descent once per grad step); (b)
     a ``{data 1, model 2}`` pair at phase 15's width and batch held the
     same way against the single-device update there (losses, ranks
     bitwise, encoders tied; within the reference's bars of the same
     arithmetic in one process, each convolution as two halves, but for
     a share of 1e-4; against the unsplit update, the share of
     parameters outside the reference's bars under a bar that the sound
     controls stay under and a TF32 control exceeds, and none outside
     with Adam's epsilon at 1e-3 on both sides), then timed beside phase
     15's float32 arm; both sides of every comparison on cuDNN's
     deterministic algorithms;
 28. the fleet plane, the lock plane in record mode for each run and
     the launch counters set to 0 before it (no kernel launches): (a)
     ``run_sweep`` at N = 64 and 256 thread lanes of Humanoid rows
     (376/17) with the default chaos, 5 s each, then ``shard_sweep`` K =
     1 and 2 at N = 256 and 60 rows/s a lane, 3 s each: rows/s, send
     p50/p99, drops by cause, evictions and readmissions, lock waits per
     tier, no deadlock and no violation; (b) ``run_recovery`` at N = 64, K = 2
     with seeded service kills: the bitwise ``recovery_probe``, MTTR;
     (c) ``run_sampler``'s host, dealer and device arms (the device
     arm's ring and dealer on cuda:0, ``arm='scan'``) and a dealer chaos
     row: no deadlock, violation, trace orphan or dealt dead ticket, no
     buffer-lock acquisition on the dealt consume paths; (d)
     ``run_serving`` with its server on the card and one server kill;
     (e) ``run_weights`` with 64 pullers over a depth-2 relay tree; (f)
     the harness's actor mode with four ``actor_main`` processes
     (``point``). Every rate is a host rate of the card's machine;
 29. the runtime sentinels (``io/profiling``: ``RecompileSentinel``,
     ``TransferSentinel``, ``ReshardSentinel``) on the slice's paths at
     its width, each bracket holding only what the reference's brackets
     hold, no rate timed inside one: (a) the fused chunk over a
     200,000-row ring under ``pallas`` and ``pallas_ce`` after warm-up
     (0 compilations, no host/device crossing, 0 reshards, no sync under
     ``guard="disallow"``), with the host and wall ms per grad step of a
     bracketed chunk against a bare one; (b) the ingest overlap through a
     ``ReplayService`` (host-to-device bytes = rows staged x row bytes,
     one copy per field per block, no device-to-host copy); (c) the
     device dealer at phase 22a's shape (host-to-device bytes at most
     the staged frames and the K x B uniforms, no sampled row, 0
     reshards in the deal); (d) the sharded chunk at 25a's shape (0
     reshards); the kernels of each path launched inside its bracket;
 30. a ``kernels`` JSON line (each kernel's launches on every path that
     runs it; the descent's time at the dealt and the sharded shapes),
     then the result line.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent

# the slice's shape: Humanoid-v4 at the repo's north-star learner config
OBS, ACT, HIDDEN, ATOMS = 376, 17, (256, 256, 256), 51
V_MIN, V_MAX = 0.0, 800.0
BATCH, CAPACITY, K, FILL_BLOCK = 256, 200_000, 40, 4096
TIMED_CHUNKS, WINDOW_CHUNKS = 10, 2  # per arm, per timed window
CAP = 262_144  # next_pow2(CAPACITY): the sum tree's leaf count
LEVELS = 18  # log2(CAP): levels per descent
# the driver's defaults: a 1,000,000-row ring (2^20 leaves), batch 64, K 40
DRIVER_CAP, DRIVER_LEVELS, DRIVER_BATCH = 1 << 20, 20, 64
# phase 23c: seconds of N = 2 rounds per update codec (a p99 over ~100+)
UPDATE_WINDOW_S = 30.0

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the port's CUDA kernels by their names in the profiler's device events
PORTED_KERNELS = ("projection_kernel", "ce_forward_kernel",
                  "ce_backward_kernel", "descent_kernel")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


class _Threads:
    """A phase's worker threads, run so that an exception in one reaches
    the phase instead of vanishing into ``threading.excepthook``: each
    thread keeps its exception, and ``join`` re-raises the first one once
    every thread has been joined. ``on_error`` runs in the failing thread
    (a barrier's ``abort``, so that the other lanes stop waiting)."""

    def __init__(self, on_error=None):
        self.threads: list[threading.Thread] = []
        self.errors: list[BaseException] = []
        self._on_error = on_error

    def start(self, target, *args, daemon: bool = False) -> None:
        t = threading.Thread(target=self._run, args=(target, args),
                             daemon=daemon)
        self.threads.append(t)
        t.start()

    def _run(self, target, args) -> None:
        try:
            target(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised by join
            self.errors += [e]
            if self._on_error is not None:
                self._on_error()

    def join(self, timeout: float | None = None, reraise: bool = True) -> None:
        for t in self.threads:
            t.join(timeout)
        if reraise:
            self.reraise()

    def reraise(self) -> None:
        if self.errors:
            raise self.errors[0]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(fn, calls: int, windows: int = 10,
              warmup: int = 5) -> tuple[float, float]:
    """(device ms per call, host enqueue ms per call). Each window queues
    ``calls`` calls behind a sleep kernel, so the CUDA events around them
    bracket device work alone; the median over windows is kept. ``calls``
    keeps a window's launches well inside the device's launch queue (once
    it fills, the host waits for the device). A window whose start event
    was no longer pending when the last call was queued (the host stalled
    past the sleep) is discarded and queued again behind a sleep twice as
    long; after three such windows in a row the measurement fails."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_s = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    sleep_cycles = int((4 * enqueue_s * calls + 2e-3) * 2e9)
    times, stalls = [], 0
    while len(times) < windows:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles << stalls)
        start.record()
        for _ in range(calls):
            fn()
        pending = not start.query()
        end.record()
        end.synchronize()
        if not pending:
            stalls += 1
            check(stalls < 3, "timing window: device idle while queueing, "
                  "three windows in a row")
            continue
        stalls = 0
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times)), enqueue_s * 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def driver_shape() -> tuple[float, float, int, int]:
    """(v_min, v_max, atoms, batch) of the driver's default run on the
    ``point`` env, from its config as the driver resolves it."""
    from d4pg_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig(env="point").resolve()
    return cfg.v_min, cfg.v_max, cfg.n_atoms, cfg.batch_size


def projection_inputs(gen, batch, atoms, v_min, v_max, dev):
    p = torch.rand(batch, atoms, generator=gen, device=dev)
    p = (p / p.sum(-1, keepdim=True)).contiguous()
    span = v_max - v_min
    r = (v_min - 0.2 * span) + 1.4 * span * torch.rand(
        batch, generator=gen, device=dev)
    done = torch.rand(batch, generator=gen, device=dev) < 0.3
    d = torch.where(done, 0.0, 0.99 ** 3).to(torch.float32)
    return p, r, d


def phase_projection(dev) -> dict:
    from d4pg_tpu_torch.core.distribution import CategoricalSupport
    from d4pg_tpu_torch.ops import projection as proj

    gen = torch.Generator(device=dev).manual_seed(1)
    sup = CategoricalSupport(V_MIN, V_MAX, ATOMS)
    worst = 0.0
    v_lo, v_hi, d_atoms, d_batch = driver_shape()
    for v_min, v_max, atoms, batch in ((V_MIN, V_MAX, ATOMS, BATCH),
                                       (V_MIN, V_MAX, ATOMS, 100),
                                       (v_lo, v_hi, d_atoms, d_batch)):
        case = f"[{v_min:g}, {v_max:g}] A={atoms} B={batch}"
        case_sup = CategoricalSupport(v_min, v_max, atoms)
        args = projection_inputs(gen, batch, atoms, v_min, v_max, dev)
        got = proj.projection(case_sup, *args)
        want = proj.projection_plain(case_sup, *args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rows = (got.sum(-1) - 1.0).abs().max().item()
        print(f"projection {case}: max abs err {err:.3e}, "
              f"max |row sum - 1| {rows:.3e}")
        check(err <= 1e-5 and rows <= 1e-5, f"projection {case}")
        worst = max(worst, err)
    # past 1,024 atoms a block's threads loop over its row
    sup_wide = CategoricalSupport(V_MIN, V_MAX, 1100)
    args = projection_inputs(gen, 4, 1100, V_MIN, V_MAX, dev)
    err = (proj.projection(sup_wide, *args)
           - proj.projection_plain(sup_wide, *args)).abs().max().item()
    print(f"projection A=1100 B=4: max abs err {err:.3e}")
    check(err <= 1e-5, "projection A=1100")
    # terminal rows collapse to a delta at clip(r)
    sup11 = CategoricalSupport(0.0, 10.0, 11)
    p = torch.rand(8, 11, generator=gen, device=dev)
    p = p / p.sum(-1, keepdim=True)
    got = proj.projection(sup11, p, torch.full((8,), 5.0, device=dev),
                          torch.zeros(8, device=dev))
    want = torch.zeros(8, 11, device=dev)
    want[:, 5] = 1.0
    check((got - want).abs().max().item() <= 1e-6, "projection delta")

    args = projection_inputs(gen, BATCH, ATOMS, V_MIN, V_MAX, dev)
    ms, enq = device_ms(lambda: proj.projection(sup, *args), calls=100)
    # one row: the launch and one row's critical path
    one_ms, _ = device_ms(
        lambda: proj.projection(sup, *(t[:1] for t in args)), calls=100)
    # ~12 launches per call of the plain version
    plain_ms, _ = device_ms(lambda: proj.projection_plain(sup, *args),
                            calls=20)
    n_bytes = 4 * (2 * BATCH * ATOMS + 2 * BATCH)
    # what the function needs, not what the gather-form kernel does: per
    # source atom the Bellman map and clip (3), the bin position (2), the
    # floor/ceil split (3) and two multiply-adds into its two bins (2)
    n_ops = 10 * BATCH * ATOMS
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"name": "projection", "route": "cuda",
            "source": "d4pg_tpu_torch/ops/csrc/projection.cu",
            "replaces": "d4pg_tpu/ops/projection.py:87",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "one_row_ms": one_ms, "enqueue_ms": enq}


def _tree_with_zero_runs(dev, gen, cap=CAP):
    from d4pg_tpu_torch.replay import device_per as dper

    leaves = torch.rand(cap, generator=gen, device=dev)
    # zero runs: blocks of up to 64 leaves zeroed at random, plus single
    # zeros
    run = min(64, cap)
    blocks = torch.rand(cap // run, generator=gen, device=dev) < 0.2
    leaves = torch.where(blocks.repeat_interleave(run), 0.0, leaves)
    leaves = torch.where(torch.rand(cap, generator=gen, device=dev) < 0.1,
                         0.0, leaves)
    trees = dper.set_leaves(dper.init(cap, dev),
                            torch.arange(cap, device=dev), leaves)
    return trees.sum_tree, leaves


def _left_sum_masses(tree):
    """Masses equal to a left-subtree sum: along the all-left path
    (prefix 0) the mass tree[2^k] ties node 2^(k-1) exactly; the root's
    left sum plus each node on the path of its right child adds more."""
    levels = int(math.log2(tree.shape[0] // 2))
    firsts = [tree[2 ** k] for k in range(1, levels + 1)]
    rights = [tree[2] + tree[3 * 2 ** k] for k in range(1, levels)]
    return torch.stack([tree[1] * 0, *firsts, *rights]).contiguous()


def phase_descent(dev) -> dict:
    from d4pg_tpu_torch.ops import sampler_descent as desc

    gen = torch.Generator(device=dev).manual_seed(2)
    tree, leaves = _tree_with_zero_runs(dev, gen)
    total = tree[1]
    cases = {
        "Q=256": torch.rand(BATCH, generator=gen, device=dev) * total,
        "Q=40*256": torch.rand(K * BATCH, generator=gen, device=dev) * total,
        "left sums": _left_sum_masses(tree),
    }
    cases = [(name, tree, mass) for name, mass in cases.items()]
    cases.append(("all-zero tree", torch.zeros(2 * CAP, device=dev),
                  torch.zeros(5, device=dev)))
    # small capacities: no level (cap 1), fewer levels than a round
    # resolves (2, 32), and level counts a round does not divide (2^13;
    # 2^16, the pixel ring's next_pow2(50,000) leaves: rounds 6 + 6 + 4)
    for cap in (1, 2, 32, 2 ** 13, PIXEL_CAP):
        t, _ = _tree_with_zero_runs(dev, gen, cap)
        mass = torch.cat([torch.rand(BATCH, generator=gen, device=dev) * t[1],
                          _left_sum_masses(t), t[1:2]]).contiguous()
        cases.append((f"cap={cap}", t, mass))
    # the driver's tree: next_pow2(1,000,000) leaves (20 levels), Q = 64
    # queries per grad step, beside left sums and the total
    tree20, _ = _tree_with_zero_runs(dev, gen, DRIVER_CAP)
    mass20 = torch.rand(DRIVER_BATCH, generator=gen, device=dev) * tree20[1]
    cases.append((f"cap={DRIVER_CAP} Q={DRIVER_BATCH}", tree20, mass20))
    cases.append((f"cap={DRIVER_CAP} left sums", tree20,
                  torch.cat([_left_sum_masses(tree20),
                             tree20[1:2]]).contiguous()))
    worst = 0
    for name, t, mass in cases:
        got, want = desc.descend(t, mass), desc.descend_plain(t, mass)
        torch.cuda.synchronize()
        worst = max(worst, (got.long() - want.long()).abs().max().item())
        check(torch.equal(got, want), f"descent {name} bitwise")
        print(f"descent {name}: bitwise equal ({mass.numel()} queries)")

    mass = cases[0][2]
    ms, enq = device_ms(lambda: desc.descend(tree, mass), calls=100)
    # ~130 launches per call of the plain version (18 levels)
    plain_ms, _ = device_ms(lambda: desc.descend_plain(tree, mass), calls=2)
    cumsum = torch.cumsum(leaves, 0)
    library_ms, _ = device_ms(
        lambda: torch.searchsorted(cumsum, mass, right=True), calls=100)
    # bytes this run's queries need: every distinct tree node read on the
    # way down, the masses in and the slots out
    node = torch.ones(BATCH, dtype=torch.int64, device=dev)
    p, seen = mass.clone(), []
    for _ in range(LEVELS):
        left = node << 1
        seen.append(left)
        go = p >= tree[left]
        p = torch.where(go, p - tree[left], p)
        node = torch.where(go, left | 1, left)
    nodes = torch.unique(torch.cat(seen)).numel()
    n_bytes = 4 * nodes + 4 * BATCH + 4 * BATCH
    n_ops = 2 * BATCH * LEVELS  # compare + subtract per level
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    # the dependent chain: time a one-query descent of the warm tree (a
    # fresh mass each call) and a zero-level launch (a 2-node tree); the
    # difference is one query's chain, the launch cost cancelled: the
    # launch's first global access, then `rounds` dependent round trips
    # to L2 (the whole 2 MB tree is read into the 50 MB L2 first).
    rounds = desc.rounds(CAP)
    one = torch.rand(1000, 1, generator=gen, device=dev) * total
    tree.sum()
    pick = itertools.count()
    one_ms, _ = device_ms(
        lambda: desc.descend(tree, one[next(pick) % 1000]), calls=100)
    stub = torch.zeros(2, device=dev)
    stub_ms, _ = device_ms(lambda: desc.descend(stub, one[0]), calls=100)
    chain_ms = one_ms - stub_ms
    print(f"descent chain: one query {one_ms * 1e3:.3f} us, zero levels "
          f"{stub_ms * 1e3:.3f} us -> {chain_ms * 1e3:.3f} us for "
          f"{rounds} dependent rounds and the launch's first global access")
    # the driver's shape: 20 levels, Q = 64
    driver_ms, _ = device_ms(lambda: desc.descend(tree20, mass20), calls=100)
    node = torch.ones(DRIVER_BATCH, dtype=torch.int64, device=dev)
    p, seen = mass20.clone(), []
    for _ in range(DRIVER_LEVELS):
        left = node << 1
        seen.append(left)
        go = p >= tree20[left]
        p = torch.where(go, p - tree20[left], p)
        node = torch.where(go, left | 1, left)
    driver_nodes = torch.unique(torch.cat(seen)).numel()
    driver_bound, _ = bound_ms(4 * driver_nodes + 8 * DRIVER_BATCH,
                               2 * DRIVER_BATCH * DRIVER_LEVELS)
    print(f"descent at the driver's shape (cap {DRIVER_CAP}, Q "
          f"{DRIVER_BATCH}, {desc.rounds(DRIVER_CAP)} rounds): "
          f"{driver_ms * 1e3:.3f} us, bound {driver_bound * 1e3:.4f} us")
    return {"name": "descent", "route": "cuda",
            "source": "d4pg_tpu_torch/ops/csrc/sampler_descent.cu",
            "replaces": "d4pg_tpu/ops/sampler_descent.py:96",
            "max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "one_row_ms": one_ms, "zero_level_ms": stub_ms,
            "rounds": rounds, "chain_ms": chain_ms,
            "driver_ms": driver_ms, "driver_bound_ms": driver_bound,
            "driver_rounds": desc.rounds(DRIVER_CAP),
            "enqueue_ms": enq, "distinct_nodes": nodes}


def phase_projection_ce(dev) -> list[dict]:
    from d4pg_tpu_torch.core.distribution import CategoricalSupport
    from d4pg_tpu_torch.ops import projection as proj
    from d4pg_tpu_torch.ops import projection_ce as pce

    gen = torch.Generator(device=dev).manual_seed(4)

    def pred(batch, atoms=ATOMS):
        q = torch.rand(batch, atoms, generator=gen, device=dev)
        return (q / q.sum(-1, keepdim=True)).contiguous()

    # the slice's support at three atom counts, and the reference tests'
    # [-10, 0] at 51 atoms, whose spacing 0.2 no float32 holds exactly
    cases = [(V_MIN, V_MAX, atoms, batch) for atoms, batch in
             itertools.product((2, ATOMS, 101), (BATCH, 100, 1))]
    cases += [(-10.0, 0.0, ATOMS, batch) for batch in (BATCH, 1)]
    # the driver's shape on the point preset's support
    cases.append(driver_shape())
    worst_fwd = worst_bwd = worst_proj = 0.0
    for v_min, v_max, atoms, batch in cases:
        sup = CategoricalSupport(v_min, v_max, atoms)
        case = f"[{v_min:g}, {v_max:g}] A={atoms} B={batch}"
        # the kernels compute the support's atoms as torch.linspace
        # rounds them on the CPU (tests/test_torch_projection.py); the
        # plain version here takes them from torch.linspace on the card
        atoms_cpu = sup.atoms()
        check(torch.equal(sup.atoms(dev).cpu(), atoms_cpu),
              f"support atoms on the card vs on the CPU {case}")
        naive = torch.tensor(v_min) + torch.tensor(sup.delta) * torch.arange(
            atoms, dtype=torch.float32)
        off = int((naive != atoms_cpu).sum())
        p, r, d = projection_inputs(gen, batch, atoms, v_min, v_max, dev)
        q = pred(batch, atoms)
        got = pce.projection_ce(sup, p, r, d, q)
        want = pce.projection_ce_plain(sup, p, r, d, q)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(((got - want).abs() <= 1e-4 + 1e-5 * want.abs()).all()),
              f"projection_ce forward {case}")
        worst_fwd = max(worst_fwd, err)
        # td's row sums run in a fixed order: the same bits every call
        check(torch.equal(pce.forward_kernel(sup, p, r, d, q), got),
              f"projection_ce forward bitwise equal across calls {case}")

        w = torch.rand(batch, generator=gen, device=dev)
        leaves = [t.clone().requires_grad_(True) for t in (p, r, d, q)]
        torch.mean(w * pce.projection_ce(sup, *leaves)).backward()
        q_ref = q.clone().requires_grad_(True)
        torch.mean(w * pce.projection_ce_plain(sup, p, r, d, q_ref)).backward()
        torch.cuda.synchronize()
        dq, dq_ref = leaves[3].grad, q_ref.grad
        err_bwd = (dq - dq_ref).abs().max().item()
        check(bool(((dq - dq_ref).abs() <= 1e-5 + 1e-5 * dq_ref.abs()).all()),
              f"projection_ce backward {case}")
        check(all(t.grad is None or not t.grad.any() for t in leaves[:3]),
              f"projection_ce: no gradient for p, r, d at {case}")
        worst_bwd = max(worst_bwd, err_bwd)
        # dq from the projection kernel's proj and torch elementwise ops:
        # both kernels sum proj_j by projection_common.cuh's routine
        g = w / batch
        via_proj = -g[:, None] * proj.projection(sup, p, r, d) / (q + 1e-10)
        err_proj = (pce.backward_kernel(sup, p, r, d, q, g) - via_proj
                    ).abs().max().item()
        worst_proj = max(worst_proj, err_proj)
        print(f"projection_ce {case}: forward max abs err {err:.3e}, "
              f"backward max abs err {err_bwd:.3e}, backward vs "
              f"-g * projection kernel / (q + 1e-10) {err_proj:.3e}; "
              f"forward bitwise equal across calls; "
              f"{off} support atoms off v_min + delta * i")

    sup = CategoricalSupport(V_MIN, V_MAX, ATOMS)
    p, r, d = projection_inputs(gen, BATCH, ATOMS, V_MIN, V_MAX, dev)
    q = pred(BATCH)
    g = torch.rand(BATCH, generator=gen, device=dev) / BATCH
    fwd_ms, fwd_enq = device_ms(
        lambda: pce.forward_kernel(sup, p, r, d, q), calls=100)
    bwd_ms, bwd_enq = device_ms(
        lambda: pce.backward_kernel(sup, p, r, d, q, g), calls=100)
    # one row: the launch and one row's critical path
    fwd_one_ms, _ = device_ms(
        lambda: pce.forward_kernel(sup, p[:1], r[:1], d[:1], q[:1]),
        calls=100)
    bwd_one_ms, _ = device_ms(
        lambda: pce.backward_kernel(sup, p[:1], r[:1], d[:1], q[:1], g[:1]),
        calls=100)
    # the plain versions: the forward as the CPU path runs it, and dq as
    # autograd of the plain loss produces it (forward, then backward)
    fwd_plain_ms, _ = device_ms(
        lambda: pce.projection_ce_plain(sup, p, r, d, q), calls=20)
    q_leaf = q.clone().requires_grad_(True)
    bwd_plain_ms, _ = device_ms(lambda: torch.autograd.grad(
        pce.projection_ce_plain(sup, p, r, d, q_leaf), q_leaf, g), calls=10)
    # per atom the projection needs ~10 operations (phase 3's count) and
    # the loss ~3 more: log(q + eps), the product and the row sum forward;
    # q + eps, the division and the product by -g backward
    n_ops = 13 * BATCH * ATOMS
    fwd_bytes = 4 * (2 * BATCH * ATOMS + 2 * BATCH + BATCH)
    bwd_bytes = 4 * (2 * BATCH * ATOMS + 3 * BATCH + BATCH * ATOMS)
    no_library = ("no single torch call computes the projection fused "
                  "with the cross-entropy")
    out = []
    for name, line, worst, ms, one_ms, enq, plain_ms, n_bytes in (
            ("projection_ce_fwd", 118, worst_fwd, fwd_ms, fwd_one_ms,
             fwd_enq, fwd_plain_ms, fwd_bytes),
            ("projection_ce_bwd", 144, worst_bwd, bwd_ms, bwd_one_ms,
             bwd_enq, bwd_plain_ms, bwd_bytes)):
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        out.append({"name": name, "route": "cuda",
                    "source": "d4pg_tpu_torch/ops/csrc/projection_ce.cu",
                    "replaces": f"d4pg_tpu/ops/projection_ce.py:{line}",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "library_note": no_library, "one_row_ms": one_ms,
                    "enqueue_ms": enq})
    out[1]["vs_projection_kernel_max_abs"] = worst_proj
    return out


def phase_autotune(dev) -> None:
    from d4pg_tpu_torch.ops.autotune import select_projection

    r = select_projection("auto", batch_size=BATCH, v_min=V_MIN,
                          v_max=V_MAX, n_atoms=ATOMS, device=dev)
    check(r.selected in ("einsum", "pallas", "pallas_ce"),
          "autotuner selects a candidate")
    check(all(isinstance(t, float) for t in r.timings_ms.values()),
          "autotuner timed every candidate")
    print(f"autotune: selected {r.selected!r}, timings_ms {r.timings_ms}")
    # what the timed race is made of: each loss core's device time per
    # value-and-grad step and the host's time to queue it
    from d4pg_tpu_torch.core.distribution import CategoricalSupport
    from d4pg_tpu_torch.ops.autotune import _loss_fn

    gen = torch.Generator(device=dev).manual_seed(5)
    p, r_, d = projection_inputs(gen, BATCH, ATOMS, V_MIN, V_MAX, dev)
    pred = p.clone().requires_grad_(True)
    sup = CategoricalSupport(V_MIN, V_MAX, ATOMS)
    for arm in ("pallas", "pallas_ce"):
        loss = _loss_fn(arm, sup)
        ms, enq = device_ms(lambda: torch.autograd.grad(
            loss(pred, p, r_, d), pred), calls=10)
        print(f"autotune loss core {arm}: device {ms * 1e3:.2f} us, host "
              f"enqueue {enq * 1e3:.2f} us per value-and-grad step")


def random_rows(rng, n):
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    return TransitionBatch(
        obs=rng.standard_normal((n, OBS)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, OBS)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32),
    )


def config(projection: str):
    from d4pg_tpu_torch.learner.state import D4PGConfig

    return D4PGConfig(obs_dim=OBS, act_dim=ACT, v_min=V_MIN, v_max=V_MAX,
                      n_atoms=ATOMS, hidden=HIDDEN, projection=projection)


def _rel_err(got, want) -> float:
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def phase_reference(dev) -> None:
    """The fused chunk with the kernels on the card against the same chunk
    with the plain versions on the CPU, under each projection arm: same
    weights, ring and uniforms. Slots must agree exactly; losses and TD
    errors within rtol 1e-4 (float32 products summed in another order,
    over 3 Adam steps). Then ``multi_update_step`` at K = 3 on stacked
    batches with IS weights, card against CPU, at the same bar."""
    from d4pg_tpu_torch.learner.fused import make_fused_chunk
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.learner.update import multi_update_step
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    k, cap = 3, 2048
    rng = np.random.default_rng(3)
    rows = random_rows(rng, cap)
    u = torch.from_numpy(rng.random((k, BATCH)).astype(np.float32))
    for arm in ("pallas", "pallas_ce"):
        out = {}
        for where in ("cpu", dev):
            buf = FusedDeviceReplay(cap, OBS, ACT, device=where,
                                    block_rows=512)
            buf.add(rows)
            buf.drain()
            state = init_state(config(arm), seed=0, device=where)
            fn = make_fused_chunk(config(arm), k=k, batch_size=BATCH)
            trees, m = fn(state, buf.trees, buf.storage, buf.size,
                          u=u.to(where))
            out[str(where)] = {n: v.cpu() for n, v in m.items()}
            out[str(where)]["root"] = trees.sum_tree[1].cpu()
        cpu, gpu = out["cpu"], out[str(dev)]
        check(torch.equal(cpu["idx"], gpu["idx"]),
              f"chunk slots, card vs CPU ({arm})")
        for name in ("critic_loss", "actor_loss", "td_error", "root"):
            err = _rel_err(gpu[name], cpu[name])
            print(f"chunk ({arm}) card vs CPU {name}: max rel err {err:.3e}")
            check(err <= 1e-4, f"chunk ({arm}) {name} card vs CPU")

    stacked = [random_rows(rng, BATCH) for _ in range(k)]
    stacked = TransitionBatch(*[np.stack(f) for f in zip(*stacked)])
    w = (0.5 + rng.random((k, BATCH))).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        state = init_state(config("pallas_ce"), seed=0, device=where)
        m = multi_update_step(
            config("pallas_ce"), state,
            TransitionBatch(*[torch.from_numpy(f).to(where)
                              for f in stacked]),
            torch.from_numpy(w).to(where))
        out[str(where)] = {n: v.cpu() for n, v in m.items()}
    for name in ("critic_loss", "actor_loss", "td_error"):
        check(out["cpu"][name].shape[0] == k, f"multi_update_step {name}")
        err = _rel_err(out[str(dev)][name], out["cpu"][name])
        print(f"multi_update_step K={k} card vs CPU {name}: max rel err "
              f"{err:.3e}")
        check(err <= 1e-4, f"multi_update_step {name} card vs CPU")


def launch_counts() -> dict:
    from d4pg_tpu_torch.ops.projection import projection
    from d4pg_tpu_torch.ops.projection_ce import projection_ce
    from d4pg_tpu_torch.ops.sampler_descent import descend

    return {"projection": projection.launches,
            "projection_ce_fwd": projection_ce.fwd_launches,
            "projection_ce_bwd": projection_ce.bwd_launches,
            "descent": descend.launches}


def zero_counts() -> None:
    from d4pg_tpu_torch.ops.projection import projection
    from d4pg_tpu_torch.ops.projection_ce import projection_ce
    from d4pg_tpu_torch.ops.sampler_descent import descend

    projection.launches = descend.launches = 0
    projection_ce.fwd_launches = projection_ce.bwd_launches = 0


def fill_buffers(dev):
    """The slice's PER ring and its uniform twin, filled once with the
    same rows."""
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    t0 = time.perf_counter()
    per = FusedDeviceReplay(CAPACITY, OBS, ACT, alpha=0.6, device=dev)
    uniform = FusedDeviceReplay(CAPACITY, OBS, ACT, prioritized=False,
                                device=dev)
    rng = np.random.default_rng(0)
    for start in range(0, CAPACITY, FILL_BLOCK):
        rows = random_rows(rng, min(FILL_BLOCK, CAPACITY - start))
        for buf in (per, uniform):
            buf.add(rows)
            buf.drain()
    torch.cuda.synchronize()
    print(f"rings filled: {per.size} rows each in "
          f"{time.perf_counter() - t0:.2f} s")
    check(per.size == CAPACITY, f"ring full: {per.size} rows")
    check(uniform.trees is None and uniform.size == per.size,
          "uniform twin: no trees, same rows")
    leaves = per.trees.sum_tree[CAP:].double().sum().item()
    check(abs(per.trees.sum_tree[1].item() - leaves) <= 1e-4 * leaves,
          "tree root == sum of leaves after fill")
    return per, uniform


def breakdown(run_chunks, wall_ms: float) -> dict:
    """Where a grad step's time goes: the host's time to queue three
    chunks, and the device's kernel time in one profiled chunk from the
    profiler's device events (the ten longest kernels, then the port's
    own), both against the unprofiled wall clock."""
    t0 = time.perf_counter()
    run_chunks(3)
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / (3 * K)
    torch.cuda.synchronize()
    print(f"per grad step: wall {wall_ms:.3f} ms, host enqueue "
          f"{enqueue_ms:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_chunks(1)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if not e.is_user_annotation]
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in on_device)
    if not device_us:
        print("per grad step: device time not measured (the profiler "
              "recorded no device events)")
    else:
        print(f"per grad step (profiled chunk): device busy "
              f"{device_us / 1e3 / K:.3f} ms (share of unprofiled wall "
              f"{device_us / 1e3 / K / wall_ms:.3f}), "
              f"{sum(e.count for e in on_device) / K:.1f} kernels")
        ranked = sorted(on_device, key=lambda e: -e.self_device_time_total)
        ported = [e for e in ranked if any(
            k in e.key for k in PORTED_KERNELS)]
        for e in ranked[:10] + [e for e in ported if e not in ranked[:10]]:
            print(f"  device {e.self_device_time_total / K:9.2f} us/step "
                  f"{e.count / K:7.2f} launches/step  {e.key[:80]}")
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  host {e.self_cpu_time_total / K:9.2f} us/step "
              f"{e.count / K:7.2f} calls/step  {e.key[:80]}")
    # the host waiting on a stream inside the chunk (the closing
    # torch.cuda.synchronize() is a device-wide sync, not counted here)
    syncs = sum(e.count for e in on_host if e.key == "cudaStreamSynchronize")
    print(f"per grad step: {syncs / K:.2f} stream syncs")
    return {"enqueue_ms": enqueue_ms, "stream_syncs": syncs,
            "device_busy_ms": device_us / 1e3 / K if device_us else None}


# the kernels each arm launches once per grad step, the rest never
# (``einsum`` projects with the plain version); the fused path adds the
# descent, the host-sampled path walks host trees instead
ARM_KERNELS = {"einsum": (),
               "pallas": ("projection",),
               "pallas_ce": ("projection_ce_fwd", "projection_ce_bwd")}


def fused_kernels(arm: str) -> tuple[str, ...]:
    return ARM_KERNELS[arm] + ("descent",)


def slice_arm(dev, buf, cfg, tag: str, kernels: tuple[str, ...],
              timed_chunks: int, flops_per_step: float | None = None,
              peak_ops: float | None = None):
    """``FusedLoop(k=40, batch_size=256)`` over ``buf`` under ``cfg`` from a
    fresh state, warmed up by one chunk (peak device memory measured over
    it). Returns ``(timed, finish)``: ``timed(chunks)`` runs one timed
    window with the launch counters set to 0 just before and read just
    after, and checks it (``kernels`` launch once per grad step, the
    others never; finite metrics; slots in range; the tree's root the sum
    of its leaves; under ``share_encoder`` the encoders tied);
    ``finish()`` checks that ``timed_chunks`` chunks were timed, sums the
    windows, prints the breakdown (a chunk that syncs the host fails)
    and returns the arm's result, with the achieved FLOP/s against
    ``peak_ops`` where ``flops_per_step`` is given."""
    from d4pg_tpu_torch.learner.loop import FusedLoop
    from d4pg_tpu_torch.learner.state import init_state

    state = init_state(cfg, seed=0, device=dev)
    loop = FusedLoop(cfg, buf, k=K, batch_size=BATCH,
                     generator=torch.Generator(device=dev).manual_seed(0))

    def run(chunks):
        zero_counts()
        metrics = loop.run(state, chunks * K)
        torch.cuda.synchronize()
        return metrics, launch_counts()

    def expected(chunks):
        return {name: K * chunks if name in kernels else 0
                for name in launch_counts()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, warm = run(1)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[{tag}] warm-up chunk: {time.perf_counter() - t0:.3f} s, peak "
          f"device memory {peak / 1e9:.3f} GB, launches {warm}")
    check(warm == expected(1), f"[{tag}] warm-up launches: {warm}")
    windows = []

    def timed(chunks):
        t0 = time.perf_counter()
        metrics, launches = run(chunks)
        dt = time.perf_counter() - t0
        check(launches == expected(chunks),
              f"[{tag}] launches == K per chunk: {launches}")
        for name in ("critic_loss", "actor_loss", "td_error"):
            check(bool(torch.isfinite(metrics[name]).all()),
                  f"[{tag}] finite {name}")
        check(tuple(metrics["td_error"].shape) == (K, BATCH),
              f"[{tag}] td_error shape")
        idx = metrics["idx"]
        check(bool(((idx >= 0) & (idx < buf.size)).all()),
              f"[{tag}] slots in range")
        tree = buf.trees.sum_tree
        leaves = tree[tree.shape[0] // 2:].double().sum().item()
        check(abs(tree[1].item() - leaves) <= 1e-4 * leaves,
              f"[{tag}] tree root == sum of leaves after chunks")
        if cfg.share_encoder:
            check(_encoders_tied(state), f"[{tag}] encoders tied")
        windows.append((chunks * K, dt, launches, metrics))

    def finish():
        steps = sum(w[0] for w in windows)
        dt = sum(w[1] for w in windows)
        launches = {name: sum(w[2][name] for w in windows)
                    for name in windows[0][2]}
        check(loop.steps_done == K + steps, f"[{tag}] loop step count")
        check(steps == K * timed_chunks, f"[{tag}] timed steps")
        rates = [w[0] / w[1] for w in windows]
        rate = steps / dt
        print(f"[{tag}] windows: {', '.join(f'{x:.2f}' for x in rates)} "
              f"grad-steps/s, median {np.median(rates):.2f}; {steps} grad "
              f"steps in {dt:.3f} s = {rate:.2f} grad-steps/s (K={K}, "
              f"B={BATCH}, step {state.step}, critic_loss "
              f"{windows[-1][3]['critic_loss'][-1].item():.4f})")
        print(f"[{tag}] launches per grad step "
              f"{ {n: c / steps for n, c in launches.items()} }")
        parts = breakdown(lambda chunks: loop.run(state, chunks * K),
                          1e3 * dt / steps)
        check(parts["stream_syncs"] == 0,
              f"[{tag}] the chunk synced the host "
              f"{parts['stream_syncs']} times")
        busy = parts["device_busy_ms"]
        share = None if busy is None else busy / (1e3 * dt / steps)
        out = {"grad_steps_per_s": rate, "windows": rates,
               "window_median": float(np.median(rates)),
               "launches": launches, "peak_bytes": peak,
               "device_busy_share": share, **parts}
        if flops_per_step is not None:
            achieved = flops_per_step * rate
            out.update(flops_per_step=flops_per_step, flops_per_s=achieved,
                       peak_share=achieved / peak_ops)
            print(f"[{tag}] {flops_per_step / 1e9:.1f} GFLOP per grad step "
                  f"(reckoned): achieved {achieved / 1e12:.2f} TFLOP/s, "
                  f"{100 * achieved / peak_ops:.2f}% of the "
                  f"{peak_ops / 1e12:.0f} TFLOP/s peak; device busy share "
                  f"{share}")
        loop.close()
        return out

    return timed, finish


def phase_uniform(dev, buf) -> None:
    """One uniform chunk (no trees, no IS weights) on the twin ring."""
    from d4pg_tpu_torch.learner.loop import FusedLoop
    from d4pg_tpu_torch.learner.state import init_state

    state = init_state(config("pallas_ce"), seed=0, device=dev)
    loop = FusedLoop(config("pallas_ce"), buf, k=K, batch_size=BATCH,
                     generator=torch.Generator(device=dev).manual_seed(1),
                     prioritized=False)
    zero_counts()
    metrics = loop.run(state, K)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == {"projection": 0, "projection_ce_fwd": K,
                       "projection_ce_bwd": K, "descent": 0},
          f"uniform chunk launches: {launches}")
    for name in ("critic_loss", "actor_loss", "td_error"):
        check(bool(torch.isfinite(metrics[name]).all()),
              f"uniform chunk: finite {name}")
    idx = metrics["idx"]
    check(bool(((idx >= 0) & (idx < buf.size)).all()),
          "uniform slots in range")
    print(f"uniform chunk: launches {launches}, critic_loss "
          f"{metrics['critic_loss'][-1].item():.4f}")


def phase_ingest(dev) -> None:
    """The block ingest path on the card against the CPU: the same adds,
    blocks staged by hand with more rows pushed while one is in flight
    (they lap the 2-block staging ring), then drains. Ring, trees, size
    and head must be bitwise equal."""
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    rng = np.random.default_rng(11)
    batches = [random_rows(rng, n) for n in (300, 700, 64, 1500, 9, 2000)]
    bufs = {}
    for where in ("cpu", dev):
        buf = FusedDeviceReplay(4096, OBS, ACT, device=where, block_rows=512,
                                staging_blocks=2)
        for i, rows in enumerate(batches):
            buf.add(rows)
            buf.stage_block()
            if i % 2:
                buf.add(batches[i - 1])  # pushed while a block is in flight
            buf.commit_staged()
            buf.drain()
        bufs[str(where)] = buf
    torch.cuda.synchronize()
    cpu, card = bufs["cpu"], bufs[str(dev)]
    check((cpu.size, cpu.head) == (card.size, card.head),
          "ingest: size and head, card vs CPU")
    for name, a, b in zip(("obs", "action", "reward", "next_obs", "done",
                           "discount"), cpu.storage, card.storage):
        check(torch.equal(a[:cpu.capacity], b[:cpu.capacity].cpu()),
              f"ingest: ring {name} bitwise, card vs CPU")
    for a, b in zip(cpu.trees, card.trees):
        check(torch.equal(a, b.cpu()), "ingest: trees bitwise, card vs CPU")
    print(f"ingest on the card: {card.size} rows (head {card.head}) bitwise "
          "equal to the CPU's, pushes while a block was in flight included")


class DriverHooks:
    """What the driver logs and times, recorded through its own classes
    as a run goes: each ``MetricsBus.log`` call as (step, metrics), and
    each ``StepTimer`` span's wall time (the driver's
    ``grad_steps_per_sec`` is the reference's EWMA of the spans' rates,
    alpha 0.9, so a cycle's own rate is its steps over its span) with
    the CPU time the learner's thread took in it (``cpu_spans``). A run
    driven with ``profiled=True`` holds a profiler, warming up from the
    run's start, that records device events from the end of the first
    cycle's log call to the end of the second's: one whole iteration of
    the driver's cycle loop (checkpoint, collect, grad steps, publish,
    eval and metrics), whose wall time is ``window_s``."""

    def __init__(self):
        from d4pg_tpu_torch.io.metrics import MetricsBus
        from d4pg_tpu_torch.io.profiling import StepTimer

        self.reset(False)
        log, start, stop = (MetricsBus.log, StepTimer.start,
                            StepTimer.stop)
        hooks = self

        def logged(bus, step, metrics):
            hooks.records.append((step, dict(metrics)))
            out = log(bus, step, metrics)
            hooks._logged()
            return out

        def started(timer):
            out = start(timer)
            hooks._cpu0 = time.thread_time()
            return out

        def stopped(timer, n_steps):
            t0 = timer._t0  # set after the start's device sync
            out = stop(timer, n_steps)  # ends in a device sync
            if t0 is not None:
                hooks.spans.append(time.perf_counter() - t0)
                hooks.cpu_spans.append(time.thread_time() - hooks._cpu0)
            return out

        MetricsBus.log, StepTimer.start, StepTimer.stop = (logged, started,
                                                           stopped)

    def reset(self, profiled: bool) -> None:
        self.records, self.spans, self.cpu_spans = [], [], []
        self.device_events, self.window_s = None, None
        self._logs = 0
        self.prof = None if not profiled else profile(
            activities=[ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=self._trace_ready)

    def _trace_ready(self, prof) -> None:
        self.device_events = [e for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA
                              and not e.is_user_annotation]

    def _logged(self) -> None:
        self._logs += 1
        if self.prof is None or self._logs > 2:
            return
        if self._logs == 1:
            self.prof.step()  # warm-up -> recording
            self._w0 = time.perf_counter()
        else:
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self._w0
            self.prof.step()  # recording -> done: the trace is ready


def phase_driver(card: str, hooks: DriverHooks) -> dict:
    """``d4pg_tpu_torch.train.main`` in-process on the ``point`` env at the
    default widths (actor and critic 256x3, 51 atoms, batch 64, K = 40, a
    1,000,000-row ring, PER): three default cycles, a resume for one more,
    then two cycles under each explicit projection arm, the second
    profiled for the device-busy share, then two default cycles with the
    eval between cycles instead of beside them. Each run has its launch
    counters set to 0 just before and read just after."""
    import importlib.util
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.io.checkpoint import CheckpointManager
    from d4pg_tpu_torch.ops.autotune import select_projection

    runs = ROOT / "runs" / "chip_smoke"
    shutil.rmtree(runs, ignore_errors=True)
    cfg = ExperimentConfig(env="point").resolve()
    per_cycle = cfg.train_steps_per_cycle

    def drive(tag, *argv, profiled=False):
        log_dir = runs / tag
        hooks.reset(profiled)
        zero_counts()
        t0 = time.perf_counter()
        with hooks.prof if profiled else contextlib.nullcontext():
            result = driver.main(["--env", "point", "--n_eps", "1",
                                  "--log_dir", str(log_dir), *argv])
        torch.cuda.synchronize()
        counts = launch_counts()
        wall = time.perf_counter() - t0
        # a row per cycle; with the background eval the last step is
        # logged once more when the final eval lands
        cycles, seen = [], set()
        for step, m in hooks.records:
            if step not in seen:
                seen.add(step)
                cycles.append(m)
        own = [per_cycle / span for span in hooks.spans]
        check(len(own) == len(cycles), f"driver {tag}: a timed span per "
              f"cycle ({len(own)} spans, {len(cycles)} cycles)")
        for i, (step, m) in enumerate(hooks.records):
            rate = f"{own[i]:.2f}" if i < len(own) else "- (final eval)"
            print(f"[driver {tag}] step {step}: grad_steps_per_sec "
                  f"{m.get('grad_steps_per_sec')} (EWMA), own {rate}, "
                  f"env_steps_per_sec {m.get('env_steps_per_sec')}, "
                  f"avg_test_reward {m.get('avg_test_reward')}, "
                  f"critic_loss {m.get('critic_loss')} ({card})")
        print(f"[driver {tag}] {wall:.2f} s, launches {counts}")
        check(math.isfinite(result["critic_loss"]),
              f"driver {tag}: finite critic_loss")
        run_dir = log_dir / ExperimentConfig(env="point").run_name()
        return (counts, run_dir, [s for s, _ in hooks.records], cycles,
                own)

    def expect(counts, arm, steps, tag):
        want = {name: steps if name in fused_kernels(arm) else 0
                for name in counts}
        check(counts == want, f"driver {tag}: launches {counts}, "
              f"expected {want}")

    # the autotuner's choice at the driver's shape, made (and its race's
    # launches counted) before the runs; main() reuses the cached choice
    zero_counts()
    choice = select_projection("auto", batch_size=cfg.batch_size,
                               v_min=cfg.v_min, v_max=cfg.v_max,
                               n_atoms=cfg.n_atoms,
                               device=driver.learner_device(cfg))
    print(f"driver: auto picks {choice.selected!r} at batch "
          f"{cfg.batch_size}, {cfg.n_atoms} atoms on [{cfg.v_min}, "
          f"{cfg.v_max}] (timings_ms {choice.timings_ms}); the race "
          f"launched {launch_counts()}")

    steps = 3 * per_cycle
    counts, run_dir, logged, cycles, own_default = drive(
        "default", "--n_cycles", "3")
    check(len(cycles) == 3, f"driver: 3 cycle rows, got {len(cycles)}")
    rows = (run_dir / "returns.csv").read_text().splitlines()
    check([int(r.split(",")[0]) for r in rows] == logged,
          "driver: returns.csv holds the logged rows")
    check(sorted(set(logged)) == [40, 80, 120],
          f"driver: rows at steps 40, 80, 120 (got {logged})")
    ckpt = CheckpointManager(str(run_dir / "ckpt"))
    check(ckpt.latest_step == steps, f"driver: checkpoint at step {steps}")
    expect(counts, choice.selected, steps, "default")
    default_rates = [m["grad_steps_per_sec"] for m in cycles]
    env_rates = [m["env_steps_per_sec"] for m in cycles]

    counts, _, logged, _, own_resume = drive("default", "--n_cycles", "1",
                                             "--resume", "1")
    check(sorted(set(logged)) == [steps + per_cycle],
          f"driver resume: goes on from step {steps} (rows {logged})")
    check(ckpt.latest_step == steps + per_cycle, "driver resume: checkpoint")
    expect(counts, choice.selected, per_cycle, "resume")

    # each arm's two cycles, the second profiled for device events only
    # (the profiler's host cost would lengthen the cycle it measures)
    arms, shares = {}, {}
    for arm in ("pallas", "pallas_ce"):
        counts, _, _, _, own = drive(arm, "--n_cycles", "2",
                                     "--projection", arm, profiled=True)
        expect(counts, arm, 2 * per_cycle, arm)
        arms[arm] = counts
        events, window = hooks.device_events, hooks.window_s
        check(events is not None and window is not None,
              f"driver ({arm}): the profiled cycle was recorded")
        device_s = sum(e.self_device_time_total for e in events) / 1e6
        shares[arm] = device_s / window if device_s else None
        if device_s:
            span = per_cycle / own[1]
            print(f"driver ({arm}, second cycle profiled): device busy "
                  f"{device_s * 1e3:.3f} ms in the {window:.3f} s from "
                  f"the end of cycle 1's log to the end of cycle 2's, "
                  f"share {device_s / window:.4f}; its grad-step span "
                  f"{span * 1e3:.1f} ms ({device_s / span:.4f} of it); "
                  f"{sum(e.count for e in events) / per_cycle:.1f} device "
                  f"events per grad step ({card})")
            for e in sorted(events,
                            key=lambda e: -e.self_device_time_total)[:5]:
                print(f"  device {e.self_device_time_total / per_cycle:9.2f}"
                      f" us/step {e.count / per_cycle:7.2f} /step  "
                      f"{e.key[:70]}")
        else:
            print(f"driver ({arm}): device busy share not measured (the "
                  "profiler recorded no device events)")

    # the learner's own rate with the eval between cycles instead of on a
    # thread beside the grad steps
    counts, _, _, _, own_sync = drive("sync_eval", "--n_cycles", "2",
                                      "--concurrent_eval", "0")
    expect(counts, choice.selected, 2 * per_cycle, "sync_eval")
    print(f"driver: own grad-steps/s per cycle with the eval beside the "
          f"grad steps {[round(x, 2) for x in own_default]}, with it "
          f"between cycles {[round(x, 2) for x in own_sync]} ({card})")
    if importlib.util.find_spec("gymnasium") is None:
        print("driver: gymnasium is not installed here (Pendulum-v1 is run "
              "on the CPU only)")
    else:
        *_, own = drive("pendulum", "--env", "Pendulum-v1",
                        "--n_cycles", "1")
        print(f"driver: Pendulum-v1, one cycle at {own} grad-steps/s")
    return {"grad_steps_per_sec": default_rates,
            "own_grad_steps_per_sec": own_default,
            "own_grad_steps_per_sec_sync_eval": own_sync,
            "own_grad_steps_per_sec_resume": own_resume,
            "env_steps_per_sec": env_rates, "auto": choice.selected,
            "device_busy_share": shares,
            "launches": {"projection": arms["pallas"]["projection"],
                         "projection_ce_fwd":
                             arms["pallas_ce"]["projection_ce_fwd"],
                         "projection_ce_bwd":
                             arms["pallas_ce"]["projection_ce_bwd"],
                         "descent": arms["pallas_ce"]["descent"]}}


# (storage, arm) of the host-sampled chunks held against the CPU: both
# storages and both arms, two CPU runs at full width
HOST_PARITY = {"device": "pallas", "host": "pallas_ce"}
HOST_PARITY_CHUNKS = 3


def host_pipeline(buf, arm: str, where, record: dict | None = None):
    """A fresh state (seed 0) and a ``ChunkPipeline`` over the
    host-sampled PER buffer ``buf`` (K = 40, batch 256, beta 0.4) under
    ``arm`` on ``where``. ``record`` keeps each chunk's slots, IS weights
    and metrics while ``record["on"]``; ``host`` adds up the sample
    calls' host time (tree walks, IS weights, the gather or, for a device
    ring, the queueing of it)."""
    from d4pg_tpu_torch.learner.pipeline import ChunkPipeline
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.learner.update import multi_update_step

    cfg = config(arm)
    state = init_state(cfg, seed=0, device=where)
    host = {"sample_s": 0.0, "samples": 0}

    def sample():
        t0 = time.perf_counter()
        batches, w, idx = buf.sample_chunk(K, BATCH, beta=0.4)
        gen = buf.generation[idx].copy()
        host["sample_s"] += time.perf_counter() - t0
        host["samples"] += 1
        if record is not None and record["on"]:
            record["slots"].append((idx, w))
        return (batches, w), (idx, gen)

    def write_back(aux, prio):
        idx, gen = aux
        for i in range(len(idx)):
            buf.update_priorities(idx[i], prio[i], generation=gen[i])

    def update(s, batches, w):
        m = multi_update_step(cfg, s, batches, w)
        if record is not None and record["on"]:
            record["metrics"].append(m)
        return s, m

    return state, ChunkPipeline(update, sample, write_back,
                                device=where), host


def host_buffer(storage: str, where, blocks):
    """A 200,000-row host-sampled PER buffer (seed 0) filled with
    ``blocks``; a device ring lives on ``where``."""
    from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer

    buf = PrioritizedReplayBuffer(CAPACITY, OBS, ACT, alpha=0.6, seed=0,
                                  storage=storage, device=where)
    for rows in blocks:
        buf.add(rows)
    return buf


def phase_device_ring_commits(dev) -> None:
    """Adds through a ``ReplayService``'s commit thread into a non-fused
    device ring, with the learner thread gathering chunks from it
    meanwhile, against the same adds into a ring on the CPU: rings,
    generations and tree leaves bitwise equal."""
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer

    rng = np.random.default_rng(12)
    batches = [random_rows(rng, n)
               for n in (300, 700, 64, 1500, 9, 2000, 900, 1)]
    out = {}
    for where in ("cpu", dev):
        buf = PrioritizedReplayBuffer(4096, OBS, ACT, seed=0,
                                      storage="device", device=where)
        service = ReplayService(buf)
        for rows in batches:
            check(service.add(rows), "device ring: add admitted")
            if len(service):
                batch, _, _, _ = service.sample_chunk(2, 64)
                check(tuple(batch.obs.shape) == (2, 64, OBS),
                      "device ring: gathered chunk shape")
        service.flush()
        service.close()
        if where != "cpu":
            torch.cuda.synchronize()
        out[str(where)] = buf
    cpu, card = out["cpu"], out[str(dev)]
    check((cpu.size, cpu.head) == (card.size, card.head),
          "device ring: size and head, card vs CPU")
    for name, a, b in zip(("obs", "action", "reward", "next_obs", "done",
                           "discount"), cpu._store.arrays,
                          card._store.arrays):
        check(torch.equal(a, b.cpu()),
              f"device ring: {name} bitwise, card vs CPU")
    check(np.array_equal(cpu.generation, card.generation),
          "device ring: generations")
    live = np.arange(cpu.size)
    check(np.array_equal(cpu._trees.get(live), card._trees.get(live)),
          "device ring: tree leaves")
    print(f"device ring on the card: {card.size} rows committed by the "
          f"service's commit thread (head {card.head}, the ring wrapped), "
          "bitwise equal to the CPU's")


def phase_host_chunks(dev, card: str) -> dict:
    """The host-sampled path at the slice's shape (Humanoid width, batch
    256, a 200,000-row ring, K = 40): ``ChunkPipeline`` over
    ``PrioritizedReplayBuffer`` with its ring on the card
    (``storage='device'``) and in host RAM (``'host'``). For each storage
    the first chunks of a fresh buffer against a CPU run of the same
    pipeline (slots and IS weights bitwise, losses and TD errors within
    rtol 1e-4), then both arms timed in turns in windows of 2 chunks with
    the launch counters set to 0 just before and read just after (the
    arm's kernels once per grad step, the descent never), and one
    ``einsum`` chunk (no kernel at all)."""
    from d4pg_tpu_torch.replay import native

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    blocks = [random_rows(rng, min(FILL_BLOCK, CAPACITY - start))
              for start in range(0, CAPACITY, FILL_BLOCK)]
    print(f"host path: {CAPACITY} rows made in "
          f"{time.perf_counter() - t0:.2f} s")
    result = {}
    for storage, parity_arm in HOST_PARITY.items():
        t0 = time.perf_counter()
        buf = host_buffer(storage, dev, blocks)
        torch.cuda.synchronize()
        print(f"[host {storage}] ring filled in "
              f"{time.perf_counter() - t0:.2f} s; trees: {buf.tree_backend} "
              f"({Path(native.library()._name).name})")
        check(buf.tree_backend == "native",
              f"[host {storage}] the native tree backend is loaded")
        check(len(buf) == CAPACITY, f"[host {storage}] ring full")

        # the first chunks of the fresh buffer, card against CPU
        record = {"on": True, "slots": [], "metrics": []}
        state, pipe, host = host_pipeline(buf, parity_arm, dev, record)
        zero_counts()
        pipe.run(state, HOST_PARITY_CHUNKS, final_prefetch=False)
        torch.cuda.synchronize()
        counts = launch_counts()
        steps = K * HOST_PARITY_CHUNKS
        check(counts == {name: steps if name in ARM_KERNELS[parity_arm]
                         else 0 for name in counts},
              f"[host {storage}] parity chunks' launches {counts}")
        t0 = time.perf_counter()
        cpu_buf = host_buffer(storage, "cpu", blocks)
        cpu_record = {"on": True, "slots": [], "metrics": []}
        cpu_state, cpu_pipe, _ = host_pipeline(cpu_buf, parity_arm, "cpu",
                                               cpu_record)
        cpu_pipe.run(cpu_state, HOST_PARITY_CHUNKS, final_prefetch=False)
        print(f"[host {storage}] CPU run of {HOST_PARITY_CHUNKS} chunks: "
              f"{time.perf_counter() - t0:.2f} s")
        del cpu_buf
        # samples past the ones run (the stager's prefetch) are unchecked
        for i in range(HOST_PARITY_CHUNKS):
            (ti, tw), (ci, cw) = record["slots"][i], cpu_record["slots"][i]
            check(np.array_equal(ti, ci) and np.array_equal(tw, cw),
                  f"[host {storage}] chunk {i}: slots and IS weights "
                  "bitwise, card vs CPU")
        worst = {}
        for got, want in zip(record["metrics"], cpu_record["metrics"]):
            for name in ("critic_loss", "actor_loss", "td_error"):
                err = _rel_err(got[name].cpu(), want[name])
                worst[name] = max(worst.get(name, 0.0), err)
        for name, err in worst.items():
            print(f"[host {storage}] {parity_arm}, first "
                  f"{HOST_PARITY_CHUNKS} chunks card vs CPU {name}: max rel "
                  f"err {err:.3e}")
            check(err <= 1e-4, f"[host {storage}] {name} card vs CPU")
        record["on"] = False

        # both arms in turns, each warmed up by one chunk
        arms = {parity_arm: (state, pipe, host)}
        for arm in ("pallas", "pallas_ce"):
            if arm not in arms:
                arms[arm] = host_pipeline(buf, arm, dev)
            arms[arm][1].run(arms[arm][0], 1)
        torch.cuda.synchronize()
        stats = {arm: {"steps": 0, "s": 0.0, "launches": None, "rates": []}
                 for arm in arms}
        for arm in ("pallas", "pallas_ce", "pallas_ce", "pallas") * 2 + (
                "pallas", "pallas_ce"):
            st, pl, _ = arms[arm]
            h2d0 = pl.stager.h2d_bytes + getattr(buf._store, "index_bytes",
                                                 0)
            zero_counts()
            t0 = time.perf_counter()
            pl.run(st, WINDOW_CHUNKS)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launch_counts()
            steps = K * WINDOW_CHUNKS
            check(counts == {name: steps if name in ARM_KERNELS[arm] else 0
                             for name in counts},
                  f"[host {storage}] [{arm}] window launches {counts}")
            acc = stats[arm]
            acc["steps"] += steps
            acc["s"] += dt
            acc["rates"].append(steps / dt)
            acc["launches"] = (counts if acc["launches"] is None else
                               {n: acc["launches"][n] + counts[n]
                                for n in counts})
            acc.setdefault("h2d", []).append(
                pl.stager.h2d_bytes + getattr(buf._store, "index_bytes", 0)
                - h2d0)
        for arm, (st, pl, host) in arms.items():
            acc = stats[arm]
            check(acc["steps"] == K * TIMED_CHUNKS,
                  f"[host {storage}] [{arm}] timed steps")
            # pinned blocks whose copy was still in flight at refill: the
            # stager's, and for a device ring its index blocks
            pinned = pl.stager.waits + getattr(buf._store, "read_waits", 0)
            h2d = float(np.median(acc.pop("h2d"))) / WINDOW_CHUNKS
            sampled = host["samples"]
            acc.update(
                grad_steps_per_s=acc["steps"] / acc["s"],
                h2d_bytes_per_chunk=h2d, td_waits=pl.waits,
                pinned_waits=pinned,
                host_ms_per_chunk=1e3 * host["sample_s"] / sampled,
                waits_per_chunk=(pl.waits + pinned) / sampled)
            print(f"[host {storage}] [{arm}] windows "
                  f"{', '.join(f'{x:.1f}' for x in acc['rates'])} "
                  f"grad-steps/s; {acc['grad_steps_per_s']:.1f} over "
                  f"{acc['steps']} steps; host "
                  f"{acc['host_ms_per_chunk']:.2f} ms/chunk (tree walks + "
                  f"gather); H2D {h2d:.0f} B/chunk; waits: td {pl.waits}, "
                  f"pinned {pinned} in {sampled} chunks; launches "
                  f"{acc['launches']} ({card})")
        # where a grad step's time goes on this path (auto's arm)
        st, pl, _ = arms["pallas_ce"]
        acc = stats["pallas_ce"]
        print(f"[host {storage}] [pallas_ce] breakdown:")
        acc.update(breakdown(lambda chunks: pl.run(st, chunks),
                             1e3 * acc["s"] / acc["steps"]))
        # the einsum arm: no kernel at all (the plain projection)
        est, epl, _ = host_pipeline(buf, "einsum", dev)
        zero_counts()
        epl.run(est, 1, final_prefetch=False)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(not any(counts.values()),
              f"[host {storage}] einsum launches {counts}")
        print(f"[host {storage}] [einsum] one chunk, launches {counts}")
        if storage == "host":
            want = K * BATCH * (2 * OBS + ACT + 3) * 4 + K * BATCH * 4
        else:
            want = K * BATCH * (8 + 4)
        check(all(abs(st["h2d_bytes_per_chunk"] - want) < 1
                  for st in stats.values()),
              f"[host {storage}] H2D bytes per chunk == {want}")
        result[storage] = stats
        del buf, arms, state, pipe
    return result


def phase_driver_host(card: str, hooks: DriverHooks, arm: str) -> dict:
    """``train.main`` on the ``point`` env at the default widths through
    the host-sampled path: two cycles with ``--fused_replay off`` (the
    non-fused device ring), two with ``--replay_storage host`` plus
    ``--trace_sample 1.0 --profile_dir`` (a profiler trace written,
    ``mark_grad`` once per chunk, the registry's
    ``ingest.rows_committed`` equal to the rows in the buffer), then a
    resume for one more cycle. Launches: the arm's kernels once per grad
    step, the descent never."""
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.learner import pipeline as pipeline_mod
    from d4pg_tpu_torch.obs.registry import REGISTRY

    runs = ROOT / "runs" / "chip_smoke_host"
    shutil.rmtree(runs, ignore_errors=True)
    per_cycle = ExperimentConfig(env="point").resolve().train_steps_per_cycle
    recorder = pipeline_mod.trace_recorder
    marks = []
    closed = []
    close = ReplayService.close

    def closing(service):
        closed.append((REGISTRY.counter("ingest.rows_committed").value,
                       REGISTRY.export().get("ingest", {}).get(
                           "rows_committed"),
                       len(service.buffer)))
        close(service)

    ReplayService.close = closing
    recorder.mark_grad = lambda ts=None: marks.append(ts) or 0
    out = {}
    try:
        for tag, argv in (
                ("fused_off", ["--fused_replay", "off", "--n_cycles", "2"]),
                ("host", ["--replay_storage", "host", "--n_cycles", "2",
                          "--trace_sample", "1.0", "--profile_dir",
                          str(runs / "profile")]),
                ("host_resume", ["--replay_storage", "host", "--n_cycles",
                                 "1", "--resume", "1"])):
            hooks.reset(False)
            marks.clear()
            closed.clear()
            REGISTRY.counter("ingest.rows_committed").reset()
            zero_counts()
            t0 = time.perf_counter()
            log_tag = "host" if tag == "host_resume" else tag
            result = driver.main(["--env", "point", "--n_eps", "1",
                                  "--log_dir", str(runs / log_tag), *argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            cycles, seen = [], set()
            for step, m in hooks.records:
                if step not in seen:
                    seen.add(step)
                    cycles.append((step, m))
            n_cycles = len(cycles)
            steps = per_cycle * n_cycles
            own = [per_cycle / span for span in hooks.spans]
            check(len(own) == n_cycles, f"driver {tag}: a span per cycle")
            check(math.isfinite(result["critic_loss"]),
                  f"driver {tag}: finite critic_loss")
            check(counts == {n: steps if n in ARM_KERNELS[arm] else 0
                             for n in counts},
                  f"driver {tag}: launches {counts} ({arm})")
            for (step, m), rate in zip(cycles, own):
                print(f"[driver {tag}] step {step}: own {rate:.2f} "
                      f"grad-steps/s (EWMA {m.get('grad_steps_per_sec')}), "
                      f"env_steps_per_sec {m.get('env_steps_per_sec')}, "
                      f"critic_loss {m.get('critic_loss')} ({card})")
            per_step = {n: c / steps for n, c in counts.items()}
            print(f"[driver {tag}] {wall:.2f} s, launches per grad step "
                  f"{per_step}")
            (counter, provided, rows), = closed
            check(counter == rows,
                  f"driver {tag}: ingest.rows_committed {counter} == "
                  f"{rows} rows in the buffer")
            check(provided == counter,
                  f"driver {tag}: the ingest provider's rows_committed")
            if tag == "host":
                traces = list((runs / "profile").glob("trace_*.json"))
                check(len(traces) == 1, "driver host: one profiler trace")
                check(len(marks) == steps // K,
                      f"driver host: mark_grad {len(marks)} times in "
                      f"{steps // K} chunks")
                check("wire_to_grad_p95_ms" not in result,
                      "driver host: no wire-to-grad span in process")
                print(f"[driver host] profiler trace {traces[0].name} "
                      f"({traces[0].stat().st_size} B); mark_grad "
                      f"{len(marks)} times in {steps // K} chunks")
            if tag == "host_resume":
                check([s for s, _ in cycles] == [3 * per_cycle],
                      f"driver resume: goes on from step {2 * per_cycle}")
            out[tag] = {"own_grad_steps_per_sec": own,
                        "env_steps_per_sec": [m.get("env_steps_per_sec")
                                              for _, m in cycles],
                        "launches": counts}
    finally:
        ReplayService.close = close
        del recorder.mark_grad
    return out


# --- the learner's model families (phases 14-17) -------------------------

# the slice's pixel shape: the ``cheetah-run-pixels`` preset at full width
# (84x84 frames stacked 3 deep, encoder width 32, latent 50, hidden 256x3,
# 51 atoms on [0, 1000], act 6, DrQ shift of 4 px, shared encoder)
PIXEL_SHAPE, PIXEL_ACT, PIXEL_CHANNELS, PIXEL_LATENT = (84, 84, 9), 6, \
    (32, 32, 32, 32), 50
PIXEL_V = (0.0, 1000.0)
PIXEL_CAPACITY, PIXEL_BLOCKS = 50_000, 2  # ring rows; distinct fill blocks
PIXEL_CAP = 1 << 16  # next_pow2(PIXEL_CAPACITY): the ring's leaf count
PIXEL_WINDOWS, PIXEL_WINDOW_CHUNKS = 3, 2  # per arm, in turns
# H100 SXM dense bfloat16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_OPS_PER_S = 989e12
MOG_COMPONENTS, MOG_SAMPLES = 5, 32


def pixel_config(compute_dtype: str = "float32"):
    from d4pg_tpu_torch.learner.state import D4PGConfig

    return D4PGConfig(
        obs_dim=int(np.prod(PIXEL_SHAPE)), act_dim=PIXEL_ACT,
        v_min=PIXEL_V[0], v_max=PIXEL_V[1], n_atoms=ATOMS, hidden=HIDDEN,
        projection="pallas_ce", pixels=True, obs_shape=PIXEL_SHAPE,
        encoder_channels=PIXEL_CHANNELS, augment="shift", augment_pad=4,
        share_encoder=True, compute_dtype=compute_dtype)


def mog_config():
    from d4pg_tpu_torch.learner.state import D4PGConfig

    return D4PGConfig(obs_dim=OBS, act_dim=ACT, v_min=V_MIN, v_max=V_MAX,
                      n_atoms=ATOMS, hidden=HIDDEN, projection="pallas_ce",
                      critic_family="mog", n_components=MOG_COMPONENTS,
                      mog_samples=MOG_SAMPLES)


def pixel_rows(rng, n, act=PIXEL_ACT):
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    done = (rng.random(n) < 0.05).astype(np.float32)
    return TransitionBatch(
        obs=rng.integers(0, 256, (n, *PIXEL_SHAPE), dtype=np.uint8),
        action=rng.uniform(-1, 1, (n, act)).astype(np.float32),
        reward=rng.uniform(0, 10, n).astype(np.float32),
        next_obs=rng.integers(0, 256, (n, *PIXEL_SHAPE), dtype=np.uint8),
        done=done, discount=(0.99 ** 3 * (1 - done)).astype(np.float32))


def encoder_flops() -> tuple[float, float]:
    """(FLOPs of one frame's encoder forward, of its first conv): 2 per
    multiply-add of each 3x3 conv at XLA's SAME output size, and of the
    projection (LayerNorm and tanh are negligible)."""
    h, w, c = PIXEL_SHAPE
    total, first = 0.0, None
    for i, ch in enumerate(PIXEL_CHANNELS):
        s = 2 if i == 0 else 1
        h, w = -(-h // s), -(-w // s)
        f = 2.0 * h * w * ch * 9 * c
        first = f if first is None else first
        total, c = total + f, ch
    return total + 2.0 * h * w * c * PIXEL_LATENT, first


def pixel_step_flops(batch: int) -> float:
    """FLOPs of one pixel grad step as ``learner/update.py`` computes it,
    per sample times ``batch``. Encoder: the target actor's and target
    critic's forwards on next_obs, the critic's forward on obs and its
    backward (weight and input gradients, 2 forwards, less the first
    conv's input gradient), the actor's forward on obs (detached: no
    backward) and the critic's on obs in the actor loss (its encoder
    outside the actor's gradient): 7 forwards less one first conv. MLPs:
    the actor 4 forwards' worth (target, online, backward), the critic 6
    (target, online and its backward, then the actor loss's forward and
    its input-gradient backward)."""
    enc, conv1 = encoder_flops()
    h = HIDDEN
    actor = 2.0 * (PIXEL_LATENT * h[0] + h[0] * h[1] + h[1] * h[2]
                   + h[2] * PIXEL_ACT)
    critic = 2.0 * (PIXEL_LATENT * h[0] + (h[0] + PIXEL_ACT) * h[1]
                    + h[1] * h[2] + h[2] * ATOMS)
    return batch * (7 * enc - conv1 + 4 * actor + 6 * critic)


def _draws(rng, k, batch, pad=None, mog=None):
    """Injected update draws shared by the card and the CPU: DrQ offsets
    in [0, 2 pad] and/or MoG Gumbel and normal draws."""
    from d4pg_tpu_torch.learner.update import UpdateDraws

    fields = {}
    if pad is not None:
        for name in ("obs_shift", "next_shift"):
            fields[name] = torch.from_numpy(
                rng.integers(0, 2 * pad + 1, (k, batch, 2)))
    if mog is not None:
        u = rng.uniform(1e-7, 1.0, (k, batch, MOG_SAMPLES, mog))
        fields["gumbel"] = torch.from_numpy(
            (-np.log(-np.log(u))).astype(np.float32))
        fields["normal"] = torch.from_numpy(rng.standard_normal(
            (k, batch, MOG_SAMPLES)).astype(np.float32))
    return UpdateDraws(**fields)


def _encoders_tied(state) -> bool:
    return all(torch.equal(a, c) for a, c in zip(
        state.actor.encoder.parameters(), state.critic.encoder.parameters()))


def phase_pixel_reference(dev) -> None:
    """``multi_update_step`` of the pixel model at full width, K = 3 steps
    of batch 32 (one step per call, so the tie is checked after each),
    on the card against the CPU with the same weights, batches, IS
    weights and injected DrQ offsets: float32 losses and TD errors within
    rtol 1e-4, bfloat16 losses within rtol 2e-2; after every step the
    actor's encoder equals the critic's, bitwise."""
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.learner.update import multi_update_step
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    k, batch = 3, 32
    rng = np.random.default_rng(21)
    rows = [pixel_rows(rng, batch) for _ in range(k)]
    stacked = TransitionBatch(*[np.stack(f) for f in zip(*rows)])
    w = torch.from_numpy((0.5 + rng.random((k, batch))).astype(np.float32))
    draws = _draws(rng, k, batch, pad=4)
    for dtype, rtol, names in (
            ("float32", 1e-4, ("critic_loss", "actor_loss", "td_error")),
            ("bfloat16", 2e-2, ("critic_loss", "actor_loss"))):
        cfg = pixel_config(dtype)
        out = {}
        for where in ("cpu", dev):
            state = init_state(cfg, seed=0, device=where)
            steps = []
            t0 = time.perf_counter()
            for t in range(k):
                one = TransitionBatch(*[torch.from_numpy(f[t:t + 1]).to(where)
                                        for f in stacked])
                steps.append(multi_update_step(
                    cfg, state, one, w[t:t + 1].to(where),
                    type(draws)(*[None if d is None else d[t:t + 1].to(where)
                                  for d in draws])))
                check(_encoders_tied(state),
                      f"pixel {dtype} on {where}: encoders tied after "
                      f"step {t}")
            if str(where) != "cpu":
                torch.cuda.synchronize()
            out[str(where)] = {n: torch.cat([m[n] for m in steps]).cpu()
                               for n in names}
            print(f"pixel {dtype} K={k} on {where}: "
                  f"{time.perf_counter() - t0:.2f} s")
        for name in names:
            err = _rel_err(out[str(dev)][name], out["cpu"][name])
            print(f"pixel {dtype} multi_update_step card vs CPU {name}: max "
                  f"rel err {err:.3e} (bar {rtol:g})")
            check(err <= rtol, f"pixel {dtype} {name} card vs CPU")


def fill_pixel_ring(dev):
    """``FusedDeviceReplay(50_000, (84, 84, 9), 6)`` with uint8 rows and PER,
    filled through ``add``/``drain`` from two distinct 4,096-row blocks
    generated once and used in turns."""
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    blocks = [pixel_rows(rng, FILL_BLOCK) for _ in range(PIXEL_BLOCKS)]
    made = time.perf_counter() - t0
    buf = FusedDeviceReplay(PIXEL_CAPACITY, PIXEL_SHAPE, PIXEL_ACT,
                            alpha=0.6, device=dev, staging_blocks=2)
    check(buf.storage.obs.dtype == torch.uint8, "pixel ring stores uint8")
    for i, start in enumerate(range(0, PIXEL_CAPACITY, FILL_BLOCK)):
        n = min(FILL_BLOCK, PIXEL_CAPACITY - start)
        block = blocks[i % PIXEL_BLOCKS]
        buf.add(type(block)(*[f[:n] for f in block]))
        buf.drain()
    torch.cuda.synchronize()
    ring_bytes = sum(t.numel() * t.element_size() for t in buf.storage)
    print(f"pixel ring: {buf.size} rows of uint8 {PIXEL_SHAPE} "
          f"({ring_bytes / 1e9:.3f} GB on the card) in "
          f"{time.perf_counter() - t0:.2f} s ({made:.2f} s to make "
          f"{PIXEL_BLOCKS} blocks)")
    check(buf.size == PIXEL_CAPACITY, "pixel ring full")
    check(torch.equal(buf.storage.obs[FILL_BLOCK].cpu(),
                      torch.from_numpy(blocks[1].obs[0])),
          "pixel ring: the second block's first row, bitwise")
    # the descent on this ring's own tree (its last 15,536 leaves zero):
    # Q = 256, the left sums and the total, bitwise the plain version
    from d4pg_tpu_torch.ops import sampler_descent as desc

    tree = buf.trees.sum_tree
    check(tree.shape[0] == 2 * PIXEL_CAP, "pixel ring: 2^16 leaves")
    gen = torch.Generator(device=dev).manual_seed(3)
    mass = torch.cat([torch.rand(BATCH, generator=gen, device=dev) * tree[1],
                      _left_sum_masses(tree), tree[1:2]]).contiguous()
    check(torch.equal(desc.descend(tree, mass),
                      desc.descend_plain(tree, mass)),
          "descent on the pixel ring's tree bitwise")
    print(f"descent on the pixel ring's tree ({desc.rounds(PIXEL_CAP)} "
          f"rounds): bitwise equal ({mass.numel()} queries)")
    return buf, ring_bytes


def phase_pixel_slice(dev) -> dict:
    """The pixel slice: the 50,000-row uint8 ring, ``FusedLoop`` under
    ``pallas_ce`` with the pixel model at full width, float32 and
    bfloat16 arms warmed up and then timed in turns (A B B A A B) in
    windows of two chunks."""
    buf, ring_bytes = fill_pixel_ring(dev)
    flops = pixel_step_flops(BATCH)
    kernels = fused_kernels("pallas_ce")
    chunks = PIXEL_WINDOWS * PIXEL_WINDOW_CHUNKS
    arms = {"pixel_f32": slice_arm(dev, buf, pixel_config("float32"),
                                   "pixel float32", kernels, chunks, flops,
                                   FP32_OPS_PER_S),
            "pixel_bf16": slice_arm(dev, buf, pixel_config("bfloat16"),
                                    "pixel bfloat16", kernels, chunks, flops,
                                    BF16_OPS_PER_S)}
    for arm in ("pixel_f32", "pixel_bf16", "pixel_bf16", "pixel_f32",
                "pixel_f32", "pixel_bf16"):
        arms[arm][0](PIXEL_WINDOW_CHUNKS)
    out = {arm: finish() for arm, (_, finish) in arms.items()}
    for result in out.values():
        result["ring_bytes"] = ring_bytes
    del buf
    torch.cuda.empty_cache()
    return out


def phase_mog(dev, per) -> dict:
    """The MoG critic at the Humanoid width of phase 9 (``n_components``
    5, ``mog_samples`` 32): its fused PER chunk's first 3 steps on the
    card against the CPU with injected uniforms and MoG draws (slots
    equal; losses and TD errors within rtol 1e-4), then timed windows
    over phase 9's ring. Launches: the descent once per grad step, the
    projection and CE kernels never."""
    from d4pg_tpu_torch.learner.fused import make_fused_chunk
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    k, cap = 3, 2048
    rng = np.random.default_rng(31)
    rows = random_rows(rng, cap)
    u = torch.from_numpy(rng.random((k, BATCH)).astype(np.float32))
    draws = _draws(rng, k, BATCH, mog=MOG_COMPONENTS)
    cfg = mog_config()
    out = {}
    for where in ("cpu", dev):
        buf = FusedDeviceReplay(cap, OBS, ACT, device=where, block_rows=512)
        buf.add(rows)
        buf.drain()
        state = init_state(cfg, seed=0, device=where)
        fn = make_fused_chunk(cfg, k=k, batch_size=BATCH)
        zero_counts()
        _, m = fn(state, buf.trees, buf.storage, buf.size, u=u.to(where),
                  draws=type(draws)(*[None if d is None else d.to(where)
                                      for d in draws]))
        out[str(where)] = {n: v.cpu() for n, v in m.items()}
    launches = launch_counts()
    check(launches == {"projection": 0, "projection_ce_fwd": 0,
                       "projection_ce_bwd": 0, "descent": k},
          f"MoG chunk launches: {launches}")
    cpu, gpu = out["cpu"], out[str(dev)]
    check(torch.equal(cpu["idx"], gpu["idx"]), "MoG chunk slots, card vs CPU")
    for name in ("critic_loss", "actor_loss", "td_error"):
        err = _rel_err(gpu[name], cpu[name])
        print(f"MoG chunk card vs CPU {name}: max rel err {err:.3e}")
        check(err <= 1e-4, f"MoG chunk {name} card vs CPU")
    timed, finish = slice_arm(dev, per, cfg, "mog", ("descent",),
                              3 * WINDOW_CHUNKS)
    for _ in range(3):
        timed(WINDOW_CHUNKS)
    return finish()


def phase_driver_families(card: str, hooks: DriverHooks) -> dict:
    """``train.main`` on the new families at the default widths:
    ``pixel-point`` with ``--frame_stack 3 --augment shift
    --share_encoder 1`` (uint8 [16, 16, 9] rows) for two cycles, a
    resume for one, one cycle with ``--compute_dtype bfloat16`` and one
    with ``--fused_replay off``; then ``point`` with ``--critic_family
    mog`` for two cycles and a resume. Launches per grad step: the arm
    ``auto`` chose once (never under MoG), the descent once on the fused
    path; the rows in the ring are checked when the service closes."""
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.ops.autotune import select_projection

    runs = ROOT / "runs" / "chip_smoke_families"
    shutil.rmtree(runs, ignore_errors=True)
    pixel = ["--env", "pixel-point", "--frame_stack", "3", "--augment",
             "shift", "--share_encoder", "1"]
    mog = ["--env", "point", "--critic_family", "mog"]
    arms = {}
    for env in ("pixel-point", "point"):
        cfg = ExperimentConfig(env=env).resolve()
        dev = driver.learner_device(cfg)
        zero_counts()
        arms[env] = select_projection(
            "auto", batch_size=cfg.batch_size, v_min=cfg.v_min,
            v_max=cfg.v_max, n_atoms=cfg.n_atoms, device=dev).selected
    per_cycle = ExperimentConfig(env="point").resolve().train_steps_per_cycle
    rings = []
    close = ReplayService.close

    def closing(service):
        buf = service.buffer
        # the fused buffer's ring is a TransitionBatch of device tensors;
        # the host-sampled buffers gather
        obs = (buf.storage.obs if isinstance(buf.storage, tuple)
               else buf.gather(np.arange(1)).obs)
        rings.append((type(buf).__name__, tuple(obs.shape[1:]), obs.dtype))
        close(service)

    ReplayService.close = closing
    out = {}
    try:
        for tag, argv, fused, cycles in (
                ("pixel", pixel + ["--n_cycles", "2"], True, [2]),
                ("pixel_resume", pixel + ["--n_cycles", "1", "--resume",
                                          "1"], True, [3]),
                ("pixel_bf16", pixel + ["--n_cycles", "1",
                                        "--compute_dtype", "bfloat16"],
                 True, [1]),
                ("pixel_host", pixel + ["--n_cycles", "1", "--fused_replay",
                                        "off"], False, [1]),
                ("mog", mog + ["--n_cycles", "2"], True, [2]),
                ("mog_resume", mog + ["--n_cycles", "1", "--resume", "1"],
                 True, [3])):
            hooks.reset(False)
            rings.clear()
            zero_counts()
            t0 = time.perf_counter()
            log_tag = tag.replace("_resume", "")
            result = driver.main(["--n_eps", "1", "--log_dir",
                                  str(runs / log_tag), *argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            steps_seen = sorted({s for s, _ in hooks.records})
            check(steps_seen[-1:] == [per_cycle * cycles[0]],
                  f"driver {tag}: ends at step {per_cycle * cycles[0]} "
                  f"(rows {steps_seen})")
            n = per_cycle * len(hooks.spans)
            check(math.isfinite(result["critic_loss"]),
                  f"driver {tag}: finite critic_loss")
            arm = "einsum" if tag.startswith("mog") else arms[
                "pixel-point" if tag.startswith("pixel") else "point"]
            want = {name: n if name in ARM_KERNELS[arm] + (
                ("descent",) if fused else ()) else 0 for name in counts}
            check(counts == want, f"driver {tag}: launches {counts}, "
                  f"expected {want}")
            (kind, shape, dtype), = rings
            if tag.startswith("pixel"):
                check(shape == (16, 16, 9) and dtype in (torch.uint8,
                                                         np.uint8),
                      f"driver {tag}: ring rows {shape} {dtype}")
            own = [per_cycle / span for span in hooks.spans]
            env_rates = [m.get("env_steps_per_sec") for _, m in
                         hooks.records]
            print(f"[driver {tag}] {wall:.2f} s; {kind} rows {shape} "
                  f"{dtype}; own grad-steps/s "
                  f"{[round(x, 2) for x in own]}, env_steps_per_sec "
                  f"{env_rates}, launches per grad step "
                  f"{ {k: c / n for k, c in counts.items()} } ({card})")
            out[tag] = {"own_grad_steps_per_sec": own,
                        "env_steps_per_sec": env_rates, "launches": counts}
    finally:
        ReplayService.close = close
    return out


def phase_her_ingest(dev) -> None:
    """The normalized fused ingest: ``GoalActorWorker`` episodes of
    ``FakeGoalEnv`` (seed 0, 50-step horizon) through a
    ``ReplayService(obs_norm=RunningMeanStd(4))`` over a
    ``FusedDeviceReplay`` on the card; a spy keeps the raw batches. The
    ring's ``obs`` and ``next_obs`` rows must be bitwise ``normalize`` of
    the raw rows on the host, folded batch by batch in the same order,
    and ``env_steps`` the env steps taken (relabels uncounted)."""
    from d4pg_tpu_torch.distributed.actor import GoalActorWorker
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.envs.fake import FakeGoalEnv
    from d4pg_tpu_torch.envs.normalizer import RunningMeanStd
    from d4pg_tpu_torch.learner.state import D4PGConfig
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
    from d4pg_tpu_torch.serving.client import ActorConfig

    norm = RunningMeanStd(4)
    buf = FusedDeviceReplay(16_384, 4, 2, device=dev, block_rows=512)
    service = ReplayService(buf, obs_norm=norm)
    raw = []

    class Spy:
        def add(self, batch, actor_id="local", count_env_steps=True, **kw):
            raw.append(batch)
            return service.add(batch, actor_id=actor_id,
                               count_env_steps=count_env_steps, **kw)

    actor = GoalActorWorker(
        "goal-0", D4PGConfig(obs_dim=4, act_dim=2), ActorConfig(gamma=0.98),
        FakeGoalEnv(horizon=50, seed=0), Spy(), WeightStore(),
        her_ratio=0.8, rng_seed=0, seed=0, obs_norm=norm, learner_device=dev)
    try:
        for _ in range(40):
            actor.run_episode(50)
        service.flush()
        service.drain_device()
        rows = sum(b.obs.shape[0] for b in raw)
        check(buf.size == rows, f"her ingest: {buf.size} rows in the ring, "
              f"{rows} streamed")
        host = RunningMeanStd(4)
        want_obs, want_next = [], []
        for b in raw:
            host.update(b.obs)
            want_obs.append(host.normalize(b.obs))
            want_next.append(host.normalize(b.next_obs))
        ring = buf.storage
        check(ring.obs.device.type == "cuda", "her ingest: the ring is on "
              "the card")
        check(np.array_equal(ring.obs[:rows].cpu().numpy(),
                             np.concatenate(want_obs)),
              "her ingest: ring obs bitwise the host normalize")
        check(np.array_equal(ring.next_obs[:rows].cpu().numpy(),
                             np.concatenate(want_next)),
              "her ingest: ring next_obs bitwise the host normalize")
        check(norm.state_dict()["count"] == host.state_dict()["count"],
              "her ingest: the service folded every obs row once")
        check(service.env_steps == actor.env_steps < rows,
              f"her ingest: env_steps {service.env_steps} == env steps "
              f"taken {actor.env_steps} < rows {rows}")
    finally:
        service.close()
    print(f"her ingest: {len(raw) // 2} episodes, {actor.env_steps} env "
          f"steps, {rows} rows on the card bitwise the host's normalize "
          f"(fold order kept), relabels uncounted")


def _driver_run(hooks, driver, tag, argv, log_dir, profiled=False):
    """``driver.main(argv)`` with the launch counters set to 0 just before
    and read just after; (result, counts, own grad-steps/s per cycle, the
    logged cycle rows, wall seconds). ``profiled``: the second cycle's
    device events land in ``hooks`` (see ``DriverHooks``)."""

    hooks.reset(profiled)
    zero_counts()
    t0 = time.perf_counter()
    with hooks.prof if profiled else contextlib.nullcontext():
        result = driver.main([*argv, "--n_eps", "1", "--log_dir",
                              str(log_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    cycles, seen = [], set()
    for step, m in hooks.records:
        if step not in seen:
            seen.add(step)
            cycles.append(m)
    from d4pg_tpu_torch.config import ExperimentConfig

    per_cycle = ExperimentConfig().train_steps_per_cycle  # 40, not changed
    own = [per_cycle / span for span in hooks.spans]
    check(math.isfinite(result["critic_loss"]),
          f"driver {tag}: finite critic_loss")
    return result, counts, own, cycles, wall


def phase_her_driver(card: str, hooks: DriverHooks) -> dict:
    """The HER recipe through ``train.main`` at the default widths (hidden
    256x3, 51 atoms, the fused path): the reference's FetchReach recipe on
    ``fake-goal`` (``--her 1 --normalize_obs 1 --n_steps 1 --max_steps 50
    --bsize 256 --episodes_per_cycle 4 --train_steps_per_cycle 40
    --random_eps 0.3``) for two cycles, then ``--resume 1`` for one. The
    resumed normalizer's count is the saved one; the arm ``auto`` picks
    and the descent launch once per grad step; after the last publish
    the weight store's statistics are the service normalizer's."""
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.io.checkpoint import CheckpointManager
    from d4pg_tpu_torch.ops.autotune import select_projection

    runs = ROOT / "runs" / "chip_smoke_her"
    shutil.rmtree(runs, ignore_errors=True)
    argv = ["--env", "fake-goal", "--her", "1", "--normalize_obs", "1",
            "--n_steps", "1", "--max_steps", "50", "--bsize", "256",
            "--episodes_per_cycle", "4", "--train_steps_per_cycle", "40",
            "--random_eps", "0.3"]
    cfg = ExperimentConfig(env="fake-goal", batch_size=256).resolve()
    zero_counts()
    arm = select_projection("auto", batch_size=256, v_min=cfg.v_min,
                            v_max=cfg.v_max, n_atoms=cfg.n_atoms,
                            device=driver.learner_device(cfg)).selected
    stores, restored, closed = [], [], []

    class Store(driver.WeightStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            stores.append(self)

    class RMS(driver.RunningMeanStd):
        def load_state_dict(self, d):
            super().load_state_dict(d)
            restored.append(self.state_dict())

    close = ReplayService.close

    def closing(service):
        norm = service.obs_norm
        closed.append(((*norm.stats(), norm.clip), stores[-1].norm_stats))
        close(service)

    saved = (driver.WeightStore, driver.RunningMeanStd)
    driver.WeightStore, driver.RunningMeanStd = Store, RMS
    ReplayService.close = closing
    out = {"launches": {}, "own_grad_steps_per_sec": [], "arm": arm}
    try:
        for tag, extra, n_cycles in (("her", [], 2),
                                     ("her_resume", ["--resume", "1"], 1)):
            result, counts, own, cycles, wall = _driver_run(
                hooks, driver, tag, argv + ["--n_cycles", str(n_cycles),
                                            *extra], runs)
            steps = 40 * len(own)
            want = {k: steps if k in fused_kernels(arm) else 0
                    for k in counts}
            check(counts == want, f"driver {tag}: launches {counts}, "
                  f"expected {want}")
            for k, c in counts.items():
                out["launches"][k] = out["launches"].get(k, 0) + c
            out["own_grad_steps_per_sec"] += own
            for i, m in enumerate(cycles):
                print(f"[driver {tag}] step {40 * (i + 1)}: own "
                      f"{own[i] if i < len(own) else '-'} grad-steps/s, "
                      f"env_steps_per_sec {m.get('env_steps_per_sec')}, "
                      f"success_rate {m.get('success_rate')}, "
                      f"avg_test_reward {m.get('avg_test_reward')} ({card})")
            print(f"[driver {tag}] {wall:.2f} s, arm {arm!r}, launches "
                  f"{counts}")
            (norm_now, published), = closed
            closed.clear()
            check(published is not None and len(published) == 3 and all(
                np.array_equal(a, b) for a, b in zip(norm_now, published)),
                f"driver {tag}: the last publish carries the service "
                "normalizer's (mean, std, clip)")
            if tag == "her":
                run_dir = runs / ExperimentConfig(
                    env="fake-goal", her=True, n_steps=1).run_name()
                mgr = CheckpointManager(str(run_dir / "ckpt"))
                saved_count = torch.load(
                    mgr._path(mgr.latest_step),
                    weights_only=True)["extra"]["obs_norm"]["count"]
        (resumed,) = restored
        check(resumed["count"] == saved_count > 0,
              f"her resume: normalizer count {resumed['count']} restored, "
              f"{saved_count} saved")
        print(f"her resume: the normalizer came back at count "
              f"{resumed['count']} (saved {saved_count})")
    finally:
        driver.WeightStore, driver.RunningMeanStd = saved
        ReplayService.close = close
    return out


def compute_app_pids() -> list[int]:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


class CpuMeter:
    """CPU seconds (``time.thread_time``) spent inside the functions it
    wraps, summed per name over every thread that calls them."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._lock = threading.Lock()

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.thread_time()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.thread_time() - t0
                with self._lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + dt
        return timed

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self.seconds)


def phase_remote_driver(card: str, hooks: DriverHooks) -> dict:
    """Remote actors through ``train.main``: ``point --serve 1
    --actor_procs 2 --n_workers 0`` for three cycles (every row from the
    spawned ``actor_main`` children over TCP), then ``fake-goal --her 1
    --normalize_obs 1 --actor_procs 1``. Per run: rows from each child,
    a weight pull answered to each child after the first grad publish,
    the arm's kernels and the descent once per grad step, and on the
    card's process list the learner and no child; HER: the learner's
    env_steps below its rows (the relabels' count flag). Per cycle, where
    the learner's host goes: the CPU its process takes (cores), the share
    of its grad-step span the learner's thread is on a core, and the
    cores the receiver's frame decoding and the commit thread's inserts
    take; the ``point`` run's second cycle is profiled for the device's
    busy share."""
    import os
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.distributed import transport
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.ops.autotune import select_projection

    runs = ROOT / "runs" / "chip_smoke_remote"
    shutil.rmtree(runs, ignore_errors=True)
    planes = []
    meter = CpuMeter()

    def tick(service):
        return (time.perf_counter(), len(service), time.process_time(),
                meter.snapshot())

    class Planes(driver.RemotePlanes):
        def __init__(self, cfg, service, weights):
            self.service = service
            # the card's compute apps before any child exists: the
            # learner's context alone
            self.apps_before = compute_app_pids()
            self.rows, self.served = {}, {}
            super().__init__(cfg, service, weights)
            self.ticks = [tick(service)]
            self.apps = None
            planes.append(self)

        def supervise(self):
            if self.apps is None:  # children alive: who holds the card
                self.apps = (compute_app_pids(),
                             [p.pid for p in self.procs if p is not None])
            self.ticks.append(tick(self.service))
            super().supervise()

        def close(self):
            self.rows = self.service.rows_by_actor()
            if self.weight_server is not None:
                self.served = dict(self.weight_server.served_versions)
            super().close()

    saved = (driver.RemotePlanes, transport.decode_frame,
             ReplayService._insert_group)
    driver.RemotePlanes = Planes
    transport.decode_frame = meter.wrap("decode", saved[1])
    ReplayService._insert_group = meter.wrap("commit", saved[2])
    out = {"launches": {}, "runs": {}}
    try:
        for tag, argv, children in (
                ("remote_point", ["--env", "point", "--serve", "1",
                                  "--actor_procs", "2", "--n_workers", "0",
                                  "--n_cycles", "3"], 2),
                ("remote_her", ["--env", "fake-goal", "--her", "1",
                                "--normalize_obs", "1", "--n_steps", "1",
                                "--max_steps", "50", "--actor_procs", "1",
                                "--n_workers", "0", "--n_cycles", "2"], 1)):
            env = argv[1]
            cfg = ExperimentConfig(env=env).resolve()
            arm = select_projection(
                "auto", batch_size=cfg.batch_size, v_min=cfg.v_min,
                v_max=cfg.v_max, n_atoms=cfg.n_atoms,
                device=driver.learner_device(cfg)).selected
            result, counts, own, cycles, wall = _driver_run(
                hooks, driver, tag, argv, runs / tag,
                profiled=env == "point")
            (pl,) = planes
            planes.clear()
            steps = 40 * len(own)
            check(steps > 0, f"driver {tag}: grad steps ran")
            want = {k: steps if k in fused_kernels(arm) else 0
                    for k in counts}
            check(counts == want, f"driver {tag}: launches {counts}, "
                  f"expected {want}")
            for k, c in counts.items():
                out["launches"][k] = out["launches"].get(k, 0) + c
            ids = [f"proc-{i}" for i in range(children)]
            check(all(pl.rows.get(i, 0) > 0 for i in ids),
                  f"driver {tag}: rows from {ids} ({pl.rows})")
            fresh = [peer for peer, v in pl.served.items() if v >= 2]
            check(len(fresh) >= children,
                  f"driver {tag}: a pull of a grad-step publish answered "
                  f"to each child (served {pl.served})")
            pids, child_pids = pl.apps
            me = os.getpid()
            # nvidia-smi may report pids of another pid namespace than
            # this process's (a container): then the learner's own entry
            # is the one listed before the children were spawned, and a
            # child holding a context would add an entry
            print(f"[driver {tag}] compute apps on the card before the "
                  f"children {pl.apps_before}, with them alive {pids}; "
                  f"learner pid {me}, children {child_pids}")
            check(len(pl.apps_before) == 1 and pids == pl.apps_before
                  and not set(child_pids) & set(pids),
                  f"driver {tag}: the learner and no child on the card "
                  f"(before {pl.apps_before}, during {pids})")
            rows = sum(pl.rows.values())
            if env == "fake-goal":
                check(result["env_steps"] < rows,
                      f"driver {tag}: env_steps {result['env_steps']} "
                      f"below the rows {rows} (relabels uncounted)")
            pairs = list(zip(pl.ticks, pl.ticks[1:]))
            rates = [(b[1] - a[1]) / (b[0] - a[0]) for a, b in pairs]
            # CPU seconds per wall second of each cycle: cores taken
            cores = {name: [(b[3].get(name, 0.0) - a[3].get(name, 0.0))
                            / (b[0] - a[0]) for a, b in pairs]
                     for name in ("decode", "commit")}
            cores["process"] = [(b[2] - a[2]) / (b[0] - a[0])
                                for a, b in pairs]
            on_core = [c / w for c, w in zip(hooks.cpu_spans, hooks.spans)]
            busy = None
            if hooks.device_events is not None and hooks.window_s:
                busy = sum(e.self_device_time_total
                           for e in hooks.device_events) / 1e6 \
                    / hooks.window_s
            print(f"[driver {tag}] {wall:.2f} s, arm {arm!r}; own "
                  f"grad-steps/s {[round(x, 2) for x in own]}; rows/s "
                  f"received per cycle {[round(x, 1) for x in rates]}; "
                  f"rows {pl.rows}, env_steps {result['env_steps']}; "
                  f"weight versions served {pl.served}; launches {counts} "
                  f"({card})")
            print(f"[driver {tag}] per cycle: learner process "
                  f"{[round(x, 3) for x in cores['process']]} cores; frame "
                  f"decoding {[round(x, 3) for x in cores['decode']]} "
                  f"cores; commit thread "
                  f"{[round(x, 3) for x in cores['commit']]} cores; the "
                  f"learner's thread on a core "
                  f"{[round(x, 3) for x in on_core]} of its grad-step "
                  f"span; device busy share of cycle 2 "
                  f"{'not measured' if busy is None else round(busy, 4)} "
                  f"({card})")
            out["runs"][tag] = {"own_grad_steps_per_sec": own,
                                "rows_per_sec": rates, "cores": cores,
                                "learner_on_core": on_core,
                                "device_busy_share": busy}
    finally:
        (driver.RemotePlanes, transport.decode_frame,
         ReplayService._insert_group) = saved
    return out


# --- the sharded ingest plane and the v2 weight plane (phase 20) ---------

SHARDED_CAP, SHARDED_BLOCK = 8192, 1024


def phase_sharded_ingest(dev) -> None:
    """20a: the same ragged batches through three services, in rounds
    that wrap the 8,192-row ring: adds, a flush, a block staged, more adds
    pushed while it is in flight, a flush, the commit and a drain. The K =
    2 service on the card (two shard workers staging into two rings,
    merged in ticket order) must leave the storage, the sum and min trees
    and the row ledger of the K = 1 service on the card and on the CPU."""
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    rng = np.random.default_rng(20)
    rounds = [[random_rows(rng, int(n)) for n in rng.integers(1, 900, 6)]
              for _ in range(4)]
    total = sum(b.obs.shape[0] for batches in rounds for b in batches)

    def run(where, shards):
        buf = FusedDeviceReplay(SHARDED_CAP, OBS, ACT, device=where,
                                block_rows=SHARDED_BLOCK, ingest_shards=shards)
        svc = ReplayService(buf, num_ingest_shards=shards)
        try:
            check(svc._direct_stage == (shards > 1),
                  f"sharded ingest: direct stage at K = {shards}")
            for batches in rounds:
                half = len(batches) // 2
                for i, b in enumerate(batches):
                    if i == half:
                        svc.flush()
                        check(svc.ingest_stage() > 0,
                              "sharded ingest: a block in flight")
                    # from here on pushed while the block is in flight
                    svc.add(b, actor_id=f"a{i % 2}", shard=i % shards)
                svc.flush()
                svc.ingest_commit()
                svc.drain_device()
            stats = svc.ingest_stats()
        finally:
            svc.close()
        return buf, stats

    t0 = time.perf_counter()
    runs = {tag: run(where, k) for tag, where, k in (
        ("card K=2", dev, 2), ("card K=1", dev, 1), ("cpu K=1", "cpu", 1))}
    torch.cuda.synchronize()
    ref, ref_stats = runs["cpu K=1"]
    for tag, (buf, stats) in runs.items():
        check((buf.size, buf.head) == (ref.size, ref.head),
              f"sharded ingest {tag}: size and head")
        for name, a, b in zip(("obs", "action", "reward", "next_obs", "done",
                               "discount"), buf.storage, ref.storage):
            check(torch.equal(a[:SHARDED_CAP].cpu(), b[:SHARDED_CAP]),
                  f"sharded ingest {tag}: storage {name} bitwise the CPU's")
        for name, a, b in zip(("sum_tree", "min_tree", "max_priority"),
                              buf.trees, ref.trees):
            check(torch.equal(a.cpu(), b),
                  f"sharded ingest {tag}: {name} bitwise the CPU's")
        ledger = (stats["rows_committed"], stats["env_steps"],
                  sum(p["rows_in"] for p in stats["per_shard"]))
        check(ledger == (total, total, total),
              f"sharded ingest {tag}: row ledger {ledger}, {total} rows")
        staged = sum(p["staged_rows"] for p in stats["per_shard"])
        check(staged == (total if tag == "card K=2" else 0),
              f"sharded ingest {tag}: {staged} rows direct-staged")
    per_shard = [p["rows_in"] for p in runs["card K=2"][1]["per_shard"]]
    print(f"sharded ingest on the card: {total} rows in {len(rounds)} rounds "
          f"(a {SHARDED_CAP}-row ring wrapped, size {ref.size}, head "
          f"{ref.head}); K = 2 (rows per shard {per_shard}) bitwise K = 1 on "
          f"the card and on the CPU, pushes while a block was in flight "
          f"included; {time.perf_counter() - t0:.2f} s")


def phase_weight_plane(dev, card: str) -> dict:
    """20b: the driver's actor (``point``, hidden 256x3) published from
    the card (``to_host=False``), then again after 40 grad steps. Per
    codec, a v2 client pulls the full frame and the delta over a socket;
    its reconstruction must be bitwise a fresh full pull's, and the
    delta and quantization oracles must hold. Bytes per frame, and the
    median of 5 timings of encode (a fill of the server's frame with the
    version's encoded flat dropped), decode (npz load, delta apply,
    dequantize, torch tensors) and the delta apply alone."""
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.distributed import weight_plane as wp
    from d4pg_tpu_torch.distributed.weight_server import _unflatten
    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.io.from_jax import torch_layout
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.learner.update import update_step
    from d4pg_tpu_torch.replay.uniform import TransitionBatch
    from d4pg_tpu_torch.train import infer_dims

    cfg = ExperimentConfig(env="point").resolve()
    obs_dim, act_dim, _ = infer_dims(cfg)
    config = cfg.learner_config(obs_dim, act_dim, device=dev)
    state = init_state(config, 0, dev)
    g = torch.Generator(device=dev).manual_seed(20)
    batch = TransitionBatch(
        obs=torch.randn(64, obs_dim, device=dev, generator=g),
        action=torch.rand(64, act_dim, device=dev, generator=g) * 2 - 1,
        reward=torch.randn(64, device=dev, generator=g),
        next_obs=torch.randn(64, obs_dim, device=dev, generator=g),
        done=torch.zeros(64, device=dev),
        discount=torch.full((64,), 0.99, device=dev))
    store = WeightStore()
    server = wp.WeightPlaneServer(store, window=4)
    clients = {c: wp.WeightPlaneClient("127.0.0.1", server.port, codec=c,
                                       connect_timeout=10.0)
               for c in wp.CODECS}
    out: dict = {}

    def median_ms(fn, n=5):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[n // 2]

    def decode(payload, base):
        with np.load(__import__("io").BytesIO(payload)) as z:
            entries = {k: z[k] for k in z.files if not k.startswith("__")}
            for k in ("__same__", "__dropped__"):
                if k in z.files:
                    entries[k] = z[k]
        enc = (wp.delta_apply(base, entries) if "__same__" in entries
               else {k[2:]: v for k, v in entries.items() if k[:2] == "t:"})
        flat = wp.decode_flat(enc)
        for k in ("__norm_mean__", "__norm_std__", "__norm_clip__"):
            flat.pop(k, None)
        return {k: torch.from_numpy(np.array(v)) for k, v in
                torch_layout(_unflatten(flat)["params"]).items()}

    try:
        store.publish(state.actor, step=0, to_host=False)
        for c in clients.values():
            check(c.get_if_newer() is not None, "weight plane: full pull")
        for _ in range(40):
            update_step(config, state, batch)
        store.publish(state.actor, step=40, to_host=False)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in state.actor.state_dict().values())
        for codec, c in clients.items():
            got = c.get_if_newer()
            check(got is not None and c.counters["delta_frames"] == 1,
                  f"weight plane {codec}: a delta pull")
            fresh = wp.WeightPlaneClient("127.0.0.1", server.port,
                                         codec=codec, connect_timeout=10.0)
            full = fresh.get_if_newer()
            fresh.close()
            check(full is not None and set(full[1]) == set(got[1])
                  and all(torch.equal(full[1][k], got[1][k])
                          for k in got[1]),
                  f"weight plane {codec}: the delta reconstruction is "
                  "bitwise the full snapshot")
            if codec == "f32":
                check(all(torch.equal(got[1][k], v.cpu()) for k, v in
                          state.actor.state_dict().items()),
                      "weight plane f32: bitwise the learner's actor")
            row = {}
            with server._frame_lock:
                server._refresh_locked()
                gen, version = server._latest
                base_enc = server._encoded_locked(gen, version - 1, codec)
                for kind, base in (("full", -1), ("delta", version - 1)):
                    def fill():
                        server._enc.pop((gen, version, codec), None)
                        server._frames.pop((gen, version, codec, base), None)
                        return server._frame_locked(gen, version, codec,
                                                    base)[0]
                    row[f"{kind}_encode_ms"] = median_ms(fill)
                    payload = fill()
                    row[f"{kind}_bytes"] = len(payload)
                    row[f"{kind}_decode_ms"] = median_ms(
                        lambda: decode(payload, base_enc))
                    if kind == "delta":
                        with np.load(__import__("io").BytesIO(payload)) as z:
                            entries = {k: z[k] for k in z.files
                                       if not k.startswith("__")
                                       or k in ("__same__", "__dropped__")}
                        row["delta_apply_ms"] = median_ms(
                            lambda: wp.delta_apply(base_enc, entries))
            out[codec] = row
        stats = server.weight_stats()
        check(stats["oracle_delta_failures"] == 0
              and stats["oracle_quant_failures"] == 0
              and stats["oracle_delta_checks"] >= 3
              and stats["oracle_quant_checks"] >= 2,
              f"weight plane: the oracles hold ({stats})")
    finally:
        for c in clients.values():
            c.close()
        server.close()
    for codec, row in out.items():
        print(f"weight plane [{codec}] the driver's actor ({n_params} "
              f"parameters): full {row['full_bytes']} B, encode "
              f"{row['full_encode_ms']:.3f} ms, decode "
              f"{row['full_decode_ms']:.3f} ms; delta after 40 grad steps "
              f"{row['delta_bytes']} B, encode {row['delta_encode_ms']:.3f} "
              f"ms, decode {row['delta_decode_ms']:.3f} ms, apply "
              f"{row['delta_apply_ms']:.3f} ms ({card})")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded_driver(card: str, hooks: DriverHooks, remote: dict) -> dict:
    """20c: ``train.main --env point --serve 1 --ingest_shards 2
    --actor_procs 2 --n_workers 0 --trace_sample 0.05`` on fixed free
    ports for three cycles (the second profiled), beside one external
    ``python -m d4pg_tpu_torch.actor_main --codec raw --weight_codec bf16
    --trace_sample 0.1`` process with no card visible. Asserted: the
    receiver's two listeners share the port (``reuseport``); no shed,
    refused admission, decode error or order break; no orphaned ingest
    trace (a weight frame served to the external process ends in that
    process's recorder, so those are counted apart); the arm's kernels
    and the descent once per grad step; one compute app on the card."""
    import os
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.distributed import weight_plane
    from d4pg_tpu_torch.obs.registry import REGISTRY
    from d4pg_tpu_torch.obs.trace import RECORDER
    from d4pg_tpu_torch.ops.autotune import select_projection

    runs = ROOT / "runs" / "chip_smoke_sharded"
    shutil.rmtree(runs, ignore_errors=True)
    runs.mkdir(parents=True)
    t_port, w_port = _free_port(), _free_port()
    planes, served_tids = [], set()
    respond = weight_plane.WeightPlaneServer._respond

    def responding(server, *args):
        resp, tid, version = respond(server, *args)
        if tid is not None:
            served_tids.add(tid)
        return resp, tid, version

    def tick(service):
        stats = service.ingest_stats()
        return (time.perf_counter(),
                [p["rows_in"] for p in stats["per_shard"]])

    class Planes(driver.RemotePlanes):
        def __init__(self, cfg, service, weights):
            self.service = service
            self.apps_before = compute_app_pids()
            self.external = None
            super().__init__(cfg, service, weights)
            self.ticks = [tick(service)]
            self.apps = None
            planes.append(self)

        def _spawn(self, i):
            if self.external is None:  # the servers are up: start it once
                self.external_log = open(runs / "external_actor.log", "w")
                self.external = subprocess.Popen(
                    [sys.executable, "-m", "d4pg_tpu_torch.actor_main",
                     "--learner_host", "127.0.0.1", "--transitions_port",
                     str(self.receiver.port), "--weights_port",
                     str(self.weight_server.port), "--env", "point",
                     "--actor_id", "ext-0", "--seed", "7", "--codec", "raw",
                     "--weight_codec", "bf16", "--trace_sample", "0.1",
                     "--expect_generation", "1"],
                    cwd=ROOT, stdout=self.external_log,
                    stderr=subprocess.STDOUT,
                    env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                         "PYTHONPATH": str(ROOT)})
            return super()._spawn(i)

        def supervise(self):
            if self.apps is None:
                self.apps = compute_app_pids()
            self.ticks.append(tick(self.service))
            super().supervise()

        def close(self):
            self.rows = self.service.rows_by_actor()
            self.stats = self.service.ingest_stats()
            self.reuseport = self.receiver.reuseport
            self.plane_stats = self.weight_server.weight_stats()
            if self.external is not None:
                self.external_alive = self.external.poll() is None
                self.external.terminate()
                self.external.wait(timeout=30)
                self.external_log.close()
            super().close()

    argv = ["--env", "point", "--serve", "1", "--ingest_shards", "2",
            "--actor_procs", "2", "--n_workers", "0", "--n_cycles", "3",
            "--trace_sample", "0.05", "--serve_transitions_port",
            str(t_port), "--serve_weights_port", str(w_port)]
    cfg = ExperimentConfig(env="point").resolve()
    arm = select_projection("auto", batch_size=cfg.batch_size,
                            v_min=cfg.v_min, v_max=cfg.v_max,
                            n_atoms=cfg.n_atoms,
                            device=driver.learner_device(cfg)).selected
    saved = (driver.RemotePlanes, weight_plane.WeightPlaneServer._respond)
    driver.RemotePlanes = Planes
    weight_plane.WeightPlaneServer._respond = responding
    RECORDER.reset()
    REGISTRY.histogram("weights.staleness_ms").reset()
    try:
        result, counts, own, cycles, wall = _driver_run(
            hooks, driver, "sharded", argv, runs, profiled=True)
        latency = RECORDER.latency_block()
        orphans = [t for t in RECORDER.orphans() if t not in served_tids]
        staleness = REGISTRY.histogram("weights.staleness_ms").snapshot_dict()
    finally:
        driver.RemotePlanes, weight_plane.WeightPlaneServer._respond = saved
        RECORDER.disable()
    (pl,) = planes
    steps = 40 * len(own)
    check(steps == 120, f"driver sharded: {steps} grad steps timed")
    want = {k: steps if k in fused_kernels(arm) else 0 for k in counts}
    check(counts == want, f"driver sharded: launches {counts}, expected "
          f"{want}")
    check(pl.reuseport, "driver sharded: two listeners on one port "
          "(SO_REUSEPORT)")
    st = pl.stats
    for key in ("sheds", "admit_fails", "decode_errors", "order_breaks"):
        check(st[key] == 0, f"driver sharded: {key} {st[key]}")
    check(not orphans, f"driver sharded: {len(orphans)} ingest traces "
          "orphaned")
    check(latency["completed"] > 0 and latency["wire_to_grad"]["n"] > 0,
          f"driver sharded: traced frames reached a grad step ({latency})")
    ids = ["proc-0", "proc-1", "ext-0"]
    check(all(pl.rows.get(i, 0) > 0 for i in ids),
          f"driver sharded: rows from {ids} ({pl.rows})")
    check(pl.external_alive, "driver sharded: the external actor ran to "
          "the end")
    w = pl.plane_stats
    check(w["frames_full"] >= 1 and w["oracle_delta_failures"] == 0
          and w["oracle_quant_failures"] == 0,
          f"driver sharded: v2 frames served, the oracles hold ({w})")
    check(len(pl.apps_before) == 1 and pl.apps == pl.apps_before,
          f"driver sharded: the learner and no child on the card (before "
          f"{pl.apps_before}, during {pl.apps})")
    pairs = list(zip(pl.ticks, pl.ticks[1:]))
    per_shard = [[(b[1][i] - a[1][i]) / (b[0] - a[0]) for i in range(2)]
                 for a, b in pairs]
    base = remote["runs"]["remote_point"]
    ratio = [x / y for x, y in zip(own, base["own_grad_steps_per_sec"])]
    on_core = [c / s for c, s in zip(hooks.cpu_spans, hooks.spans)]
    cpu_ms = [1e3 * c / 40 for c in hooks.cpu_spans]
    base_cpu_ms = [1e3 * c / g for c, g in zip(
        base["learner_on_core"], base["own_grad_steps_per_sec"])]
    busy = None
    if hooks.device_events is not None and hooks.window_s:
        busy = sum(e.self_device_time_total for e in hooks.device_events) \
            / 1e6 / hooks.window_s
    stage_ms = {k: v["p50"] for k, v in latency["stages"].items()
                if v["n"]}
    print(f"[driver sharded] {wall:.2f} s, arm {arm!r}; own grad-steps/s "
          f"{[round(x, 2) for x in own]}, ratio to 19a's "
          f"{[round(x, 3) for x in ratio]}; rows/s per shard per cycle "
          f"{[[round(x, 1) for x in c] for c in per_shard]}; rows "
          f"{pl.rows}; launches {counts} ({card})")
    print(f"[driver sharded] the learner's thread: on a core "
          f"{[round(x, 3) for x in on_core]} of its grad-step span, "
          f"{[round(x, 2) for x in cpu_ms]} ms of CPU per grad step (19a: "
          f"{[round(x, 2) for x in base_cpu_ms]}); device busy share of "
          f"cycle 2 {'not measured' if busy is None else round(busy, 4)} "
          f"({card})")
    print(f"[driver sharded] weight plane: frames full {w['frames_full']}, "
          f"delta {w['frames_delta']}, not newer {w['frames_not_newer']}, "
          f"v1 {w['frames_v1']}; bytes full {w['bytes_full']}, delta "
          f"{w['bytes_delta']}; delta hit rate {w['delta_hit_rate']}; "
          f"staleness p50 {staleness['p50']} ms, p99 {staleness['p99']} ms "
          f"over {staleness['count']} frames ({card})")
    print(f"[driver sharded] traces: {latency['n_traces']} ({len(served_tids)}"
          f" weight frames served to other processes), completed "
          f"{latency['completed']}, shed {latency['shed']}, ingest orphans "
          f"{len(orphans)}; wire_to_grad {latency['wire_to_grad']}; stage "
          f"p50 ms {stage_ms} ({card})")
    return {"launches": counts, "own_grad_steps_per_sec": own,
            "ratio_to_19a": ratio, "rows_per_sec_per_shard": per_shard,
            "learner_on_core": on_core, "cpu_ms_per_grad_step": cpu_ms,
            "device_busy_share": busy, "weights": w,
            "staleness_ms": staleness, "latency": latency}


# --- the serving plane and the sample-on-ingest dealt plane (21-22) ------

SERVE_LANES, SERVE_ROWS, SERVE_REQUESTS, SERVE_WARMUP = 8, 32, 200, 10


def _serving_pass(dev, store, actor, chaos=None) -> dict:
    """8 lanes of 32 rows, each sending ``SERVE_WARMUP`` untimed requests
    then ``SERVE_REQUESTS`` timed ones to a ``PolicyInferenceServer`` on
    the card (the clients share this process with the server); every
    timed response held against ``act_deterministic`` on the card (atol
    1e-5)."""

    from d4pg_tpu_torch.learner.update import act_deterministic
    from d4pg_tpu_torch.serving import (
        ActorConfig,
        PolicyInferenceServer,
        RemotePolicyClient,
    )

    server = PolicyInferenceServer(
        config("pallas_ce"), store, batch_window_s=0.002,
        max_batch_rows=SERVE_LANES * SERVE_ROWS, device="default",
        learner_device=dev, chaos=chaos)
    clients = [RemotePolicyClient(
        config("pallas_ce"), ActorConfig(), "127.0.0.1", server.port,
        lane_id=i, seed=i, timeout=5.0, weights=store, record_ledger=True)
        for i in range(SERVE_LANES)]
    rng = np.random.default_rng(21)
    obs = [rng.standard_normal((SERVE_REQUESTS, SERVE_ROWS, OBS)).astype(
        np.float32) for _ in range(SERVE_LANES)]
    got = [[None] * SERVE_REQUESTS for _ in range(SERVE_LANES)]
    lat = [[] for _ in range(SERVE_LANES)]
    start = []
    # every lane warms up (its connection, the server's first buckets)
    # before the timed requests start together
    barrier = threading.Barrier(
        SERVE_LANES, action=lambda: start.append(time.perf_counter()))
    lanes = _Threads(on_error=barrier.abort)

    def lane(i):
        for r in range(SERVE_WARMUP):
            clients[i].greedy_actions(obs[i][r])
        barrier.wait()
        for r in range(SERVE_REQUESTS):
            t0 = time.perf_counter()
            got[i][r] = clients[i].greedy_actions(obs[i][r])
            lat[i].append(1e3 * (time.perf_counter() - t0))

    try:
        deadline = time.monotonic() + 30.0
        while server.serving_stats()["version"] == 0:
            check(time.monotonic() < deadline, "serving: the server adopts")
            time.sleep(0.01)
        for i in range(SERVE_LANES):
            lanes.start(lane, i)
        lanes.join(timeout=300)
        check(not any(t.is_alive() for t in lanes.threads),
              "serving: every lane finished")
        wall = time.perf_counter() - start[0]
        stats = server.serving_stats()
        client_stats = [c.stats() for c in clients]
        accepted = set().union(*[c.accepted_req_ids for c in clients])
    finally:
        for c in clients:
            c.close()
        server.close()
    worst = 0.0
    for i in range(SERVE_LANES):
        want = act_deterministic(actor, torch.from_numpy(
            obs[i].reshape(-1, OBS)).to(dev)).cpu().numpy().reshape(
            SERVE_REQUESTS, SERVE_ROWS, ACT)
        for r in range(SERVE_REQUESTS):
            worst = max(worst, float(np.abs(got[i][r] - want[r]).max()))
    flat = sorted(x for lane_ms in lat for x in lane_ms)
    return {"stats": stats, "clients": client_stats, "wall_s": wall,
            "requests_per_s": SERVE_LANES * SERVE_REQUESTS / wall,
            "p50_ms": flat[len(flat) // 2],
            "p99_ms": flat[int(0.99 * (len(flat) - 1))],
            "max_abs_err": worst, "accepted": accepted}


def phase_serving(dev, card: str) -> dict:
    """21a: ``PolicyInferenceServer(device='default')`` on the card at
    Humanoid width, 8 lanes of 32 rows: responses equal to
    ``act_deterministic`` on the card within 1e-5, no fallback, timeout
    or tear on any client; requests/s, client latency p50 and p99, the
    bucket occupancy and the adoptions. Then a pass under
    ``ServingChaos(torn_response_rate=0.1)``: each tear rejected and
    counted, a fallback for each, nothing torn acted on."""
    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.serving import ServingChaos

    state = init_state(config("pallas_ce"), 0, dev)
    store = WeightStore()
    store.publish(state.actor, step=1)
    out = {}
    for tag, chaos in (("healthy", None),
                       ("chaos", ServingChaos(torn_response_rate=0.1,
                                              seed=3))):
        res = _serving_pass(dev, store, state.actor, chaos)
        st, cs = res["stats"], res["clients"]
        torn = sum(c["torn_rejected"] for c in cs)
        fallbacks = sum(c["fallbacks"] for c in cs)
        if chaos is None:
            check(res["max_abs_err"] <= 1e-5,
                  f"serving: responses within 1e-5 of act_deterministic "
                  f"({res['max_abs_err']})")
            for c in cs:
                check(c["fallbacks"] == c["timeouts"] == c["torn_rejected"]
                      == c["wire_errors"] == 0 and c["served"]
                      == SERVE_REQUESTS + SERVE_WARMUP,
                      f"serving: a healthy client {c}")
        else:
            check(torn == chaos.torn_injected > 0 and fallbacks == torn,
                  f"serving chaos: {torn} tears rejected of "
                  f"{chaos.torn_injected}, {fallbacks} fallbacks")
            check(not chaos.torn_req_ids & res["accepted"],
                  "serving chaos: nothing torn acted on")
            check(res["max_abs_err"] <= 1e-5, "serving chaos: fallback and "
                  f"served actions within 1e-5 ({res['max_abs_err']})")
        print(f"[serving {tag}] {res['requests_per_s']:.1f} requests/s "
              f"({SERVE_LANES} lanes x {SERVE_ROWS} rows), client latency "
              f"p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms; "
              f"batches {st['batches']}, occupancy "
              f"{st['batch_occupancy']}, batch rows p50 "
              f"{st['batch_rows']['p50']}, adoptions {st['adoptions']}, "
              f"server latency {st['latency_ms']}; tears {torn}, "
              f"fallbacks {fallbacks}; max abs err "
              f"{res['max_abs_err']:.3g} ({card})")
        out[tag] = {k: v for k, v in res.items() if k != "accepted"}
    return out


def _interrupt(procs, timeout=60.0) -> None:
    import signal

    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def phase_serving_driver(card: str, hooks: DriverHooks, remote: dict | None
                         ) -> dict:
    """21b: ``train.main --env point --serve 1 --serve_policy 1
    --n_workers 0`` for three cycles on fixed free ports, beside two
    external ``actor_main --policy_port`` children (no card visible)
    started once the policy server has adopted the learner's weights and
    stopped before it closes. Asserted: every client served all its
    requests (no fallback, timeout or tear), rows from both children, the
    arm's kernels and the descent once per grad step, one compute app.
    Printed: own grad-steps/s against 19a's in the same call, rows/s, the
    clients' and the server's stats."""
    import ast
    import os
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.ops.autotune import select_projection
    from d4pg_tpu_torch.serving import server as server_mod

    runs = ROOT / "runs" / "chip_smoke_serving"
    shutil.rmtree(runs, ignore_errors=True)
    runs.mkdir(parents=True)
    ports = [_free_port() for _ in range(3)]
    children, logs, servers, seen = [], [], [], {}
    spawner = _Threads()
    base = server_mod.PolicyInferenceServer

    def spawn_children():
        srv = servers[0]
        deadline = time.monotonic() + 120.0
        while srv.serving_stats()["version"] == 0:
            if time.monotonic() > deadline:
                return
            time.sleep(0.01)
        for i in range(2):
            log = open(runs / f"policy_actor_{i}.log", "w")
            logs.append(log)
            children.append(subprocess.Popen(
                [sys.executable, "-m", "d4pg_tpu_torch.actor_main",
                 "--learner_host", "127.0.0.1", "--transitions_port",
                 str(ports[0]), "--weights_port", str(ports[1]),
                 "--policy_port", str(ports[2]), "--policy_timeout", "5.0",
                 "--env", "point", "--actor_id", f"pol-{i}", "--seed",
                 str(31 + i)], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT,
                env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                     "PYTHONPATH": str(ROOT)}))

    class Server(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)
            seen["apps_before"] = compute_app_pids()
            spawner.start(spawn_children, daemon=True)

        def close(self):
            # the children stop (and report their clients) first
            seen["apps"] = compute_app_pids()
            seen["stats"] = self.serving_stats()
            _interrupt(children)
            super().close()

    class Planes(driver.RemotePlanes):
        def __init__(self, cfg, service, weights):
            self.service = service
            super().__init__(cfg, service, weights)
            self.ticks = [(time.perf_counter(), len(service))]

        def supervise(self):
            self.ticks.append((time.perf_counter(), len(self.service)))
            super().supervise()

        def close(self):
            seen["rows"] = self.service.rows_by_actor()
            seen["ticks"] = self.ticks
            super().close()

    cfg = ExperimentConfig(env="point").resolve()
    arm = select_projection("auto", batch_size=cfg.batch_size,
                            v_min=cfg.v_min, v_max=cfg.v_max,
                            n_atoms=cfg.n_atoms,
                            device=driver.learner_device(cfg)).selected
    argv = ["--env", "point", "--serve", "1", "--serve_policy", "1",
            "--n_workers", "0", "--n_cycles", "3",
            "--serve_transitions_port", str(ports[0]),
            "--serve_weights_port", str(ports[1]),
            "--serve_policy_port", str(ports[2])]
    saved = (server_mod.PolicyInferenceServer, driver.RemotePlanes)
    server_mod.PolicyInferenceServer, driver.RemotePlanes = Server, Planes
    try:
        result, counts, own, cycles, wall = _driver_run(
            hooks, driver, "serving", argv, runs)
    finally:
        server_mod.PolicyInferenceServer, driver.RemotePlanes = saved
        spawner.join(timeout=120.0, reraise=False)
        _interrupt(children)
        for log in logs:
            log.close()
    spawner.reraise()
    steps = 40 * len(own)
    check(steps == 120, f"driver serving: {steps} grad steps timed")
    want = {k: steps if k in fused_kernels(arm) else 0 for k in counts}
    check(counts == want, f"driver serving: launches {counts}, expected "
          f"{want}")
    client_stats = []
    for i in range(2):
        text = (runs / f"policy_actor_{i}.log").read_text()
        lines = [ln for ln in text.splitlines() if "policy client:" in ln]
        check(len(lines) == 1, f"driver serving: child {i} reported its "
              f"client ({text[-2000:]})")
        client_stats.append(ast.literal_eval(lines[0].split(": ", 1)[1]))
    for c in client_stats:
        # the SIGINT that stops a child may land inside its last round
        # trip: that one request is counted and never answered
        check(c["fallbacks"] == c["timeouts"] == c["torn_rejected"] == 0
              and c["wire_errors"] == c["warmup_fallbacks"] == 0
              and c["requests"] - 1 <= c["served"] <= c["requests"]
              and c["served"] > 0,
              f"driver serving: a healthy child's client {c}")
    check(all(seen["rows"].get(f"pol-{i}", 0) > 0 for i in range(2)),
          f"driver serving: rows from both children ({seen['rows']})")
    check(len(seen["apps_before"]) == 1
          and seen["apps"] == seen["apps_before"],
          f"driver serving: the learner and no child on the card "
          f"({seen['apps_before']}, {seen['apps']})")
    ticks = seen["ticks"]
    rates = [(b[1] - a[1]) / (b[0] - a[0]) for a, b in zip(ticks, ticks[1:])]
    base19 = (remote["runs"]["remote_point"]["own_grad_steps_per_sec"]
              if remote else None)
    st = seen["stats"]
    print(f"[driver serving] {wall:.2f} s, arm {arm!r}; own grad-steps/s "
          f"{[round(x, 2) for x in own]} (19a in this call: "
          f"{'not run' if base19 is None else [round(x, 2) for x in base19]}"
          f"); rows/s received per cycle {[round(x, 1) for x in rates]}; "
          f"rows {seen['rows']}; launches {counts} ({card})")
    print(f"[driver serving] clients {client_stats}; server: requests "
          f"{st['requests']}, batches {st['batches']}, rows {st['rows']}, "
          f"occupancy p50 {st['batch_occupancy']['p50']}, adoptions "
          f"{st['adoptions']}, latency {st['latency_ms']}, staleness "
          f"{st['staleness_s']} s, sla breaches {st['sla_breaches']} "
          f"({card})")
    return {"launches": counts, "own_grad_steps_per_sec": own,
            "rows_per_sec": rates, "clients": client_stats, "server": st}


DEAL_TICKS, DEAL_ROWS = 24, 4096


def _descent_bytes(tree, mass) -> int:
    """Bytes a descent of ``mass`` must move: every distinct node read on
    the way down (4 B), the masses in and the slots out."""
    levels = int(math.log2(tree.shape[0] // 2))
    node = torch.ones(mass.shape, dtype=torch.int64, device=mass.device)
    p, seen = mass.clone(), []
    for _ in range(levels):
        left = node << 1
        seen.append(left)
        go = p >= tree[left]
        p = torch.where(go, p - tree[left], p)
        node = torch.where(go, left | 1, left)
    return 4 * torch.unique(torch.cat(seen)).numel() + 8 * mass.numel()


def phase_dealer(dev, card: str) -> dict:
    """22a: the device dealer on the card at Humanoid width: a
    200,000-row generation-tracked ring, K = 40, B = 256, the ``pallas``
    arm, against the float32 twin on the card (every field bitwise) and
    on the CPU (slots, rows, generations, beta bitwise; weights within
    1e-6 relative), over ``DEAL_TICKS`` ticks of ``DEAL_ROWS``-row
    inserts each with the previous block's write-back queued; one
    descent launch per deal. Then the descent kernel against its plain
    version at Q = K * B = 10,240 over this ring's tree and at the
    driver's Q = 40 * 64 = 2,560 over 2^20 leaves, bitwise, timed beside
    the plain version and ``searchsorted``. Per deal and per settle: on
    ticks of the third quarter the host's enqueue time (the call's
    return) and the device span of the call queued behind a sleep
    kernel (CUDA events, the host's gaps hidden); on ticks of the last
    quarter, under one profiler session, the sum of the call's kernels
    and copies and their count."""
    from d4pg_tpu_torch.ops import sampler_descent as desc
    from d4pg_tpu_torch.replay.device_sampler import DeviceSampleDealer
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
    from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
    from d4pg_tpu_torch.replay.sampler import SampleDealer
    from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
    from d4pg_tpu_torch.replay.staging import DealtBlockRing

    t0 = time.perf_counter()
    dbuf = FusedDeviceReplay(CAPACITY, OBS, ACT, alpha=0.6, device=dev,
                             gen_tracked=True)
    twins = {"card": PrioritizedReplayBuffer(CAPACITY, OBS, ACT, alpha=0.6,
                                             storage="device", device=dev),
             "cpu": PrioritizedReplayBuffer(CAPACITY, OBS, ACT, alpha=0.6)}
    ring = DealtBlockRing(1)
    dealer = DeviceSampleDealer(CAPACITY, [ring], k=K, batch_size=BATCH,
                                beta_schedule=SharedBetaSchedule(),
                                min_size=BATCH, seed=5, arm="pallas")
    dealer.resync(dbuf)
    tw = {}
    for where, buf in twins.items():
        r = DealtBlockRing(1)
        d = SampleDealer(CAPACITY, [r], n_shards=1, k=K, batch_size=BATCH,
                         beta_schedule=SharedBetaSchedule(), min_size=BATCH,
                         seed=5, scheme="device",
                         weights_device=dev if where == "card" else "cpu")
        d.resync(buf)
        tw[where] = (buf, r, d)
    # per deal and per settle, on the commit thread's own calls (timing
    # only: each waits for the card first). "span" ticks: host enqueue
    # time, and the call's device span behind a 20 ms sleep kernel (kept
    # only when the host queued the whole call before the sleep ended);
    # "trace" ticks: a named range the profiler's kernels are summed under
    samples = {name: {"host": [], "span": [], "device": [], "kernels": []}
               for name in ("deal", "settle")}
    timing = [None]

    def timed(name, fn):
        rec = samples[name]

        def call(*args):
            if timing[0] is None:
                return fn(*args)
            torch.cuda.synchronize()
            if timing[0] == "trace":
                with torch.profiler.record_function(f"dealer.{name}"):
                    return fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(0.02 * 2e9))
            start.record()
            t = time.perf_counter()
            out = fn(*args)
            rec["host"].append(1e3 * (time.perf_counter() - t))
            queued = not start.query()
            end.record()
            end.synchronize()
            if queued:
                rec["span"].append(start.elapsed_time(end))
            return out
        return call

    def kernels_under(event) -> list:
        found = list(event.kernels)
        for child in event.cpu_children:
            found += kernels_under(child)
        return found

    dealer.deal = timed("deal", dealer.deal)
    dbuf.apply_priorities = timed("settle", dbuf.apply_priorities)
    rng = np.random.default_rng(22)
    wb_rng = np.random.default_rng(23)
    launches, deals, worst_w = 0, 0, 0.0
    weights_bitwise_cpu = True
    pending = None
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for tick in range(DEAL_TICKS):
        rows = random_rows(rng, DEAL_ROWS)
        if pending is not None:
            (idx, td, gen), twin_wb = pending
            dealer.queue_writeback(idx, td, gen)
            for where, (tidx, tgen) in twin_wb.items():
                tw[where][2].queue_writeback(tidx, td, tgen)
        zero_counts()
        timing[0] = (None if tick < DEAL_TICKS // 2 else "span"
                     if tick < 3 * DEAL_TICKS // 4 else "trace")
        if tick == 3 * DEAL_TICKS // 4:
            prof.start()
        dealt = dealer.ingest_and_deal([(dbuf.add(rows), tick, None)], dbuf)
        launches += launch_counts()["descent"]
        deals += len(dealt)
        twin_dealt = {where: d.ingest_and_deal(
            [(buf.add(rows), tick, None)], buf)
            for where, (buf, r, d) in tw.items()}
        check(all(len(v) == len(dealt) for v in twin_dealt.values()),
              f"dealer tick {tick}: deals {len(dealt)} and the twins'")
        dealer.publish(dealt)
        for where, (_, _, d) in tw.items():
            d.publish(twin_dealt[where])
        pending = None
        if not dealt:
            continue
        blk = ring.pop(timeout=0)
        idx, gen = blk.idx.cpu().numpy(), blk.gen.cpu().numpy()
        twin_wb = {}
        for where, (buf, r, d) in tw.items():
            tb = r.pop(timeout=0)
            check(np.array_equal(idx, tb.idx) and np.array_equal(gen, tb.gen)
                  and blk.beta == tb.beta and blk.step == tb.step,
                  f"dealer tick {tick}: slots, generations and beta "
                  f"bitwise the {where} twin's")
            for a, b in zip(blk.batches, tb.batches):
                b = b if isinstance(b, torch.Tensor) else torch.from_numpy(b)
                check(torch.equal(a.cpu(), b.cpu()),
                      f"dealer tick {tick}: rows bitwise the {where} twin's")
            w = blk.weights.cpu().numpy()
            if where == "card":
                check(np.array_equal(w, tb.weights),
                      f"dealer tick {tick}: weights bitwise the card twin's")
            else:
                weights_bitwise_cpu &= bool(np.array_equal(w, tb.weights))
                rel = float(np.abs(w - tb.weights).max() / np.abs(
                    tb.weights).max())
                worst_w = max(worst_w, rel)
                check(rel <= 1e-6, f"dealer tick {tick}: weights within "
                      f"1e-6 of the CPU twin's ({rel})")
            twin_wb[where] = (tb.idx, tb.gen)
        td = wb_rng.uniform(0.05, 3.0, idx.shape)
        pending = ((idx, td, gen), twin_wb)
    torch.cuda.synchronize()
    prof.stop()
    for event in prof.events():
        name = event.name.removeprefix("dealer.")
        if event.device_type == DeviceType.CPU and event.name != name:
            found = kernels_under(event)
            samples[name]["device"].append(
                sum(k.duration for k in found) / 1e3)
            samples[name]["kernels"].append(len(found))
    check(deals >= DEAL_TICKS - 1 and launches == deals,
          f"dealer: {launches} descent launches in {deals} deals")
    cap = dbuf.trees.capacity
    check(np.array_equal(dbuf.trees.sum_tree[cap:].cpu().numpy(),
                         tw["cpu"][2]._trees.get(np.arange(cap)).astype(
                             np.float32)),
          "dealer: the card's tree leaves are the CPU twin's")
    times = {}
    for name, rec in samples.items():
        check(rec["host"], f"dealer: no timed {name} calls")
        times[name] = {
            key: (float(np.median(rec[src])) if any(rec[src]) else None)
            for key, src in (("host_ms", "host"), ("span_ms", "span"),
                             ("device_ms", "device"),
                             ("kernels", "kernels"))}

    def fmt(t):
        def num(key, unit=" ms", spec=".4f"):
            return ("not measured" if t[key] is None
                    else f"{t[key]:{spec}}{unit}")
        return (f"host enqueue {num('host_ms')}, device span behind a "
                f"sleep {num('span_ms')}, profiler {num('device_ms')} in "
                f"{num('kernels', '', '.0f')} kernels and copies")

    print(f"[dealer] {deals} deals of K={K} x B={BATCH} over a "
          f"{CAPACITY}-row ring ({dbuf.size} rows) in "
          f"{time.perf_counter() - t0:.2f} s: bitwise the card twin, slots "
          f"rows generations beta bitwise the CPU twin, weights "
          f"{'bitwise' if weights_bitwise_cpu else f'within {worst_w:.3g}'}"
          f"; descent launches per deal {launches / deals:.3f}; per deal "
          f"{fmt(times['deal'])}; per settle (set_leaves of {K * BATCH} "
          f"slots over two {2 * cap}-node trees) {fmt(times['settle'])} "
          f"({card})")
    # the descent kernel at the dealt shapes, against its plain version
    tree = dbuf.trees.sum_tree
    gen_t = torch.Generator(device=dev).manual_seed(22)
    mass = (torch.rand(K * BATCH, generator=gen_t, device=dev)
            * tree[1]).contiguous()
    tree20, _ = _tree_with_zero_runs(dev, gen_t, DRIVER_CAP)
    mass20 = (torch.rand(K * DRIVER_BATCH, generator=gen_t, device=dev)
              * tree20[1]).contiguous()
    out = {"deal": times["deal"], "settle": times["settle"], "deals": deals,
           "launches": launches, "weights_rel_err_cpu": worst_w,
           "weights_bitwise_cpu": weights_bitwise_cpu}
    for tag, t, m in (("q10240", tree, mass), ("q2560", tree20, mass20)):
        got, want = desc.descend(t, m), desc.descend_plain(t, m)
        check(torch.equal(got, want), f"descent at {tag}: bitwise")
        ms, _ = device_ms(lambda: desc.descend(t, m), calls=100)
        plain_ms, _ = device_ms(lambda: desc.descend_plain(t, m), calls=2)
        leaves = t[t.shape[0] // 2:]
        cumsum = torch.cumsum(leaves, 0)
        lib_ms, _ = device_ms(
            lambda: torch.searchsorted(cumsum, m, right=True), calls=100)
        levels = int(math.log2(t.shape[0] // 2))
        b_ms, b_by = bound_ms(_descent_bytes(t, m), 2 * m.numel() * levels)
        print(f"[dealer] descent {tag} ({m.numel()} queries, {levels} "
              f"levels): kernel {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f}"
              f" us, searchsorted {lib_ms * 1e3:.3f} us, bound "
              f"{b_ms * 1e3:.4f} us ({b_by}) ({card})")
        out[tag] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
    dealer.close()
    for _, _, d in tw.values():
        d.close()
    return out


def phase_dealt_driver(card: str, hooks: DriverHooks,
                       host: dict | None) -> dict:
    """22b: ``train.main --env point --fused_replay off --sample_on_ingest
    1`` for two cycles under ``--sampler pallas``, ``scan`` and ``host``,
    then ``auto`` with ``--learners 2``. Per run: the descent once per
    deal under ``pallas`` (or ``auto`` when it picks it) and never under
    ``scan`` and ``host``; the arm's kernels once per grad step of every
    replica; own grad-steps/s against phase 13's host path in this call;
    the deal-to-grad p50 (a block's push into its ring to its write-back
    after the grad steps); the CPU ms per grad step of the replica
    threads, which run the grad steps (and of the main thread, as 20c
    measures it)."""
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.learner.replica import LearnerReplica
    from d4pg_tpu_torch.ops.autotune import select_projection, select_sampler
    from d4pg_tpu_torch.replay.staging import DealtBlockRing

    runs = ROOT / "runs" / "chip_smoke_dealt"
    shutil.rmtree(runs, ignore_errors=True)
    cfg = ExperimentConfig(env="point").resolve()
    arm = select_projection("auto", batch_size=cfg.batch_size,
                            v_min=cfg.v_min, v_max=cfg.v_max,
                            n_atoms=cfg.n_atoms,
                            device=driver.learner_device(cfg)).selected
    # ``auto``'s race times both descents (its launches are not the
    # driver's): resolved here first, the driver reads the cached choice
    auto = select_sampler("auto", capacity=cfg.memory_size,
                          k=cfg.updates_per_dispatch,
                          batch_size=cfg.batch_size,
                          device=driver.learner_device(cfg))
    print(f"[driver dealt] sampler 'auto' on the card: {auto.selected!r}, "
          f"timings {auto.timings_ms} ms ({card})")
    offered, popped, d2g, cpu, planes = {}, threading.local(), [], [], []
    lock = threading.Lock()
    offer, pop = DealtBlockRing.offer, DealtBlockRing.pop
    writeback, run_round = (ReplayService.queue_writeback,
                            LearnerReplica.run_round)
    plane = driver.learner_plane

    def offering(ring, block):
        with lock:
            offered[id(block)] = time.perf_counter()
        return offer(ring, block)

    def popping(ring, timeout=None):
        block = pop(ring, timeout)
        popped.block = block
        return block

    def writing_back(service, idx, td, gen):
        out = writeback(service, idx, td, gen)
        block = getattr(popped, "block", None)
        if block is not None:
            with lock:
                d2g.append(1e3 * (time.perf_counter()
                                  - offered.pop(id(block))))
        return out

    def rounding(replica, n, generation=None):
        t0 = time.thread_time()
        try:
            return run_round(replica, n, generation)
        finally:
            with lock:
                cpu.append(time.thread_time() - t0)

    def capture(*args, **kwargs):
        reps, agg = plane(*args, **kwargs)
        planes.append((reps, agg, reps[0]._service))
        return reps, agg

    (DealtBlockRing.offer, DealtBlockRing.pop, ReplayService.queue_writeback,
     LearnerReplica.run_round, driver.learner_plane) = (
        offering, popping, writing_back, rounding, capture)
    out = {"launches": {}, "runs": {}}
    try:
        for tag, argv in (
                ("pallas", ["--sampler", "pallas"]),
                ("scan", ["--sampler", "scan"]),
                ("host", ["--sampler", "host"]),
                ("auto_learners2", ["--sampler", "auto", "--learners", "2"])):
            d2g.clear()
            cpu.clear()
            result, counts, own, cycles, wall = _driver_run(
                hooks, driver, f"dealt {tag}",
                ["--env", "point", "--fused_replay", "off",
                 "--sample_on_ingest", "1", "--n_cycles", "2", *argv],
                runs / tag)
            ((reps, agg, service),) = planes
            planes.clear()
            dealer = service._dealer
            sampler = getattr(dealer, "arm", "host")
            grad_steps = sum(r.steps_done for r in reps)
            deals = dealer.dealt_blocks
            want = {k: grad_steps if k in ARM_KERNELS[arm] else 0
                    for k in counts}
            want["descent"] = deals if sampler == "pallas" else 0
            check(counts == want, f"driver dealt {tag}: launches {counts}, "
                  f"expected {want} ({deals} deals, {grad_steps} grad steps,"
                  f" sampler {sampler})")
            check(grad_steps >= 80 and deals >= 2 and agg.ledger_monotone(),
                  f"driver dealt {tag}: {grad_steps} grad steps, {deals} "
                  "deals, monotone versions")
            check(dealer.deals_dropped == 0,
                  f"driver dealt {tag}: no dealt block dropped")
            for k, c in counts.items():
                out["launches"][k] = out["launches"].get(k, 0) + c
            rep_cpu_ms = 1e3 * sum(cpu) / grad_steps
            main_cpu_ms = [1e3 * c / 40 for c in hooks.cpu_spans]
            # every replica's grad steps over each cycle's span (at N = 2
            # each replica takes one 40-step block per cycle)
            own_all = [grad_steps / len(own) / s for s in hooks.spans]
            p50 = float(np.median(d2g)) if d2g else None
            print(f"[driver dealt {tag}] {wall:.2f} s, sampler {sampler}, "
                  f"arm {arm!r}; own grad-steps/s {[round(x, 2) for x in own]}"
                  f", all replicas' {[round(x, 2) for x in own_all]}"
                  f" (host path of phase 13 in this call: "
                  f"{'not run' if host is None else [round(x, 2) for x in host['fused_off']['own_grad_steps_per_sec']]}"
                  f"); {deals} deals, {grad_steps} grad steps over "
                  f"{len(reps)} replicas; deal-to-grad p50 "
                  f"{'not measured' if p50 is None else round(p50, 3)} ms "
                  f"over {len(d2g)} blocks; CPU per grad step: replica "
                  f"threads {rep_cpu_ms:.2f} ms, main thread "
                  f"{[round(x, 2) for x in main_cpu_ms]} ms; launches "
                  f"{counts} ({card})")
            out["runs"][tag] = {"own_grad_steps_per_sec": own,
                                "all_grad_steps_per_sec": own_all,
                                "auto_timings_ms": auto.timings_ms,
                                "sampler": sampler, "deals": deals,
                                "grad_steps": grad_steps,
                                "deal_to_grad_p50_ms": p50,
                                "replica_cpu_ms_per_grad_step": rep_cpu_ms,
                                "main_cpu_ms_per_grad_step": main_cpu_ms,
                                "launches": counts}
    finally:
        (DealtBlockRing.offer, DealtBlockRing.pop,
         ReplayService.queue_writeback, LearnerReplica.run_round,
         driver.learner_plane) = (offer, pop, writeback, run_round, plane)
    return out



# --- crash recovery and the learner update plane (phase 23) --------------

def phase_recovery(dev, card: str) -> dict:
    """23a: the snapshot round trip at the slice's width: a 200,000-row
    generation-tracked PER ring (Humanoid width) filled through a
    ``ReplayService``, 3 chunks of K = 40 (``pallas_ce``) so the leaves
    differ, then ``snapshot`` (its buffer-lock hold timed), the sidecar
    written and read back, ``restore`` into a fresh service and buffer:
    rows, both trees, ``max_priority``, generations, head and size
    bitwise, the service one generation on; then one K = 40 chunk from
    each buffer on copies of one state with the same injected uniforms:
    slots bitwise, params, TD errors and trees bitwise (else reported and
    held to rtol 1e-5). The device-to-host copy the cut makes is timed
    beside the same bytes into pinned memory."""
    import shutil

    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.io.checkpoint import (load_replay_sidecar,
                                              replay_sidecar_path,
                                              save_replay_sidecar)
    from d4pg_tpu_torch.learner.fused import fused_chunk_step
    from d4pg_tpu_torch.learner.loop import FusedLoop
    from d4pg_tpu_torch.learner.replica import replica_state
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    arm = "pallas_ce"
    cfg = config(arm)
    run_dir = ROOT / "runs" / "chip_smoke_recovery" / "sidecar"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)

    def ring():
        return FusedDeviceReplay(CAPACITY, OBS, ACT, alpha=0.6, device=dev,
                                 gen_tracked=True)

    src = ReplayService(ring())
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    for start in range(0, CAPACITY, FILL_BLOCK):
        src.add(random_rows(rng, min(FILL_BLOCK, CAPACITY - start)),
                actor_id="fill")
        src.flush(timeout=30.0)
        src.drain_device()
    buf = src.buffer
    torch.cuda.synchronize()
    check(buf.size == CAPACITY and buf.head == 0,
          f"recovery ring full: size {buf.size}, head {buf.head}")
    print(f"[recovery] ring filled through the service: {buf.size} rows "
          f"in {time.perf_counter() - t0:.2f} s")
    state = init_state(cfg, seed=0, device=dev)
    loop = FusedLoop(cfg, buf, k=K, batch_size=BATCH,
                     generator=torch.Generator(device=dev).manual_seed(23))
    loop.run(state, 3 * K)
    loop.close()
    torch.cuda.synchronize()

    # the cut: how long the snapshot holds the buffer lock
    lock_s = []
    cut = buf.snapshot

    def timed_cut():
        t = time.perf_counter()
        out = cut()
        lock_s.append(time.perf_counter() - t)
        return out

    buf.snapshot = timed_cut
    t0 = time.perf_counter()
    snap = src.snapshot()
    snap_s = time.perf_counter() - t0
    del buf.snapshot
    gen_before = src.generation
    ring_bytes = sum(a[:buf.size].numel() * a.element_size()
                     for a in buf.storage)
    # the same bytes into pinned host memory (allocation timed apart)
    t0 = time.perf_counter()
    pinned = [torch.empty(a[:buf.size].shape, dtype=a.dtype,
                          pin_memory=True) for a in buf.storage]
    alloc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p, a in zip(pinned, buf.storage):
        p.copy_(a[:buf.size])
    torch.cuda.synchronize()
    pinned_s = time.perf_counter() - t0
    del pinned
    t0 = time.perf_counter()
    pageable = [a[:buf.size].to("cpu", copy=True) for a in buf.storage]
    pageable_s = time.perf_counter() - t0
    del pageable

    t0 = time.perf_counter()
    path = save_replay_sidecar(str(run_dir), 0, 3 * K, snap)
    write_s = time.perf_counter() - t0
    side_bytes = Path(path).stat().st_size
    check(Path(path) == Path(replay_sidecar_path(str(run_dir), 0)),
          "recovery: the sidecar's path")
    del snap
    t0 = time.perf_counter()
    loaded, step = load_replay_sidecar(str(run_dir), 0)
    read_s = time.perf_counter() - t0
    check(step == 3 * K, f"recovery: sidecar step {step}")

    dst = ReplayService(ring())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.restore(loaded)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del loaded
    new = dst.buffer
    check(dst.generation == gen_before + 1,
          f"recovery: service generation {dst.generation} == "
          f"{gen_before} + 1")
    check((new.head, new.size) == (buf.head, buf.size),
          f"recovery: head/size {(new.head, new.size)} vs "
          f"{(buf.head, buf.size)}")
    for name, a, b in zip(buf.storage._fields, buf.storage, new.storage):
        check(torch.equal(a[:buf.size], b[:buf.size]),
              f"recovery: rows of {name} bitwise")
    for name, a, b in (("sum tree", buf.trees.sum_tree, new.trees.sum_tree),
                       ("min tree", buf.trees.min_tree, new.trees.min_tree)):
        check(torch.equal(a, b), f"recovery: {name} bitwise (every node)")
    check(new.max_priority == buf.max_priority
          and float(new.trees.max_priority) == float(buf.max_priority),
          "recovery: max_priority")
    check(np.array_equal(new.generation, buf.generation)
          and torch.equal(new.gen, buf.gen),
          "recovery: generations bitwise (host mirror and device)")
    print(f"[recovery] snapshot {snap_s:.4f} s (buffer lock held "
          f"{lock_s[0]:.4f} s); ring {ring_bytes} B to the host: pageable "
          f"{pageable_s:.4f} s, pinned {pinned_s:.4f} s (+{alloc_s:.4f} s "
          f"to allocate); sidecar {side_bytes} B written in {write_s:.4f} "
          f"s, read in {read_s:.4f} s; restore with the tree rebuild "
          f"{restore_s:.4f} s ({card})")

    # one chunk from each buffer: same state, same uniforms
    u = torch.from_numpy(np.random.default_rng(24).random(
        (K, BATCH)).astype(np.float32)).to(dev)
    twin = replica_state(state, 0, 0)
    zero_counts()
    out = []
    for b, st in ((buf, state), (new, twin)):
        trees, m = fused_chunk_step(cfg, st, b.trees, b.storage, b.size,
                                    k=K, batch_size=BATCH, u=u)
        out.append((trees, m, st))
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {n: 2 * K if n in fused_kernels(arm) else 0 for n in counts}
    check(counts == want, f"recovery chunks: launches {counts}, "
          f"expected {want}")
    (t_a, m_a, s_a), (t_b, m_b, s_b) = out
    check(torch.equal(m_a["idx"], m_b["idx"]),
          "recovery: the descent's slots after the restore, bitwise")
    # same kernels on the same inputs: everything the chunk wrote back
    # is held bitwise, not to a tolerance
    check(torch.equal(m_a["td_error"], m_b["td_error"]),
          "recovery: TD errors after the restore, bitwise")
    check(torch.equal(t_a.sum_tree, t_b.sum_tree),
          "recovery: the write-back sum tree after the restore, bitwise")
    for m in ("actor", "critic"):
        for (n, p), q in zip(getattr(s_a, m).named_parameters(),
                             getattr(s_b, m).parameters()):
            check(torch.equal(p, q),
                  f"recovery: {m} param {n} after the restore, bitwise")
    print(f"[recovery] one K = {K} chunk from each buffer: slots, params, "
          f"TD errors and write-back trees bitwise; launches {counts} "
          f"({card})")
    src.close()
    dst.close()
    shutil.rmtree(run_dir, ignore_errors=True)
    return {"snapshot_s": snap_s, "lock_s": lock_s[0],
            "ring_bytes": ring_bytes, "pageable_s": pageable_s,
            "pinned_s": pinned_s, "pinned_alloc_s": alloc_s,
            "sidecar_bytes": side_bytes, "write_s": write_s,
            "read_s": read_s, "restore_s": restore_s, "launches": counts}


class _Tee:
    """Standard output copied into a buffer (the driver's own words)."""

    def __init__(self):
        import io

        self.buf, self._out = io.StringIO(), sys.stdout

    def write(self, s):
        self.buf.write(s)
        return self._out.write(s)

    def flush(self):
        self._out.flush()


def phase_recovery_driver(card: str, hooks: DriverHooks,
                          resume_rates: list | None) -> dict:
    """23b: ``train.main --env point`` at the default widths (phase 11's
    config: hidden 256x3, 51 atoms, batch 64, K = 40, a 1,000,000-row
    ring) with ``--checkpoint_replay 1 --checkpoint_replay_every 1`` for
    two cycles, then ``--resume 1`` for one: the restored service holds
    the sidecar's rows, leaves and ``max_priority`` bitwise at generation
    1, the resumed cycle trains (the arm's kernels and the descent once
    per grad step), its own grad-steps/s beside phase 11's learner-only
    resume; then a sidecar with one byte flipped gives a learner-only
    resume that says so."""
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.io.checkpoint import (load_replay_sidecar,
                                              replay_sidecar_path)
    from d4pg_tpu_torch.ops.autotune import select_projection

    runs = ROOT / "runs" / "chip_smoke_recovery" / "driver"
    shutil.rmtree(runs, ignore_errors=True)
    cfg = ExperimentConfig(env="point").resolve()
    arm = select_projection("auto", batch_size=cfg.batch_size,
                            v_min=cfg.v_min, v_max=cfg.v_max,
                            n_atoms=cfg.n_atoms,
                            device=driver.learner_device(cfg)).selected
    argv = ["--env", "point", "--checkpoint_replay", "1",
            "--checkpoint_replay_every", "1"]
    _driver_run(hooks, driver, "recovery", [*argv, "--n_cycles", "2"], runs)
    run_dir = runs / cfg.run_name()
    snap, step = load_replay_sidecar(str(run_dir), 0)
    check(step == 2 * cfg.train_steps_per_cycle,
          f"driver recovery: sidecar at step {step}")
    held = {}
    restore = driver._restore_replay

    def restoring(service, snap_, env_steps):
        restore(service, snap_, env_steps)
        held["state"] = service.replay_state()
        held["generation"] = service.generation

    driver._restore_replay = restoring
    try:
        result, counts, own, cycles, wall = _driver_run(
            hooks, driver, "recovery resume",
            [*argv, "--n_cycles", "1", "--resume", "1"], runs)
        got, want = held["state"], snap["buffer"]
        check(held["generation"] == snap["generation"] + 1 == 1,
              f"driver recovery: generation {held['generation']}")
        check((got["head"], got["size"]) == (want["head"], want["size"]),
              "driver recovery: head and size")
        for f in want["rows"]:
            check(np.array_equal(got["rows"][f], want["rows"][f])
                  and got["rows"][f].dtype == want["rows"][f].dtype,
                  f"driver recovery: sidecar rows of {f} bitwise")
        check(np.array_equal(got["leaf_priorities"],
                             want["leaf_priorities"])
              and got["max_priority"] == want["max_priority"],
              "driver recovery: leaves and max_priority bitwise")
        steps = cfg.train_steps_per_cycle
        expect = {n: steps if n in fused_kernels(arm) else 0
                  for n in counts}
        check(counts == expect, f"driver recovery resume: launches "
              f"{counts}, expected {expect}")
        print(f"[driver recovery] resumed with {want['size']} rows from "
              f"the sidecar at generation {held['generation']}: own "
              f"grad-steps/s {[round(x, 2) for x in own]} against phase "
              f"11's learner-only resume "
              f"{'not run' if resume_rates is None else [round(x, 2) for x in resume_rates]}"
              f" in this call; {wall:.2f} s; launches {counts} ({card})")

        path = replay_sidecar_path(str(run_dir), 0)
        blob = bytearray(Path(path).read_bytes())
        blob[len(blob) // 2] ^= 0x01
        Path(path).write_bytes(bytes(blob))
        held.clear()
        tee = _Tee()
        with contextlib.redirect_stdout(tee):
            _driver_run(hooks, driver, "recovery corrupt",
                        [*argv, "--n_cycles", "1", "--resume", "1"], runs)
        said = tee.buf.getvalue()
        check(held == {} and "corrupt" in said and "learner-only" in said,
              "driver recovery: a flipped byte gives a learner-only resume "
              "that says so")
        print("[driver recovery] one flipped byte: learner-only resume, "
              "the run said so")
    finally:
        driver._restore_replay = restore
    return {"own_grad_steps_per_sec": own, "launches": counts,
            "sidecar_rows": int(want["size"])}


def phase_update_plane(dev, card: str) -> dict:
    """23c: the update plane on the card. Host-sampled ``LearnerReplica``s
    at the slice's width (``pallas``) over a 50,000-row PER ring on the
    card; an ``AggregatorServer`` on loopback. (i) N = 1, f32: 3 rounds of
    40 grad steps through an ``UpdateClient`` against the same rounds
    through the in-process ``Aggregator`` over a twin service (same seed,
    same state): verdicts, replica states and aggregates bitwise; (ii) N
    = 2 on threads, rounds for ``UPDATE_WINDOW_S`` under each of f32,
    bf16 and int8: rounds/s, the submit round trip's p50, p99 and max
    with its n, frame bytes; (iii) a replica
    fenced after its round's grad steps, before its submission: its own
    submit and the replay of its last frame come back ``fenced``, no
    dead-epoch update merged, the version stream monotone."""

    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.distributed.update_plane import (AggregatorServer,
                                                         UpdateClient)
    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.learner.aggregator import Aggregator
    from d4pg_tpu_torch.learner.replica import (PARAM_FIELDS,
                                                LearnerReplica,
                                                replica_state)
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
    from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule

    arm, cap, rounds = "pallas", 50_000, 3
    cfg = config(arm)
    rng = np.random.default_rng(25)
    rows = [random_rows(rng, FILL_BLOCK) for _ in range(cap // FILL_BLOCK)]

    def service():
        svc = ReplayService(PrioritizedReplayBuffer(
            cap, OBS, ACT, alpha=0.6, seed=7, storage="device", device=dev))
        for r in rows:
            svc.add(r, actor_id="fill")
        svc.flush(timeout=60.0)
        return svc

    state = init_state(cfg, seed=0, device=dev)
    zero_counts()
    sides = []
    for wire in (False, True):
        svc, agg = service(), Aggregator(WeightStore())
        server = AggregatorServer(agg) if wire else None
        client = UpdateClient("127.0.0.1", server.port) if wire else None
        rep = LearnerReplica(0, cfg, agg, replica_state(state, 0, 0), k=K,
                             batch_size=BATCH, service=svc,
                             beta_schedule=SharedBetaSchedule(0.4, 100_000),
                             updates=client)
        sides.append((svc, agg, server, client, rep))
    for _ in range(rounds):
        got = [side[4].run_round(K) for side in sides]
        check(got[0] == got[1] and got[0]["status"] == "applied",
              f"update plane N = 1: verdicts {got}")
    torch.cuda.synchronize()
    counts = launch_counts()
    a, b = sides[0][4].state, sides[1][4].state
    for m in ("actor", "critic", "target_actor", "target_critic"):
        for (n, p), q in zip(getattr(a, m).state_dict().items(),
                             getattr(b, m).state_dict().values()):
            check(torch.equal(p, q), f"update plane N = 1: {m}.{n} "
                  "bitwise through the wire and in process")
    (v0, cur0), (v1, cur1) = (side[1].current() for side in sides)
    check(v0 == v1 == rounds and all(
        torch.equal(t, cur1[f][k]) for f in PARAM_FIELDS
        for k, t in cur0[f].items()),
        "update plane N = 1: aggregates bitwise")
    want = {n: 2 * rounds * K if n in ARM_KERNELS[arm] else 0
            for n in counts}
    check(counts == want, f"update plane N = 1: launches {counts}, "
          f"expected {want}")
    print(f"[update plane] N = 1, f32: {rounds} rounds of {K} grad steps "
          f"bitwise through UpdateClient and in process; launches {counts}"
          f" ({card})")
    for svc, agg, server, client, rep in sides:
        rep.close()
        if client is not None:
            client.close()
            server.close()
        agg.close()
    sides[0][0].close()
    svc_wire = sides[1][0]  # the N = 2 runs go on over its ring

    out = {"launches": dict(counts), "codecs": {}}
    for codec in ("f32", "bf16", "int8"):
        agg = Aggregator(WeightStore())
        server = AggregatorServer(agg)
        clients = [UpdateClient("127.0.0.1", server.port, codec=codec)
                   for _ in range(2)]
        rtt, frames = [], []
        lock = threading.Lock()
        for c in clients:
            submit = c.submit

            def timed(*args, _submit=submit, _c=c, **kw):
                t = time.perf_counter()
                res = _submit(*args, **kw)
                with lock:
                    rtt.append(1e3 * (time.perf_counter() - t))
                    frames.append(len(_c.last_frame))
                return res

            c.submit = timed
        sched = SharedBetaSchedule(0.4, 100_000)
        reps = [LearnerReplica(i, cfg, agg, replica_state(state, i, 0), k=K,
                               batch_size=BATCH, service=svc_wire,
                               beta_schedule=sched, updates=clients[i])
                for i in range(2)]
        # each replica runs rounds until the window closes: a p99 needs
        # its hundred-odd submits, not a handful
        ran = [0, 0]
        zero_counts()
        t0 = time.perf_counter()
        deadline = t0 + UPDATE_WINDOW_S

        def rounds_until(i, r):
            while time.perf_counter() < deadline:
                r.run_round(K)
                ran[i] += 1

        rounds = _Threads()
        for i, r in enumerate(reps):
            rounds.start(rounds_until, i, r)
        rounds.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        check(all(r.applied == n for r, n in zip(reps, ran))
              and agg.ledger_monotone(),
              f"update plane N = 2 {codec}: every round applied, "
              "monotone versions")
        for n, c in counts.items():
            out["launches"][n] += c
        res = {"rounds": sum(ran), "wall_s": wall,
               "rounds_per_s": sum(ran) / wall,
               "grad_steps_per_s": sum(ran) * K / wall,
               "submits": len(rtt),
               "rtt_p50_ms": float(np.percentile(rtt, 50)),
               "rtt_p99_ms": float(np.percentile(rtt, 99)),
               "rtt_max_ms": float(max(rtt)),
               "frame_bytes": int(np.median(frames))}
        out["codecs"][codec] = res
        print(f"[update plane] N = 2, {codec}: {res['rounds']} rounds in "
              f"{wall:.2f} s, {res['rounds_per_s']:.3f} rounds/s "
              f"({res['grad_steps_per_s']:.1f} grad-steps/s over both), "
              f"submit round trip over n = {res['submits']} submits: p50 "
              f"{res['rtt_p50_ms']:.2f} ms, p99 {res['rtt_p99_ms']:.2f} "
              f"ms, max {res['rtt_max_ms']:.2f} ms; frame "
              f"{res['frame_bytes']} B; launches {counts} ({card})")

        if codec == "f32":
            # a replica killed mid-update: fenced once its round's grad
            # steps are done, before its submission leaves
            victim = reps[1]
            applied0 = agg.counters()["applied"]
            steps = victim._host_steps
            version = []

            def steps_then_killed(n):
                steps(n)
                agg.fence_replica(1)
                version.append(agg.version)

            victim._host_steps = steps_then_killed
            out["killed_round"] = victim.run_round(K)
            version = version[0]
            probe = UpdateClient("127.0.0.1", server.port)
            replay = probe.submit_frame(clients[1].last_frame)
            probe.close()
            check(out["killed_round"]["status"] == "fenced"
                  and replay["status"] == "fenced"
                  and agg.version == version
                  and agg.counters()["applied"] == applied0
                  and agg.ledger_monotone(),
                  f"update plane: the killed replica's submit "
                  f"{out['killed_round']['status']} and its replayed frame "
                  f"{replay['status']}, no dead-epoch update merged")
            # the killed round's grad steps launched too
            for n, c in launch_counts().items():
                out["launches"][n] += c - counts[n]
            print(f"[update plane] killed mid-update: its submit and the "
                  f"replay of its last frame came back fenced; "
                  f"{server.stats()['fenced_header']} header fences, 0 "
                  f"dead-epoch updates merged ({card})")
        for r in reps:
            r.close()
        for c in clients:
            c.close()
        server.close()
        agg.close()
    svc_wire.close()
    return out


# --- the elastic plane (phase 24) ------------------------------------------

# 24a: policy lanes querying the driver's server while it trains: rows per
# request and seconds between a lane's requests (an actor's env tick)
ELASTIC_LANES, ELASTIC_ROWS, ELASTIC_LANE_PERIOD_S = 4, 8, 0.05


class FirstForwards:
    """The first and second forward at each (caller, device, rows) shape
    of ``act_deterministic`` as the policy server and the drill's bucket
    warm-up call it (measurement only: those two calls wait for the
    card). A new bucket shape's first call on the card pays the host's
    kernel choice once."""

    def __init__(self):
        from d4pg_tpu_torch.fleet import elastic_chaos
        from d4pg_tpu_torch.serving import server

        self.ms: dict = {}
        self._mods = {"server": server, "drill warm-up": elastic_chaos}
        self._orig = {tag: m.act_deterministic
                      for tag, m in self._mods.items()}

    def install(self) -> None:
        for tag, m in self._mods.items():
            m.act_deterministic = self._timed(tag, self._orig[tag])

    def remove(self) -> None:
        for tag, m in self._mods.items():
            m.act_deterministic = self._orig[tag]

    def _timed(self, tag, fn):
        def timed(actor, obs):
            key = (tag, obs.device.type, int(obs.shape[0]))
            seen = self.ms.setdefault(key, [])
            if len(seen) >= 2:
                return fn(actor, obs)
            cuda = obs.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(obs.device)
            t0 = time.perf_counter()
            out = fn(actor, obs)
            if cuda:
                torch.cuda.synchronize(obs.device)
            seen.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    def lines(self, tag: str) -> list[str]:
        return [f"{dev} {rows} rows: first {ms[0]:.3f} ms, second "
                + (f"{ms[1]:.3f} ms" if len(ms) > 1 else "not run")
                for (t, dev, rows), ms in sorted(self.ms.items())
                if t == tag]


def _decisions_per_knob(records) -> dict:
    from d4pg_tpu_torch.elastic.autoscaler import KNOBS

    return {k: sum(1 for r in records if k in r["decisions"]) for k in KNOBS}


def phase_elastic_driver(card: str, hooks: DriverHooks,
                         dealt: dict | None) -> dict:
    """24a: the driver with every knob of the elastic plane wired (see the
    module docstring), at the default widths (hidden 256x3, 51 atoms,
    batch 64, K = 40), ELASTIC_LANES policy lanes of ELASTIC_ROWS rows,
    one request every ELASTIC_LANE_PERIOD_S each, querying the driver's
    policy server from the autoscaler's start to its close."""
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig
    from d4pg_tpu_torch.core import locking
    from d4pg_tpu_torch.elastic.autoscaler import KNOBS, replay_matches
    from d4pg_tpu_torch.obs.registry import REGISTRY
    from d4pg_tpu_torch.ops.autotune import select_projection
    from d4pg_tpu_torch.serving import ActorConfig, RemotePolicyClient

    runs = ROOT / "runs" / "chip_smoke_elastic"
    shutil.rmtree(runs, ignore_errors=True)
    cfg = ExperimentConfig(env="point").resolve()
    arm = select_projection("auto", batch_size=cfg.batch_size,
                            v_min=cfg.v_min, v_max=cfg.v_max,
                            n_atoms=cfg.n_atoms,
                            device=driver.learner_device(cfg)).selected
    seen: dict = {"active": []}
    stop = threading.Event()
    lanes, clients = _Threads(), []
    plane, learners = driver.elastic_plane, driver.learner_plane
    activate = driver.ReplicaTarget.activate

    def lane(client):
        obs = np.zeros((ELASTIC_ROWS, client.config.obs_dim), np.float32)
        while not stop.is_set():
            client.actions(obs)  # warm-up actions until the server adopts
            stop.wait(ELASTIC_LANE_PERIOD_S)

    def capture(cfg_, service, server, replicas, target):
        scaler = plane(cfg_, service, server, replicas, target)
        seen.update(scaler=scaler, service=service, server=server,
                    target=target)
        for i in range(ELASTIC_LANES):
            clients.append(RemotePolicyClient(
                server.config, ActorConfig(), "127.0.0.1", server.port,
                lane_id=i, seed=i, timeout=5.0))
            lanes.start(lane, clients[-1], daemon=True)
        close = scaler.close

        def closing():
            # the lanes end before the autoscaler and the server close;
            # a lane's exception is raised by the phase after the run
            stop.set()
            lanes.join(timeout=30.0, reraise=False)
            close()

        scaler.close = closing
        return scaler

    def capture_learners(*args, **kwargs):
        reps, agg = learners(*args, **kwargs)
        seen.update(replicas=reps, agg=agg)
        return reps, agg

    def activating(target, replicas):
        active = activate(target, replicas)
        seen["active"].append(len(active))
        return active

    forwards = FirstForwards()
    forwards.install()
    driver.elastic_plane, driver.learner_plane = capture, capture_learners
    driver.ReplicaTarget.activate = activating
    violations = locking.violation_count()
    crashes = REGISTRY.counter("threads.contained_crashes").value
    tee = _Tee()
    try:
        # the lock plane in record mode for the run, as the drills run it
        with contextlib.redirect_stdout(tee), locking.record_mode():
            result, counts, own, cycles, wall = _driver_run(
                hooks, driver, "elastic",
                ["--env", "point", "--fused_replay", "off",
                 "--sample_on_ingest", "1", "--sampler", "pallas",
                 "--learners", "2", "--serve", "1", "--serve_policy", "1",
                 "--autoscale", "1", "--autoscale_interval_s", "0.05",
                 "--n_cycles", "3"], runs)
    finally:
        forwards.remove()
        driver.elastic_plane, driver.learner_plane = plane, learners
        driver.ReplicaTarget.activate = activate
    lanes.reraise()
    said = tee.buf.getvalue()
    check(f"elastic: autoscaler up, knobs={sorted(KNOBS)}" in said,
          "driver elastic: the banner names the five knobs")
    scaler, service, server = seen["scaler"], seen["service"], seen["server"]
    records = scaler.ledger.records()
    check(any(any(v != 0.0 for v in r["signals"].values())
              for r in records),
          "driver elastic: a tick sensed a non-zero signal")
    check(replay_matches(scaler.cfg, scaler.ledger),
          "driver elastic: the ledger replays its decisions")
    last = records[-1]["targets"]
    sstats = server.serving_stats()
    dealer = service.dealer
    got = {"serving_rows": sstats["max_batch_rows"],
           "serving_window_s": sstats["batch_window_s"],
           "ingest_capacity": service.ingest_stats()["ingest_capacity"],
           "dealer_deals": dealer.max_deals_per_tick,
           "replicas": seen["target"].n}
    check(got == last, f"driver elastic: knobs read back {got}, the "
          f"ledger's last targets {last}")
    check(scaler.stats["actuator_errors"] == 0,
          f"driver elastic: actuator errors {scaler.stats}")
    grad_steps = sum(r.steps_done for r in seen["replicas"])
    want = {k: grad_steps if k in ARM_KERNELS[arm] else 0 for k in counts}
    want["descent"] = dealer.dealt_blocks
    check(counts == want, f"driver elastic: launches {counts}, expected "
          f"{want} ({dealer.dealt_blocks} deals, {grad_steps} grad steps)")
    check(locking.violation_count() == violations,
          "driver elastic: no lock-hierarchy violation")
    check(REGISTRY.counter("threads.contained_crashes").value == crashes,
          "driver elastic: no contained crash")
    lane_stats = [c.stats() for c in clients]
    served = sum(st["served"] for st in lane_stats)
    check(served > 0 and not any(t.is_alive() for t in lanes.threads),
          "driver elastic: the policy lanes were served and ended")
    own_all = [grad_steps / len(own) / span for span in hooks.spans]
    per_knob = _decisions_per_knob(records)
    ref = (None if dealt is None
           else dealt["runs"]["auto_learners2"]["own_grad_steps_per_sec"])
    print(f"[driver elastic] {wall:.2f} s, arm {arm!r}: "
          f"{scaler.stats['ticks']} ticks, {scaler.stats['decisions']} "
          f"decisions, {scaler.stats['actuations']} actuations; decisions "
          f"per knob {per_knob}; last targets {last}; active replicas per "
          f"cycle {seen['active']}; own grad-steps/s "
          f"{[round(x, 2) for x in own]}, all replicas' "
          f"{[round(x, 2) for x in own_all]} (22b auto_learners2 in this "
          f"call: {'not run' if ref is None else [round(x, 2) for x in ref]}"
          f"); {dealer.dealt_blocks} deals, {grad_steps} grad steps; lanes "
          f"served {served}, overload {sum(st['overload_rejected'] for st in lane_stats)}"
          f"; server p95 {sstats['latency_ms']['p95']} ms; launches "
          f"{counts} ({card})")
    for line in forwards.lines("server"):
        print(f"[driver elastic] the server's forward at {line} ({card})")
    return {"own_grad_steps_per_sec": own, "all_grad_steps_per_sec": own_all,
            "launches": counts, "ticks": scaler.stats["ticks"],
            "actuations": scaler.stats["actuations"],
            "decisions_per_knob": per_knob, "active": seen["active"],
            "first_forwards": dict(forwards.ms)}


def phase_elastic_drill(card: str) -> dict:
    """24b: the reference's two-arm drill at its ``ElasticChaosConfig``
    (16 request lanes, 8 ingest lanes, a flash crowd of 8x from 1.0 to
    1.8 s of a 3-s model horizon), the policy server on the card; the
    launch counters set to 0 before it (it runs none of the port's
    kernels)."""
    from d4pg_tpu_torch.fleet import ElasticChaosConfig, run_elastic_chaos
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.learner.update import act_deterministic

    forwards = FirstForwards()
    forwards.install()
    zero_counts()
    t0 = time.perf_counter()
    try:
        report = run_elastic_chaos(ElasticChaosConfig(seed=0))
    finally:
        forwards.remove()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(not any(counts.values()),
          f"elastic drill: no kernel of the port launched ({counts})")
    gate = report["ab_gate"]
    check(gate["draw_digest_equal"] is True,
          "elastic drill: both arms offered the same load")
    check(report["hierarchy_violations"] == 0
          and report["contained_crashes"] == 0
          and report["trace"]["orphans"] == 0,
          f"elastic drill: violations {report['hierarchy_violations']}, "
          f"crashes {report['contained_crashes']}, orphans "
          f"{report['trace']['orphans']}")
    for name, arm in report["arms"].items():
        ing, srv = arm["ingest"], arm["serving"]
        check(sum(ing["sheds_by_class"].values()) >= ing["shed_rows"]
              and sum(srv["admission_rejects_by_class"].values())
              == srv["admission_rejects"],
              f"elastic drill {name}: every shed and reject attributed to "
              f"a class ({ing['sheds_by_class']}, "
              f"{srv['admission_rejects_by_class']})")
    scaler = report["arms"]["elastic"]["autoscaler"]
    check(scaler["ledger_replay_ok"] is True,
          "elastic drill: the ledger replays its decisions")
    check(scaler["ticks"] > 0 and scaler["actuations"] > 0,
          f"elastic drill: {scaler['ticks']} ticks, {scaler['actuations']} "
          "actuations")
    srv = report["arms"]["elastic"]["serving"]
    fin = scaler["final_targets"]
    got = {"serving_rows": srv["max_batch_rows"],
           "serving_window_s": srv["batch_window_s"],
           "ingest_capacity": report["arms"]["elastic"]["ingest"][
               "ingest_capacity"]}
    check(got == {k: fin[k] for k in got},
          f"elastic drill: knobs read back {got}, last targets {fin}")
    records = scaler["ledger_tail"]["records"]
    # the warm-up's first forward at each bucket beside the same shape's
    # steady time afterwards (median of 5 calls, each waited for)
    cfg = ElasticChaosConfig()
    actor = init_state(cfg.agent_config(), cfg.seed, "cuda").actor
    steady = {}
    for (tag, dev, rows) in sorted(forwards.ms):
        if tag != "drill warm-up":
            continue
        obs = torch.zeros((rows, 4), device=dev)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            act_deterministic(actor, obs)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        steady[rows] = float(np.median(times))
    print(f"[elastic drill] {wall:.2f} s; A/B gate {gate} ({card})")
    for name, arm in report["arms"].items():
        srv, ing = arm["serving"], arm["ingest"]
        print(f"[elastic drill {name}] wall {arm['wall_s']} s, requests "
              f"{arm['requests']}, sla breaches {srv['sla_breaches']}, "
              f"latency breaches {srv['latency_breaches']}, admission "
              f"rejects {srv['admission_rejects_by_class']}, request p50 "
              f"{arm['request_latency_ms']['p50']} ms p99 "
              f"{arm['request_latency_ms']['p99']} ms, shed rows "
              f"{ing['shed_rows']} ({ing['sheds_by_class']}), committed "
              f"{ing['rows_committed']} ({card})")
    print(f"[elastic drill] autoscaler: {scaler['ticks']} ticks, "
          f"{scaler['decisions']} decisions, {scaler['actuations']} "
          f"actuations, final targets {fin}; the last records' decisions "
          f"{[r['decisions'] for r in records]} ({card})")
    first = {rows: round(ms[0], 4)
             for (tag, _, rows), ms in sorted(forwards.ms.items())
             if tag == "drill warm-up"}
    print(f"[elastic drill] first forward per bucket in the warm-up, ms "
          f"{first}; steady {({k: round(v, 4) for k, v in steady.items()})}"
          f" ({card})")
    for line in forwards.lines("server"):
        print(f"[elastic drill] the server's forward at {line} ({card})")
    return {"launches": counts, "gate": gate, "wall_s": wall,
            "ticks": scaler["ticks"], "actuations": scaler["actuations"],
            "first_forwards": dict(forwards.ms), "steady_ms": steady}



# phase 25: one process holds two data-axis shards of the 200,000-row ring
MESH_SHARDS = 2
MESH_CAP_SHARD = 1 << 17  # next_pow2(ceil(CAPACITY / MESH_SHARDS))
MESH_GATE_K = 3  # the card-vs-CPU gate's chunk (phase 8's length)
MESH_CHUNKS = 8  # timed chunks, in windows of 2


def phase_mesh_chunk(dev, card: str) -> dict:
    """25a: ``make_sharded_fused_chunk`` at the slice's width on two
    local shards of a 200,000-row ``ShardedFusedReplay`` (2 x 2^17
    slots). The gate: a K = 3 chunk on the card against the same chunk
    on the CPU (its ring a copy of the card's, the same weights and
    uniforms): slots bitwise, losses, TD errors and the trees' roots
    within rtol 1e-4. The K = 40 chunk is compared too and printed, not
    gated: after each write-back the two devices' leaves differ in the
    last bits (their TD errors do), so a later stratified draw near a
    leaf boundary can take the neighbouring slot. Then ``FusedLoop``
    with the mesh, warmed up by a chunk, times windows of 2 chunks, each
    with the counters set to 0 just before and read just after: the
    descent twice per grad step (once per shard), the projection kernels
    never (einsum, the mesh arm); and the breakdown of one profiled
    chunk. Last, the descent at this path's shape (Q = 128 over 2^17
    leaves) against its plain version, bitwise, timed beside the plain
    version and ``searchsorted``."""
    from d4pg_tpu_torch.learner.fused import make_sharded_fused_chunk
    from d4pg_tpu_torch.learner.loop import FusedLoop
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.ops import sampler_descent as desc
    from d4pg_tpu_torch.parallel import RankMesh
    from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay

    mesh = RankMesh.local(dev, MESH_SHARDS)
    cfg = config("einsum")
    b_local = BATCH // MESH_SHARDS
    t0 = time.perf_counter()
    buf = ShardedFusedReplay(CAPACITY, OBS, ACT, mesh, alpha=0.6)
    rng = np.random.default_rng(25)
    for start in range(0, CAPACITY, FILL_BLOCK):
        buf.add(random_rows(rng, min(FILL_BLOCK, CAPACITY - start)))
        buf.drain()
    torch.cuda.synchronize()
    ring_bytes = sum(t.numel() * t.element_size() for t in buf.storage)
    check(buf.cap_shard == MESH_CAP_SHARD and int(buf.size.sum())
          == CAPACITY, f"sharded ring: cap_shard {buf.cap_shard}, sizes "
          f"{buf.size}")
    print(f"[mesh 25a] ring filled: {buf.size.tolist()} rows in "
          f"{MESH_SHARDS} shards of {buf.cap_shard} slots, "
          f"{ring_bytes / 1e9:.3f} GB, {time.perf_counter() - t0:.2f} s")
    cpu_buf = ShardedFusedReplay(CAPACITY, OBS, ACT,
                                 RankMesh.local("cpu", MESH_SHARDS),
                                 alpha=0.6)
    cpu_buf.load_state_dict(buf.state_dict())
    out: dict = {}
    for k in (MESH_GATE_K, K):
        u = torch.from_numpy(rng.random((k, MESH_SHARDS, b_local),
                                        dtype=np.float32))
        runs = {}
        for where, b in (("cpu", cpu_buf), (dev, buf)):
            state = init_state(cfg, seed=0, device=where)
            fn = make_sharded_fused_chunk(
                cfg, RankMesh.local(where, MESH_SHARDS), k=k,
                batch_size=BATCH)
            trees, m = fn(state, b.trees, b.storage, b.size, u=u.to(where))
            runs[str(where)] = {n: v.cpu() for n, v in m.items()}
            runs[str(where)]["root"] = trees.sum_tree[:, 1].cpu()
        cpu, gpu = runs["cpu"], runs[str(dev)]
        same = (cpu["idx"] == gpu["idx"]).all(dim=1)
        first = int((~same).nonzero()[0, 0]) if not bool(same.all()) else k
        errs = {n: _rel_err(gpu[n][:first], cpu[n][:first]) if first else
                float("nan") for n in ("critic_loss", "td_error")}
        print(f"[mesh 25a] K = {k} card vs CPU: slots bitwise in the first "
              f"{first} of {k} steps; over those, critic_loss max rel err "
              f"{errs['critic_loss']:.3e}, td_error {errs['td_error']:.3e}")
        if k == MESH_GATE_K:
            check(first == k, "sharded chunk slots, card vs CPU")
            for name in ("critic_loss", "actor_loss", "td_error", "root"):
                err = _rel_err(gpu[name], cpu[name])
                check(err <= 1e-4, f"sharded chunk {name} card vs CPU "
                      f"({err:.3e})")
            out["gate"] = errs
        else:
            out["k40_bitwise_steps"] = first
    del cpu_buf
    state = init_state(cfg, seed=0, device=dev)
    loop = FusedLoop(cfg, buf, k=K, batch_size=BATCH,
                     generator=torch.Generator(device=dev).manual_seed(0),
                     mesh=mesh)
    loop.run(state, K)  # warm-up
    torch.cuda.synchronize()
    windows, launches = [], {name: 0 for name in launch_counts()}
    for _ in range(MESH_CHUNKS // WINDOW_CHUNKS):
        zero_counts()
        t0 = time.perf_counter()
        metrics = loop.run(state, WINDOW_CHUNKS * K)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        steps = WINDOW_CHUNKS * K
        check(counts == {**{n: 0 for n in counts},
                         "descent": MESH_SHARDS * steps},
              f"[mesh 25a] the descent once per shard per grad step, "
              f"nothing else: {counts}")
        check(bool(torch.isfinite(metrics["critic_loss"]).all())
              and tuple(metrics["idx"].shape) == (K, BATCH),
              "[mesh 25a] finite losses, [K, B] slots")
        windows.append(steps / dt)
        for n in launches:
            launches[n] += counts[n]
    rate = float(np.median(windows))
    print(f"[mesh 25a] grad-steps/s per window "
          f"{[round(x, 2) for x in windows]} (median {rate:.2f}, K = {K}, "
          f"B = {BATCH} over {MESH_SHARDS} shards) ({card})")
    parts = breakdown(lambda chunks: loop.run(state, chunks * K),
                      1e3 / rate)
    loop.close()
    tree = buf.trees.sum_tree[0]
    gen = torch.Generator(device=dev).manual_seed(25)
    mass = (torch.rand(b_local, generator=gen, device=dev)
            * tree[1]).contiguous()
    got, want = desc.descend(tree, mass), desc.descend_plain(tree, mass)
    check(torch.equal(got, want), "descent at Q = 128 over 2^17: bitwise")
    ms, _ = device_ms(lambda: desc.descend(tree, mass), calls=100)
    plain_ms, _ = device_ms(lambda: desc.descend_plain(tree, mass),
                            calls=2)
    cumsum = torch.cumsum(tree[tree.shape[0] // 2:], 0)
    lib_ms, _ = device_ms(
        lambda: torch.searchsorted(cumsum, mass, right=True), calls=100)
    levels = int(math.log2(tree.shape[0] // 2))
    b_ms, b_by = bound_ms(_descent_bytes(tree, mass),
                          2 * mass.numel() * levels)
    print(f"[mesh 25a] descent Q = {b_local} over 2^{levels}: kernel "
          f"{ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, searchsorted "
          f"{lib_ms * 1e3:.3f} us, bound {b_ms * 1e3:.4f} us ({b_by}) "
          f"({card})")
    del buf
    return {**out, "windows": windows, "grad_steps_per_s": rate,
            "launches": launches, "device_busy_ms": parts["device_busy_ms"],
            "stream_syncs": parts["stream_syncs"],
            "descent": {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": b_by}}


def _mesh_check_args(out: Path | None) -> list[str]:
    args = ["--device", "cuda", "--fused", "1", "--obs_dim", str(OBS),
            "--act_dim", str(ACT), "--hidden", ",".join(map(str, HIDDEN)),
            "--n_atoms", str(ATOMS), "--bsize", str(BATCH), "--k",
            str(MESH_GATE_K), "--capacity", "4096"]
    return args + (["--out", str(out)] if out is not None else [])


def _ranks(argv_for, world: int = 2, timeout: float = 300.0) -> list[str]:
    """The ranks of a ``world``-process run on a free loopback port, each
    on cuda:0 of this host; their outputs (a rank that fails or hangs
    fails the phase, and every rank is stopped)."""
    port = _free_port()
    procs = [subprocess.Popen(
        argv_for(i) + ["--coordinator", f"127.0.0.1:{port}",
                       "--num_processes", str(world), "--process_id",
                       str(i)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, "ranks exited "
              f"{[q.returncode for q in procs]}; rank {i}:\n{out[-3000:]}"
              + "".join(f"\nrank {j}:\n{o[-1500:]}"
                        for j, o in enumerate(outs) if j != i))
    return outs


def _tagged_json(out: str, tag: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    check(len(lines) == 1, f"one {tag} line")
    return json.loads(lines[0][len(tag) + 1:])


def phase_mesh_check(dev, card: str) -> dict:
    """25b: ``python -m d4pg_tpu_torch.parallel.multihost_check --fused 1``
    as two ranks through ``--coordinator 127.0.0.1:P``, both on cuda:0
    (so gloo: NCCL refuses two ranks on one card), at the slice's width,
    two chunks of K = 3, B = 256: equal losses, replicas bitwise (the
    check all-reduces a CRC of the parameters), the descent K times a
    chunk on each rank; then the same check in this process with both
    shards local (``n_local = 2``) on the same rows and uniforms: losses
    within rtol 1e-5 and parameters within rtol 1e-4 / atol 1e-6 of the
    ranks'. The chunks are phase 25a's gate length: the two layouts
    average the gradients in another order, so their leaves part in the
    last bits after each write-back and a long run may sample a
    neighbouring slot (25a's K = 40 comparison shows how soon).
    Prints the backend and the host ms per grad step that the gradient
    average takes. Gloo stages every reduction through the host, so
    these rates say nothing of NCCL with a card per rank."""
    from d4pg_tpu_torch.parallel import RankMesh
    from d4pg_tpu_torch.parallel import multihost_check as mc

    npz = ROOT / "runs" / "chip_smoke" / "mesh_check.npz"
    npz.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    outs = _ranks(lambda i: [
        sys.executable, "-m", "d4pg_tpu_torch.parallel.multihost_check",
        *_mesh_check_args(npz if i == 0 else None)])
    wall = time.perf_counter() - t0
    res = [_tagged_json(out, "multihost_check RESULT") for out in outs]
    check(res[0]["losses"] == res[1]["losses"] and res[0]["crc"]
          == res[1]["crc"], f"25b: ranks agree ({res[0]['crc']}, "
          f"{res[1]['crc']})")
    check(all(r["backend"] == "gloo" for r in res),
          f"25b: two ranks on one card take gloo ({res[0]['backend']})")
    check(all(r["descent_launches"] == 2 * MESH_GATE_K for r in res),
          f"25b: the descent once per grad step on each rank "
          f"({[r['descent_launches'] for r in res]})")
    ns = mc.build_parser().parse_args(_mesh_check_args(None) + [
        "--coordinator", "-", "--num_processes", "1", "--process_id", "0",
        "--n_local", "2"])
    one = mc.run_check(ns, RankMesh.local(dev, 2))
    state = one.pop("state")
    loss_err = _rel_err(torch.tensor(one["losses"]),
                        torch.tensor(res[0]["losses"]))
    check(loss_err <= 1e-5, f"25b: one process vs two ranks, losses "
          f"({loss_err:.3e})")
    saved = np.load(npz)
    worst = 0.0
    for m in ("actor", "critic"):
        for n, t in getattr(state, m).state_dict().items():
            want = saved[f"{m}/{n}"]
            got = t.detach().cpu().numpy()
            check(np.allclose(got, want, rtol=1e-4, atol=1e-6),
                  f"25b: one process vs two ranks, {m}.{n}")
            worst = max(worst, float(np.max(np.abs(got - want))))
    grad_bytes = 4 * sum(p.numel() for m in (state.actor, state.critic)
                         for p in m.parameters())
    print(f"[mesh 25b] two ranks on one card: backend {res[0]['backend']}, "
          f"losses equal ({res[0]['losses'][-1]!r} last), parameter CRC "
          f"{res[0]['crc']} on both; one process with both shards: losses "
          f"max rel err {loss_err:.3e}, parameters max abs err "
          f"{worst:.3e}; the gradient average (gloo through the host, "
          f"{grad_bytes / 1e6:.3f} MB) "
          f"{[round(r['reduce_ms_per_step'], 3) for r in res]} ms of host "
          f"clock per grad step on ranks 0 and 1; {wall:.2f} s ({card})")
    return {"launches": sum(r["descent_launches"] for r in res),
            "reduce_ms_per_step": [r["reduce_ms_per_step"] for r in res],
            "grad_bytes": grad_bytes, "loss_err": loss_err,
            "param_abs_err": worst, "wall_s": wall}


def rank_driver(argv: list[str]) -> None:
    """One rank of phase 25c: ``train.main(argv)`` with the driver's
    timer and log hooked (``DriverHooks``) and the launch counters set to
    0 just before and read just after; prints a ``RANK_DRIVER`` JSON
    line. Runs as ``python -c "import chip_smoke; ..."``."""
    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig

    hooks = DriverHooks()
    zero_counts()
    result = driver.main(argv)
    torch.cuda.synchronize()
    per_cycle = ExperimentConfig().train_steps_per_cycle
    print("RANK_DRIVER " + json.dumps({
        "launches": launch_counts(),
        "own_grad_steps_per_sec": [per_cycle / s for s in hooks.spans],
        "critic_loss": result["critic_loss"]}), flush=True)


def phase_mesh_driver(card: str) -> dict:
    """25c: ``--data_parallel 2`` on this one-card machine is refused
    loudly (one card per rank), the refusal shown and caught as the
    expected outcome; then ``python -m d4pg_tpu_torch.train --env point``
    as two ranks through ``--coordinator`` on cuda:0 (gloo), fused replay
    on, two cycles with per-rank replay sidecars, then ``--resume 1`` from
    them: equal final losses on both ranks, each rank's sidecar, both
    resumed at step 80 with rows, the descent once per grad step of each
    rank; each rank's own grad-steps/s per cycle."""
    import shutil

    from d4pg_tpu_torch import train as driver
    from d4pg_tpu_torch.config import ExperimentConfig

    runs = ROOT / "runs" / "chip_smoke" / "mesh_driver"
    shutil.rmtree(runs, ignore_errors=True)
    refusal = None
    if torch.cuda.device_count() < 2:
        try:
            driver.train(ExperimentConfig(env="point", data_parallel=2,
                                          log_dir=str(runs)))
        except ValueError as e:  # the expected refusal, and nothing else
            refusal = str(e)
        check(refusal is not None and "one card per rank" in refusal,
              f"--data_parallel 2 on {torch.cuda.device_count()} card: "
              f"refused ({refusal})")
        print(f"[mesh 25c] --data_parallel 2 on one card, refused as "
              f"expected: {refusal}")
    # a shorter collect than the driver's default (5,000 warm-up steps,
    # 16 episodes a cycle) per rank: the ranks' grad steps are the point
    argv = ["--env", "point", "--n_eps", "1", "--n_cycles", "2",
            "--warmup", "1000", "--episodes_per_cycle", "4",
            "--replay_storage", "device", "--fused_replay", "on",
            "--checkpoint_replay", "1", "--checkpoint_replay_every", "1",
            "--log_dir", str(runs)]
    per_cycle = ExperimentConfig().train_steps_per_cycle
    out: dict = {"refusal": refusal, "runs": {}, "launches": 0}
    for tag, extra in (("train", []), ("resume", ["--resume", "1"])):
        t0 = time.perf_counter()
        outs = _ranks(lambda i: [
            sys.executable, "-c",
            "import sys, chip_smoke; chip_smoke.rank_driver(sys.argv[1:])",
            *argv, *extra])
        wall = time.perf_counter() - t0
        res = [_tagged_json(o, "RANK_DRIVER") for o in outs]
        check(res[0]["critic_loss"] == res[1]["critic_loss"],
              f"25c {tag}: both ranks end on one loss "
              f"({res[0]['critic_loss']}, {res[1]['critic_loss']})")
        for i, (o, r) in enumerate(zip(outs, res)):
            check("backend gloo" in o, f"25c {tag}: rank {i} names gloo")
            check(r["launches"] == {**{n: 0 for n in r["launches"]},
                                    "descent": 2 * per_cycle},
                  f"25c {tag}: rank {i}'s descent once per grad step "
                  f"({r['launches']})")
            out["launches"] += r["launches"]["descent"]
            if tag == "resume":
                check(f"[p{i}] resumed from step {2 * per_cycle} " in o,
                      f"25c: rank {i} resumed:\n{o[-2000:]}")
                rows = int(o.split(f"[p{i}] resumed from step")[1].split(
                    " replay rows")[0].rsplit(" ", 1)[1])
                check(rows > 0, f"25c: rank {i} resumed with rows ({rows})")
        if tag == "train":
            sidecars = sorted(p.name for p in runs.rglob("replay_p*.pkl"))
            check(sidecars == ["replay_p0.pkl", "replay_p1.pkl"],
                  f"25c: a sidecar per rank ({sidecars})")
        own = [[round(x, 2) for x in r["own_grad_steps_per_sec"]]
               for r in res]
        print(f"[mesh 25c] {tag}: own grad-steps/s per cycle, rank 0 "
              f"{own[0]}, rank 1 {own[1]}; final critic_loss "
              f"{res[0]['critic_loss']!r} on both; descent launches "
              f"{[r['launches']['descent'] for r in res]} in "
              f"{2 * per_cycle} grad steps each; {wall:.2f} s ({card})")
        out["runs"][tag] = {"own_grad_steps_per_sec": own, "wall_s": wall}
    return out


# --- the replica and model mesh axes (phases 26-27) ------------------------

REPLICA_NS = (1, 2, 4)  # replicas per group, all on cuda:0
REPLICA_ROUNDS = 2  # timed rounds of K grad steps per replica, per N
# 26b at the slice's width: a 65,536-row ring per arm's replica (the A/B
# times the aggregation, not the ring)
MESH_AB_ROWS, MESH_AB_ROUNDS = 65_536, 3
# phase 27: the reference's real pixel shape for the equivalence, and the
# pair at phase 15's width and batch
MODEL_K, MODEL_BATCH, MODEL_TIMED_STEPS = 2, 8, 8
EQUIV_RTOL, EQUIV_ATOL = 5e-4, 1e-6  # tests/test_mesh_pixels.py:48-49
# 27b's parameter bar at phase 15's width: the largest share of network
# elements outside rtol EQUIV_RTOL / atol EQUIV_ATOL of the single-device
# update; above the sound runs' shares (at most 0.0271), below the TF32
# control's (0.3229) (PERF.md §6, the model axis)
MODEL_FULL_OFF_SHARE = 0.1
# ... and against the same arithmetic in one process (each convolution as
# two halves): 0 in the one reading, above the ATen control's 1.4e-5
MODEL_SAME_OFF_SHARE = 1e-4
ADAM_EPS_PROBE = 1e-3  # 27b's probe of the cause (Adam's default: 1e-8)
# Phase 27 runs cuDNN's deterministic algorithms on both sides of every
# comparison (the ranks' checked updates and the single-device updates):
# with the default ones the same update twice in one process came 6,159
# elements apart beyond the bars above (PERF.md §6), so a gate against
# the same arithmetic could fail on the repeat alone. 27b's timed steps
# run the default algorithms, as the driver's model axis does.


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms for the body; the setting found
    before it is put back after."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def _trees_equal(a, b) -> bool:
    return all(_trees_equal(a[k], b[k]) if isinstance(a[k], dict)
               else torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _stack_trees(trees):
    first = trees[0]
    return {k: _stack_trees([t[k] for t in trees]) if isinstance(first[k],
                                                                 dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def _host_merge(trees, mode):
    """The host ``Aggregator`` fed one round-synchronous round of
    ``params_of`` trees (replica i at lag i; sync: the barrier)."""

    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.learner.aggregator import Aggregator

    agg = Aggregator(WeightStore(), mode=mode)
    epochs = [agg.register(i) for i in range(len(trees))]
    if mode == "sync":
        submits = _Threads()
        for i in range(len(trees)):
            submits.start(agg.submit, i, epochs[i], trees[i], 0, daemon=True)
        submits.join(timeout=120.0)
    else:
        for i, tree in enumerate(trees):
            agg.submit(i, epochs[i], tree, 0)
    merged = agg.current()[1]
    agg.close()
    return merged


def _max_rel(a, b) -> float:
    worst = 0.0
    for k in a:
        if isinstance(a[k], dict):
            worst = max(worst, _max_rel(a[k], b[k]))
        else:
            worst = max(worst, _rel_err(a[k].cpu(), b[k].cpu()))
    return worst


def _profile_merge(group) -> dict:
    """Three more ``merge()`` calls (each with its publish). The first
    runs with CUDA's sync debug mode at ``error``, so any stream sync or
    blocking copy to the host inside it raises, queued behind a sleep
    kernel between CUDA events: its device span and the host's enqueue
    ms. The second runs under ``io/profiling.TransferSentinel``: the
    operators that moved card values to the host, non-blocking copies
    included (``d2h``); a non-blocking copy into pinned memory under
    another sentinel first shows that it counts one. The third runs under the profiler: its
    kernels and copies and their device time, ``None`` where the profiler
    recorded no device event (late in a long run it may not)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.02 * 2e9))
    start.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        group.merge()
        host_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    queued = not start.query()
    end.record()
    end.synchronize()
    span_ms = start.elapsed_time(end) if queued else None
    from d4pg_tpu_torch.io.profiling import TransferSentinel

    probe = torch.ones(8, device=group.devices[0])
    with TransferSentinel() as control:
        torch.empty(8, pin_memory=True).copy_(probe, non_blocking=True)
    check(control.d2h == 1, f"[replicas 26a] the host-copy counter "
          f"counts a non-blocking copy to pinned memory "
          f"({control.crossings})")
    with TransferSentinel() as copies:
        group.merge()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        group.merge()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if not e.is_user_annotation]
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    return {"span_ms": span_ms, "host_ms": host_ms, "syncs": 0,
            "d2h": copies.d2h, "d2h_ops": [
                op for way, op, _ in copies.crossings if way == "d2h"],
            "device_ms": sum(e.time_range.elapsed_us() for e in on_device)
            / 1e3 if on_device else None,
            "kernels": len(on_device) if on_device else None,
            "profiler_d2h": (sum(1 for e in on_device if "DtoH" in e.name)
                             if on_device else None)}


def phase_replica_group(dev, card: str) -> dict:
    """26a: ``MeshReplicaGroup`` at the slice's width (Humanoid: obs 376,
    act 17, 256x3, 51 atoms on [0, 800], ``pallas_ce``), B = 256, one
    200,000-row ring shared read-only by the replicas, K = 40, at N = 1,
    2 and 4 replicas all on cuda:0. Per N, from the same states (the
    driver's ``replica_state``): N independent ``FusedLoop``s (each over
    its own copy of the trees) and the group's engine for one chunk: each
    replica's networks bitwise its loop's, the descent and the CE kernels
    exactly N x K times; the group's async merge bitwise the host
    ``Aggregator`` fed ``params_of`` of the loops' states (N = 1: the
    identity), every replica adopting it; the async merge of the same
    stacks on the card bitwise the CPU's, the sync merge within rtol 1e-6
    of the host barrier's. Then ``REPLICA_ROUNDS`` timed rounds (grad
    steps, then the merge and its publish through a store): own
    grad-steps/s per replica and for all N, merge ms per round to the
    card's completion, launches; ``_profile_merge``: a merge under CUDA's
    sync debug mode (a stream sync or a blocking host copy raises), its
    device span and host ms, a merge under ``TransferSentinel`` (0 operators
    that move card values to the host), then a profiled merge's kernels
    and device ms. Peak device memory over the rounds,
    and the group's own part of it, under a ring's size (the group holds
    the buffer's own storage: the ring counted once)."""
    from types import SimpleNamespace

    from d4pg_tpu_torch.distributed.weights import WeightStore
    from d4pg_tpu_torch.learner.loop import FusedLoop
    from d4pg_tpu_torch.learner.mesh_replicas import (MeshReplicaGroup,
                                                      make_collective_merge)
    from d4pg_tpu_torch.learner.replica import params_of, replica_state
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.replay import device_per as dper
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    cfg = config("pallas_ce")
    kernels = fused_kernels("pallas_ce")
    t0 = time.perf_counter()
    buf = FusedDeviceReplay(CAPACITY, OBS, ACT, alpha=0.6, device=dev)
    rng = np.random.default_rng(26)
    for start in range(0, CAPACITY, FILL_BLOCK):
        buf.add(random_rows(rng, min(FILL_BLOCK, CAPACITY - start)))
        buf.drain()
    torch.cuda.synchronize()
    ring_bytes = sum(t.numel() * t.element_size() for t in buf.storage)
    print(f"[replicas 26a] ring filled: {buf.size} rows, "
          f"{ring_bytes / 1e9:.3f} GB, {time.perf_counter() - t0:.2f} s")

    def states(n):
        base = init_state(cfg, seed=0, device=dev)
        return [replica_state(base, i, 0) for i in range(n)]

    def expect(steps):
        return {name: steps if name in kernels else 0
                for name in launch_counts()}

    out: dict = {"launches": {name: 0 for name in launch_counts()},
                 "runs": {}, "ring_bytes": ring_bytes}
    for n in REPLICA_NS:
        # the oracles: independent loops, each over its own trees
        legacy = []
        for st in states(n):
            view = SimpleNamespace(
                storage=buf.storage, size=buf.size,
                trees=dper.PerTrees(*[t.clone() for t in buf.trees]))
            FusedLoop(cfg, view, k=K, batch_size=BATCH,
                      generator=st.generator).run(st, K)
            legacy.append(params_of(st))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)  # the ring among it
        group = MeshReplicaGroup(
            cfg, states(n), k=K, batch_size=BATCH, mode="async",
            store=WeightStore(), extract=lambda tree: tree["actor_params"])
        group.load(buf)
        check(group._storage[dev].obs.data_ptr()
              == buf.storage.obs.data_ptr(),
              "[replicas 26a] the group shares the ring's storage")
        zero_counts()
        group._fused_steps(K)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == expect(n * K), f"[replicas 26a] N = {n}: launches "
              f"{counts}, expected {expect(n * K)}")
        for name in counts:
            out["launches"][name] += counts[name]
        for i in range(n):
            check(_trees_equal(params_of(group.state_slice(i)), legacy[i]),
                  f"[replicas 26a] N = {n}: replica {i}'s stream bitwise "
                  "its FusedLoop's")
        stacks = {where: _stack_trees([_tree_to(t, where) for t in legacy])
                  for where in ("cpu", dev)}
        card_async = make_collective_merge(n, "async")(stacks[dev])
        check(_trees_equal(card_async,
                           make_collective_merge(n, "async")(stacks["cpu"])),
              f"[replicas 26a] N = {n}: the card's async merge bitwise "
              "the CPU's on the same stacks")
        sync_err = _max_rel(make_collective_merge(n, "sync")(stacks[dev]),
                            _host_merge(legacy, "sync"))
        check(sync_err <= 1e-6, f"[replicas 26a] N = {n}: sync merge "
              f"within rtol 1e-6 of the host barrier's ({sync_err:.3e})")
        group.merge()
        merged = group.merged_params()
        check(_trees_equal(merged, _host_merge(legacy, "async")),
              f"[replicas 26a] N = {n}: the group's async merge bitwise "
              "the host Aggregator's")
        for i in range(n):
            check(_trees_equal(params_of(group.state_slice(i)), merged),
                  f"[replicas 26a] N = {n}: replica {i} adopted the merge")
        rates, merge_ms, enqueue_ms = [], [], []
        for _ in range(REPLICA_ROUNDS):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group._fused_steps(K)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            group.merge()
            enqueue_ms.append(1e3 * group.last_merge_s)
            torch.cuda.synchronize()
            merge_ms.append(1e3 * (time.perf_counter() - t1))
            rates.append(K / (t1 - t0))
            counts = launch_counts()
            check(counts == expect(n * K), f"[replicas 26a] N = {n} timed "
                  f"round: launches {counts}")
            for name in counts:
                out["launches"][name] += counts[name]
        prof = _profile_merge(group)  # raises on a sync or a host copy
        check(prof["d2h"] == 0 and prof["profiler_d2h"] in (0, None),
              f"[replicas 26a] N = {n}: the merge copied to the host "
              f"({prof})")
        peak = torch.cuda.max_memory_allocated(dev)
        check(peak - base < ring_bytes, f"[replicas 26a] N = {n}: the "
              f"group allocated {(peak - base) / 1e9:.3f} GB over what was "
              f"live, a ring's worth or more")
        check(group.versions == sorted(group.versions)
              and len(group.versions) == REPLICA_ROUNDS + 4,
              f"[replicas 26a] N = {n}: versions {group.versions}")
        group.close()
        del group, legacy, stacks, card_async
        torch.cuda.empty_cache()
        run = {"own_grad_steps_per_s": rates,
               "all_grad_steps_per_s": [n * r for r in rates],
               "merge_ms": merge_ms, "merge_enqueue_ms": enqueue_ms,
               "merge_profile": prof, "peak_bytes": peak,
               "group_bytes": peak - base, "sync_rel_err": sync_err}
        out["runs"][n] = run
        print(f"[replicas 26a] N = {n} on cuda:0: streams bitwise "
              f"{n} FusedLoops; async merge bitwise the host Aggregator "
              f"and the CPU; sync within {sync_err:.3e}; own grad-steps/s "
              f"per replica {[round(x, 2) for x in rates]}, all replicas "
              f"{[round(n * x, 2) for x in rates]}; merge to completion "
              f"{[round(x, 3) for x in merge_ms]} ms (enqueue "
              f"{[round(x, 3) for x in enqueue_ms]} ms); a merge under "
              f"the sync check: device span {prof['span_ms']} ms behind a "
              f"sleep, host enqueue {prof['host_ms']:.3f} ms, stream syncs "
              f"0; operators moving card values to the host "
              f"{prof['d2h']}; profiled: {prof['device_ms']} ms of device "
              f"in {prof['kernels']} kernels and copies, D2H copies "
              f"{prof['profiler_d2h']} (None: no device event recorded); "
              f"peak device memory {peak / 1e9:.3f} GB, of which "
              f"{(peak - base) / 1e9:.3f} GB over what was live before the "
              f"group (the {ring_bytes / 1e9:.3f} GB ring among it, "
              f"counted once) ({card})")
    del buf
    torch.cuda.empty_cache()
    return out


def phase_mesh_ab(dev, card: str) -> dict:
    """26b: ``run_mesh_ab`` at the reference's ``MeshABConfig`` (obs 8,
    32x32, N = 2, 6 timed rounds of 8 steps at K = 4, B = 32), then at the
    slice's width (obs 376, act 17, 256x3, B = 256, K = 40, N = 2,
    MESH_AB_ROUNDS rounds of 40 steps, 65,536-row rings); both under the
    port's default arm, ``pallas`` (the projection kernel and the descent
    once per replica per grad step, in both arms). Prints
    both arms' updates/s and aggregation latency p50 and p95; the A/B is
    a measured claim of the reference, printed and not asserted."""
    from d4pg_tpu_torch.fleet.mesh_ab import MeshABConfig, run_mesh_ab
    from d4pg_tpu_torch.obs.registry import REGISTRY

    crashes = REGISTRY.counter("threads.contained_crashes").value
    out = {"launches": {name: 0 for name in launch_counts()}, "rows": {}}
    for tag, cfg in (
            ("reference", MeshABConfig()),
            ("slice", MeshABConfig(
                n_replicas=2, rounds=MESH_AB_ROUNDS, steps_per_round=K,
                k=K, batch_size=BATCH, n_rows=MESH_AB_ROWS, obs_dim=OBS,
                act_dim=ACT, hidden=HIDDEN))):
        zero_counts()
        t0 = time.perf_counter()
        row = run_mesh_ab(cfg, device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        # both arms, the warm-up round included: the projection kernel
        # and the descent once per replica per grad step
        steps = 2 * cfg.n_replicas * (cfg.rounds + 1) * cfg.steps_per_round
        check(counts == {**{n: 0 for n in counts}, "projection": steps,
                         "descent": steps},
              f"[mesh A/B {tag}] launches {counts}, expected {steps} each")
        for name in counts:
            out["launches"][name] += counts[name]
        check(row["socket"]["updates_per_sec"] > 0
              and row["collective"]["updates_per_sec"] > 0
              and REGISTRY.counter("threads.contained_crashes").value
              == crashes, f"[mesh A/B {tag}] both arms trained, no "
              "replica thread crashed")
        out["rows"][tag] = row
        lat = {arm: row[arm]["agg_latency_s"] for arm in ("socket",
                                                         "collective")}
        print(f"[mesh A/B {tag}] N = {row['n_replicas']}: updates/s socket "
              f"{row['socket']['updates_per_sec']}, collective "
              f"{row['collective']['updates_per_sec']} (x"
              f"{row['speedup_updates_per_sec']}); aggregation latency "
              f"p50 / p95 socket {lat['socket']['p50']!r} / "
              f"{lat['socket']['p95']!r} s, collective "
              f"{lat['collective']['p50']!r} / {lat['collective']['p95']!r}"
              f" s (ratio p50 {row['agg_latency_ratio_p50']}); launches "
              f"{counts}; {time.perf_counter() - t0:.2f} s ({card})")
    return out


def phase_replica_driver(card: str, hooks: DriverHooks) -> dict:
    """26c: ``train.main --env point --learners 2 --data_parallel 2
    --fused_replay off --agg_transport auto`` at the default widths (a
    shortened collect, as 25c's): one process (the collective transport
    needs no second card), the banner names mesh-native replicas; two
    cycles, then ``--resume 1`` for one: versions published monotone,
    both replicas' grad steps counted (20 per cycle each), the resumed
    run from step 40; own grad-steps/s per cycle. The mesh arm projects
    with einsum and samples host trees: no kernel launches."""
    import shutil

    from d4pg_tpu_torch import train as driver

    runs = ROOT / "runs" / "chip_smoke" / "replica_driver"
    shutil.rmtree(runs, ignore_errors=True)
    argv = ["--env", "point", "--learners", "2", "--data_parallel", "2",
            "--fused_replay", "off", "--agg_transport", "auto",
            "--warmup", "1000", "--episodes_per_cycle", "4"]
    seen = {}
    build = driver.mesh_replica_group

    def capture(*args, **kwargs):
        seen["group"] = build(*args, **kwargs)
        return seen["group"]

    driver.mesh_replica_group = capture
    out: dict = {"runs": {}, "launches": {name: 0 for name in
                                          launch_counts()}}
    try:
        for tag, extra in (("train", ["--n_cycles", "2"]),
                           ("resume", ["--n_cycles", "1", "--resume", "1"])):
            tee = _Tee()
            with contextlib.redirect_stdout(tee):
                result, counts, own, cycles, wall = _driver_run(
                    hooks, driver, f"replicas {tag}", [*argv, *extra], runs)
            said = tee.buf.getvalue()
            group = seen.pop("group")
            n_cycles = 2 if tag == "train" else 1
            check("2 mesh-native replicas (collective merge)" in said,
                  f"26c {tag}: the banner")
            check(group.steps_done == n_cycles * 20
                  and group.rounds == n_cycles,
                  f"26c {tag}: grad steps {group.steps_done}, rounds "
                  f"{group.rounds}")
            first = 0 if tag == "train" else 40
            steps = [group.state_slice(i).step for i in range(2)]
            check(steps == [first + n_cycles * 20] * 2,
                  f"26c {tag}: replica steps {steps}")
            check(group.versions == list(range(2, 2 + n_cycles)),
                  f"26c {tag}: versions {group.versions}")
            if tag == "resume":
                check("resumed from step 40" in said, "26c: resumed")
            for name in counts:
                out["launches"][name] += counts[name]
            out["runs"][tag] = {"own_grad_steps_per_sec": own,
                                "wall_s": wall}
            print(f"[replicas 26c] {tag}: own grad-steps/s per cycle "
                  f"{[round(x, 2) for x in own]} (2 replicas x 20 steps a "
                  f"cycle), versions {group.versions}, replica steps "
                  f"{steps}, final critic_loss {result['critic_loss']!r}; "
                  f"launches {counts}; {wall:.2f} s ({card})")
    finally:
        driver.mesh_replica_group = build
    return out


def _model_axis_config(timed: bool, device):
    """27b: phase 15's pixel model at full width under the mesh arm
    (einsum). 27a: the reference's equivalence config
    (``tests/test_mesh_pixels.py::_pixel_config`` at the real shape:
    ``pixel-point`` with frame stack 3, encoder width 8, hidden 16x16, 11
    atoms on [-10, 10], act 2, DrQ pad 4, shared encoder, data parallel
    2), where its bars were measured."""
    import dataclasses

    from d4pg_tpu_torch.config import ExperimentConfig

    if timed:
        return dataclasses.replace(pixel_config("float32"),
                                   projection="einsum")
    return ExperimentConfig(
        env="pixel-point", share_encoder=True, frame_stack=3,
        augment="shift", augment_pad=4, encoder_width=8,
        batch_size=MODEL_BATCH, n_atoms=11, v_min=-10.0, v_max=10.0,
        hidden=(16, 16), data_parallel=2).learner_config(
            PIXEL_SHAPE, 2, device=device)


def _set_adam_eps(state, eps: float) -> None:
    for opt in (state.actor_opt, state.critic_opt):
        for group in opt.param_groups:
            group["eps"] = eps


def model_axis_rank(mesh, dev, seed, fields, w, draws, timed_steps,
                    eps_probe):
    """One rank of phase 27 (``model_axis_main``: a process on ``dev``;
    gloo, since the ranks share one card): the whole state from ``seed``,
    replicated then split over the model axis, the K-step update on this
    rank's data block, the networks gathered whole; host seconds in the
    model-axis and data-axis collectives per grad step. Then (27a) one
    sharded fused chunk over this data row's shards, the descent counted;
    or (27b, ``timed_steps``) the same update from a fresh state with
    Adam's epsilon at ``eps_probe``, gathered, then ``timed_steps`` more
    grad steps of the first state, timed. The checked updates run cuDNN's
    deterministic algorithms, the timed steps the default ones."""
    from d4pg_tpu_torch.learner.fused import make_sharded_fused_chunk
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.learner.update import UpdateDraws
    from d4pg_tpu_torch.parallel import (make_sharded_multi_update,
                                         replicate_state, shard_stacked)
    from d4pg_tpu_torch.parallel.model_axis import gather_state
    from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    cfg = _model_axis_config(bool(timed_steps), dev)
    update = make_sharded_multi_update(cfg, mesh)
    batches = shard_stacked(TransitionBatch(**{
        f: torch.from_numpy(v) for f, v in fields.items()}), mesh)
    wl = shard_stacked(torch.from_numpy(w), mesh)
    dl = shard_stacked(UpdateDraws(**{
        n: None if v is None else torch.from_numpy(v)
        for n, v in draws.items()}), mesh)
    k = w.shape[0]

    def gathered(state):
        return {m: {n: t.numpy() for n, t in ps.items()}
                for m, ps in gather_state(state, mesh).items()}

    state = replicate_state(init_state(cfg, seed, dev), mesh)
    mesh.comm_s.update(model=0.0, data=0.0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with _deterministic_cudnn():
        metrics = update(state, batches, wl, draws=dl)
        torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    result = {"coords": (mesh.data_index, mesh.model_index),
              "metrics": {n: v.cpu().numpy() for n, v in metrics.items()},
              "comm_ms_per_step": {a: 1e3 * s / k
                                   for a, s in mesh.comm_s.items()},
              "first_s": first_s,
              "local_conv1": tuple(state.critic.encoder.conv1.weight.shape),
              "tied": _encoders_tied(state), "params": gathered(state)}
    if timed_steps:
        probe = replicate_state(init_state(cfg, seed, dev), mesh)
        _set_adam_eps(probe, eps_probe)
        with _deterministic_cudnn():
            update(probe, batches, wl, draws=dl)
        result["eps_probe_params"] = gathered(probe)
        del probe
        mesh.comm_s.update(model=0.0, data=0.0)
        rates = []
        for _ in range(timed_steps // k):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            update(state, batches, wl, draws=dl)
            torch.cuda.synchronize(dev)
            rates.append(k / (time.perf_counter() - t0))
        result["grad_steps_per_s"] = rates
        result["comm_ms_per_step"] = {a: 1e3 * s / timed_steps
                                      for a, s in mesh.comm_s.items()}
        return result
    # the sharded fused chunk on the {data, model} mesh: this data row's
    # shard, the same rows and slots on both model ranks
    buf = ShardedFusedReplay(64 * mesh.data_size, PIXEL_SHAPE, cfg.act_dim,
                             mesh, alpha=0.6, obs_dtype=np.uint8)
    buf.add(pixel_rows(np.random.default_rng(270 + mesh.data_index), 64,
                       cfg.act_dim))
    buf.drain()
    chunk = make_sharded_fused_chunk(cfg, mesh, k=k,
                                     batch_size=w.shape[1])
    zero_counts()
    with _deterministic_cudnn():
        _, m = chunk(state, buf.trees, buf.storage, buf.size,
                     generator=torch.Generator(device=dev).manual_seed(
                         270 + mesh.data_index))
        torch.cuda.synchronize(dev)
    result["chunk_launches"] = launch_counts()
    result["chunk_idx"] = m["idx"].cpu().numpy()
    result["chunk_finite"] = bool(torch.isfinite(m["critic_loss"]).all())
    return result


def model_axis_main(argv: list[str]) -> None:
    """One rank of phase 27 through the coordinator route, as 25b's
    ranks: ``python -c "import sys, chip_smoke;
    chip_smoke.model_axis_main(sys.argv[1:])" IN OUT --coordinator H:P
    --num_processes W --process_id r``. Joins the group, builds the
    ``{data, model}`` mesh (two ranks a data row) on the device named in
    IN (cuda:0 for every rank: they share the card), runs
    ``model_axis_rank`` on IN's arguments and pickles its result to
    ``OUT.<r>``."""
    import argparse
    import pickle

    from d4pg_tpu_torch.parallel import multihost

    parser = argparse.ArgumentParser()
    parser.add_argument("inp")
    parser.add_argument("out")
    parser.add_argument("--coordinator")
    parser.add_argument("--num_processes", type=int)
    parser.add_argument("--process_id", type=int)
    ns = parser.parse_args(argv)
    with open(ns.inp, "rb") as f:
        dev, *args = pickle.load(f)
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    multihost.initialize(ns.coordinator, ns.num_processes, ns.process_id)
    try:
        mesh = multihost.global_mesh(dev, model_parallel=2)
        result = model_axis_rank(mesh, dev, *args)
    finally:
        multihost.shutdown()
    with open(f"{ns.out}.{ns.process_id}", "wb") as f:
        pickle.dump(result, f)


def _model_axis_ranks(world: int, dev, args: tuple, tag: str) -> list:
    """``world`` ranks of ``model_axis_main`` on ``dev``, their results in
    rank order."""
    import pickle

    io = ROOT / "runs" / "chip_smoke" / f"model_axis_{tag}"
    io.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{io}.in", "wb") as f:
        pickle.dump((str(dev), *args), f)
    _ranks(lambda i: [
        sys.executable, "-c",
        "import sys, chip_smoke; chip_smoke.model_axis_main(sys.argv[1:])",
        f"{io}.in", f"{io}.out"], world=world)
    outs = []
    for r in range(world):
        with open(f"{io}.out.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _single_update(cfg, dev, fields, w, draws, eps: float | None = None,
                   tf32: bool = False, cudnn: bool = True,
                   halves: bool = False):
    """The single-device ``multi_update_step`` from the state of seed 0
    on ``dev``: its state, its networks as numpy and its metrics. ``eps``
    sets Adam's epsilon; ``tf32`` lets convolutions and matmuls round
    their operands to TF32 (the lower-precision control); ``cudnn=False``
    runs the convolutions through ATen's own kernels (another algorithm
    for the same float32 math); cuDNN runs its deterministic algorithms,
    as the ranks' checked updates do; ``halves`` computes each encoder
    convolution as its two halves of out-channels joined, the
    arithmetic of the model axis at two ranks in one process."""
    from types import SimpleNamespace

    import d4pg_tpu_torch.models.encoder as encoder_module
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.learner.update import multi_update_step
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    state = init_state(cfg, 0, dev)
    if eps is not None:
        _set_adam_eps(state, eps)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.enabled = cudnn
    torch.backends.cudnn.deterministic = True  # as the ranks check
    conv = encoder_module.conv_same

    def conv_halves(layer, x, pads, dtype):
        n = layer.weight.shape[0] // 2
        return torch.cat([conv(SimpleNamespace(
            weight=layer.weight[part], bias=layer.bias[part],
            stride=layer.stride), x, pads, dtype)
            for part in (slice(0, n), slice(n, None))], 1)

    if halves:
        encoder_module.conv_same = conv_halves
    try:
        metrics = multi_update_step(
            cfg, state, TransitionBatch(**{
                f: torch.from_numpy(v).to(dev) for f, v in fields.items()}),
            torch.from_numpy(w).to(dev),
            type(draws)(*[None if d is None else d.to(dev) for d in draws]))
        torch.cuda.synchronize(dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled,
         torch.backends.cudnn.deterministic) = flags
        encoder_module.conv_same = conv
    params = {m: {n: t.detach().cpu().numpy() for n, t in
                  getattr(state, m).state_dict().items()}
              for m in ("actor", "critic", "target_actor", "target_critic")}
    return state, params, {n: v.cpu().numpy() for n, v in metrics.items()}


def _trees_bitwise(got: dict, want: dict) -> bool:
    return all(np.array_equal(got[m][n], a) for m, ps in want.items()
               for n, a in ps.items())


def _param_err(got: dict, want: dict) -> tuple[float, int, float]:
    """Max abs error over every network tensor, how many elements lie
    outside rtol ``EQUIV_RTOL`` / atol ``EQUIV_ATOL``, and their share."""
    worst, off, total = 0.0, 0, 0
    for m, ps in want.items():
        for n, a in ps.items():
            d = np.abs(got[m][n] - a)
            worst = max(worst, float(d.max()))
            off += int((d > EQUIV_ATOL + EQUIV_RTOL * np.abs(a)).sum())
            total += a.size
    return worst, off, off / total


def _adam_scale_of_off(got: dict, want: dict, state, cfg, k: int) -> dict:
    """Where ``got`` leaves the reference's bars around ``want``: Adam's
    bias-corrected second-moment root over its epsilon, sqrt(v_hat) /
    1e-8, at those elements (from ``state``, the single-device update
    after ``k`` steps), beside the same over every element. A target
    network's tensor takes the moments of its trained network's, and the
    actor's encoder (a detached copy of the critic's) the critic's."""
    scale = {}
    for attr, opt in (("actor", state.actor_opt),
                      ("critic", state.critic_opt)):
        for n, p in getattr(state, attr).named_parameters():
            v = opt.state[p]["exp_avg_sq"] / (1 - cfg.adam_b2 ** k)
            scale[attr, n] = (v.sqrt() / 1e-8).cpu().numpy()
    off_ratios, all_ratios = [], []
    for m, ps in want.items():
        for n, a in ps.items():
            trained = "critic" if n.startswith("encoder.") else m.replace(
                "target_", "")
            r = scale.get((trained, n))
            if r is None:  # a buffer, not a parameter
                continue
            off = (np.abs(got[m][n] - a)
                   > EQUIV_ATOL + EQUIV_RTOL * np.abs(a))
            off_ratios.append(r[off])
            all_ratios.append(r.ravel())
    off_r = np.concatenate(off_ratios)
    all_r = np.concatenate(all_ratios)
    return {"n_off": int(off_r.size),
            # shares with a zero gradient on both steps, and with
            # sqrt(v_hat) under eps (|g| < 1e-8: Adam's step ~ lr g / eps)
            "off_zero": float((off_r == 0).mean()) if off_r.size else None,
            "off_below_eps": float((off_r < 1).mean()) if off_r.size
            else None,
            "all_zero": float((all_r == 0).mean()),
            "all_below_eps": float((all_r < 1).mean()),
            "all_median": float(np.median(all_r))}


def phase_model_axis(dev, card: str, pixel: dict) -> dict:
    """27: the model axis on the card, its ranks started as 25b's are
    (the coordinator route, every rank on cuda:0, so gloo; every join
    under a deadline). (a) ``{data 2, model 2}``, four ranks, at the real
    pixel shape (84x84x9) with the reference's equivalence config
    (``_model_axis_config``: encoder width 8, hidden 16x16, 11 atoms, act
    2, DrQ pad 4, shared encoder, einsum), K = 2, batch 8: from the state
    of seed 0 and the same chunk (rows, IS weights, DrQ offsets) as a
    single-device ``multi_update_step`` on the card, every gathered
    network within rtol 5e-4 / atol 1e-6 of it, the losses too, the four
    ranks' networks bitwise equal, the encoders tied bitwise, each conv
    slice 4 of 8 channels; the host ms per grad step of the model-axis
    gathers and gradient sums and of the data-axis averages; then one
    sharded fused chunk per rank (the descent once per grad step, the
    model ranks of a row on the same slots). (b) ``{data 1, model 2}`` at
    phase 15's width (encoder 32, so 16 channels a rank; 256x3, 51 atoms,
    act 6) and batch (256), einsum, K = 2, held the same way against the
    single-device update at that width: the losses within rtol 5e-4 /
    atol 1e-6, the two ranks bitwise, the encoders tied, and at most a
    share ``MODEL_SAME_OFF_SHARE`` of the network elements outside rtol
    5e-4 / atol 1e-6 of the same arithmetic in one process (the
    single-device update with each convolution computed as its two
    halves of out-channels joined). Against the unsplit update
    the channel-split convolutions sum in another order and Adam's first
    steps (lr g / (sqrt(v_hat) + eps)) magnify that: the share of network
    elements outside rtol 5e-4 / atol 1e-6 must stay under
    ``MODEL_FULL_OFF_SHARE`` for the split, the halves and two more sound
    controls (the same rows in another order; ATen's convolutions in
    place of cuDNN's) and exceed it for the TF32 control (TF32
    convolutions and matmuls); and with Adam's epsilon at
    ``ADAM_EPS_PROBE`` on both sides no element may lie outside. Printed
    beside them: Adam's sqrt(v_hat) / eps where the split is outside.
    Then
    ``MODEL_TIMED_STEPS`` grad steps timed: grad-steps/s beside phase
    15's float32 arm in this call. Every number is printed before the
    gates run."""

    def chunk_of(rng, k, batch, act):
        flat = pixel_rows(rng, k * batch, act)
        fields = {f: np.asarray(v).reshape(k, batch, *np.shape(v)[1:])
                  for f, v in flat._asdict().items()}
        w = rng.uniform(0.2, 1.0, (k, batch)).astype(np.float32)
        draws = _draws(rng, k, batch, pad=4)
        return fields, w, draws

    def np_draws(draws):
        return {n: None if v is None else v.numpy()
                for n, v in draws._asdict().items()}

    def gate_ranks(tag, outs, want_m, cfg):
        conv1 = (cfg.encoder_channels[0] // 2, PIXEL_SHAPE[-1], 3, 3)
        for r, res in enumerate(outs):
            check(res["coords"] == (r // 2, r % 2), f"{tag}: rank {r} coords")
            check(res["local_conv1"] == conv1,
                  f"{tag}: rank {r}'s conv1 slice {res['local_conv1']}")
            check(res["tied"], f"{tag}: rank {r}'s encoders tied")
            for m, ps in res["params"].items():
                for n, a in ps.items():
                    check(np.array_equal(a, outs[0]["params"][m][n]),
                          f"{tag}: rank {r} {m}.{n} bitwise rank 0's")
            enc = {n: a for n, a in res["params"]["actor"].items()
                   if n.startswith("encoder.")}
            check(all(np.array_equal(a, res["params"]["critic"][n])
                      for n, a in enc.items()),
                  f"{tag}: rank {r}'s gathered encoders tied bitwise")
            for name in ("critic_loss", "actor_loss", "q_mean"):
                check(np.allclose(res["metrics"][name], want_m[name],
                                  rtol=EQUIV_RTOL, atol=EQUIV_ATOL),
                      f"{tag}: rank {r} {name}")

    rng = np.random.default_rng(27)
    cfg = _model_axis_config(False, dev)
    fields, w, draws = chunk_of(rng, MODEL_K, MODEL_BATCH, cfg.act_dim)
    _, want, want_m = _single_update(cfg, dev, fields, w, draws)
    t0 = time.perf_counter()
    outs = _model_axis_ranks(4, dev, (0, fields, w, np_draws(draws), 0,
                                      None), "a")
    wall_a = time.perf_counter() - t0
    worst, off, _ = _param_err(outs[0]["params"], want)
    launches = {name: 0 for name in launch_counts()}
    for res in outs:
        for name in launches:
            launches[name] += res["chunk_launches"][name]
    comm = [{a: round(v, 3) for a, v in r["comm_ms_per_step"].items()}
            for r in outs]
    print(f"[model axis 27a] {{data 2, model 2}} on {dev} (gloo), 84x84x9, "
          f"K = {MODEL_K}, B = {MODEL_BATCH}, against the single-device "
          f"update: networks max abs err {worst:.3e}, {off} elements "
          f"beyond rtol {EQUIV_RTOL} / atol {EQUIV_ATOL}; host ms per grad "
          f"step in collectives (model gathers and sums / data averages) "
          f"per rank {comm}; first update "
          f"{[round(r['first_s'], 3) for r in outs]} s; sharded chunk "
          f"descents {launches['descent']}; {wall_a:.2f} s ({card})")
    gate_ranks("27a", outs, want_m, cfg)
    check(off == 0, f"27a: every network within rtol {EQUIV_RTOL} / atol "
          f"{EQUIV_ATOL} of the single-device update")
    for r, res in enumerate(outs):
        check(res["chunk_finite"] and res["chunk_launches"] == {
            **{n: 0 for n in res["chunk_launches"]}, "descent": MODEL_K},
            f"27a: rank {r}'s sharded chunk: launches "
            f"{res['chunk_launches']}")
    for d in range(2):
        check(np.array_equal(outs[2 * d]["chunk_idx"],
                             outs[2 * d + 1]["chunk_idx"]),
              f"27a: data row {d}'s model ranks drew the same slots")

    full = _model_axis_config(True, dev)
    bf, bw, bd = chunk_of(rng, MODEL_K, BATCH, PIXEL_ACT)
    perm = rng.permutation(BATCH)
    single, want_b, want_bm = _single_update(full, dev, bf, bw, bd)
    _, rows, _ = _single_update(
        full, dev, {f: v[:, perm] for f, v in bf.items()}, bw[:, perm],
        type(bd)(*[None if d is None else d[:, perm] for d in bd]))
    _, no_cudnn, _ = _single_update(full, dev, bf, bw, bd, cudnn=False)
    _, halves, _ = _single_update(full, dev, bf, bw, bd, halves=True)
    _, control, _ = _single_update(full, dev, bf, bw, bd, tf32=True)
    _, want_eps, _ = _single_update(full, dev, bf, bw, bd,
                                    eps=ADAM_EPS_PROBE)
    t0 = time.perf_counter()
    pair = _model_axis_ranks(2, dev, (0, bf, bw, np_draws(bd),
                                      MODEL_TIMED_STEPS, ADAM_EPS_PROBE),
                             "b")
    wall_b = time.perf_counter() - t0
    errs = {"split": _param_err(pair[0]["params"], want_b),
            "rows": _param_err(rows, want_b),
            "aten": _param_err(no_cudnn, want_b),
            "halves": _param_err(halves, want_b),
            "split_halves": _param_err(pair[0]["params"], halves),
            "tf32": _param_err(control, want_b),
            "eps": _param_err(pair[0]["eps_probe_params"], want_eps)}
    cause = _adam_scale_of_off(pair[0]["params"], want_b, single, full,
                               MODEL_K)
    loss_err = max(_rel_err(torch.as_tensor(pair[0]["metrics"][n]),
                            torch.as_tensor(want_bm[n]))
                   for n in ("critic_loss", "actor_loss", "q_mean"))
    rates = [r["grad_steps_per_s"] for r in pair]
    p15 = pixel["pixel_f32"]["windows"]

    def said(tag):
        worst, off, share = errs[tag]
        return f"max abs err {worst:.3e}, {off} elements beyond ({share:.4f})"

    print(f"[model axis 27b] {{data 1, model 2}} on {dev} (gloo) at phase "
          f"15's width, B = {BATCH}, K = {MODEL_K}, against the "
          f"single-device update, networks at rtol {EQUIV_RTOL} / atol "
          f"{EQUIV_ATOL} (bar: a share of {MODEL_FULL_OFF_SHARE}): the "
          f"split {said('split')}, losses max rel err {loss_err:.3e}; "
          f"sound controls, the single-device update on the rows in another "
          f"order: {said('rows')}, with ATen's convolutions in place of "
          f"cuDNN's: {said('aten')}, with each convolution as two halves "
          f"of out-channels joined: {said('halves')}; the split against "
          f"that last: {said('split_halves')}, bitwise "
          f"{_trees_bitwise(pair[0]['params'], halves)}; TF32 control: "
          f"{said('tf32')}; where "
          f"the split is beyond, a zero gradient on both steps in a share "
          f"{cause['off_zero']}, sqrt(v_hat) < eps in {cause['off_below_eps']}"
          f" (every element: {cause['all_zero']:.4f} and "
          f"{cause['all_below_eps']:.4f}; median sqrt(v_hat)/eps "
          f"{cause['all_median']:.4g}); with Adam "
          f"eps {ADAM_EPS_PROBE} on both sides, the split {said('eps')}; "
          f"grad-steps/s per rank over {MODEL_TIMED_STEPS} steps "
          f"{[[round(x, 3) for x in r] for r in rates]} against phase "
          f"15's float32 windows {[round(x, 2) for x in p15]} in this call; "
          f"host ms per grad step in collectives "
          f"{[{a: round(v, 1) for a, v in r['comm_ms_per_step'].items()} for r in pair]}"
          f"; {wall_b:.2f} s ({card})")
    gate_ranks("27b", pair, want_bm, full)
    for tag in ("split", "halves", "rows", "aten"):
        check(errs[tag][2] <= MODEL_FULL_OFF_SHARE, f"27b: {tag}: at most "
              f"a share of {MODEL_FULL_OFF_SHARE} of the network elements "
              f"outside the bars")
    check(errs["tf32"][2] > MODEL_FULL_OFF_SHARE, "27b: the TF32 control "
          "falls outside the bar, so the bar would catch an error its size")
    check(errs["split_halves"][2] <= MODEL_SAME_OFF_SHARE, f"27b: at most "
          f"a share of {MODEL_SAME_OFF_SHARE} of the split's elements "
          f"outside the bars of the same arithmetic in one process (each "
          f"convolution as two halves)")
    check(errs["eps"][1] == 0, f"27b: with Adam eps {ADAM_EPS_PROBE}, "
          f"every network within rtol {EQUIV_RTOL} / atol {EQUIV_ATOL}")
    return {"launches": launches, "param_abs_err": worst, "comm": comm,
            "full_width": {**errs, "cause": cause,
                           "loss_rel_err": loss_err},
            "pair_rates": rates, "pair_comm": [r["comm_ms_per_step"]
                                               for r in pair],
            "wall_s": [wall_a, wall_b]}


# phase 28: the fleet plane (host and TCP work beside the card)
FLEET_NS = (64, 256)  # thread lanes of the N sweep
FLEET_SECONDS = 5.0  # per N-sweep row
FLEET_SHARD_SECONDS = 3.0  # per shard-sweep row
FLEET_SHARD_RATE = 60.0  # rows/s per lane in the shard sweep (N = 256)
FLEET_ACTOR_TICKS = 1000  # pool ticks per real actor lane (28f)


def _fleet_rows(tag: str, rows: list, card: str) -> None:
    for row in rows:
        lat, drops = row["send_latency_ms"], row["drops"]
        waits = {tier: round(per["wait_ns"] / 1e6, 3)
                 for tier, per in sorted(row["locks"]["per_lock"].items())}
        print(f"[fleet {tag}] N = {row['n_actors']}, K = "
              f"{row['ingest_shards']} ({row['codec']}): "
              f"{row['rows_per_sec']} rows/s of {row['demand_rows_per_sec']}"
              f" offered, send p50 {lat['p50']} ms p99 {lat['p99']} ms, "
              f"drops chaos {drops['chaos_rows']} backpressure "
              f"{drops['backpressure_rows']} shed {drops['shed_rows']} rows, "
              f"crashes {row['crashes']}, evictions {row['evictions']}, "
              f"readmissions {row['readmissions']}, lock waits ms {waits} "
              f"(host rates of the card's machine, {card})")


def _fleet_gate(tag: str, rows: list) -> None:
    for row in rows:
        check(row["deadlocks"] == 0,
              f"fleet {tag} N={row['n_actors']}: {row['deadlocks']} deadlocks")
        check(row["locks"]["hierarchy_violations"] == 0,
              f"fleet {tag} N={row['n_actors']}: lock violations "
              f"{row['locks']['violation_samples']}")
        check(row["rows_per_sec"] > 0, f"fleet {tag}: rows flowed")


def phase_fleet(card: str) -> dict:
    """28: the fleet plane. (a) ``run_sweep`` at N = 64 and 256 thread
    lanes and ``shard_sweep`` K = 1, 2 at N = 256 (Humanoid rows, the
    default chaos); (b) ``run_recovery`` (N = 64, K = 2, seeded service
    kills); (c) ``run_sampler``'s three arms, the device arm on cuda:0,
    and its chaos row; (d) ``run_serving`` with its server on the card
    and one server kill; (e) ``run_weights`` (64 pullers, a depth-2
    relay tree); (f) the harness's actor mode with four ``actor_main``
    processes. Each with the lock plane in record mode and the launch
    counters set to 0 before it: the fleet launches none of the port's
    kernels."""
    from d4pg_tpu_torch.fleet import sweep as fsweep
    from d4pg_tpu_torch.fleet import ChaosConfig, FleetConfig, FleetHarness

    flight = str(ROOT / "runs" / "chip_smoke" / "fleet_flight")
    out = {"launches": {k: 0 for k in launch_counts()}}

    def drill(tag, fn):
        zero_counts()
        t0 = time.perf_counter()
        result = fn()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        check(not any(counts.values()),
              f"fleet {tag}: no kernel of the port launched ({counts})")
        for k, v in counts.items():
            out["launches"][k] += v
        print(f"[fleet {tag}] {wall:.2f} s of wall clock ({card})")
        out[tag] = result
        return result

    # 28a: the fan-out and the ingest shards
    sweep = drill("sweep", lambda: fsweep.run_sweep(
        ns=FLEET_NS, duration_s=FLEET_SECONDS, flight_dir=flight))
    _fleet_gate("sweep", sweep["sweep"])
    _fleet_rows("sweep", sweep["sweep"], card)
    shards = drill("shards", lambda: fsweep.shard_sweep(
        ks=(1, 2), n_actors=FLEET_NS[-1], duration_s=FLEET_SHARD_SECONDS,
        rows_per_sec=FLEET_SHARD_RATE, flight_dir=flight))
    _fleet_gate("shards", shards["sweep"])
    _fleet_rows("shards", shards["sweep"], card)
    keys = ("ingest_shards", "rows_per_sec", "speedup_vs_k1",
            "lock_wait_ms", "stage_ms")
    print(f"[fleet shards] scaling "
          f"{[{k: sc[k] for k in keys} for sc in shards['scaling']]} "
          f"({card})")

    # 28b: service kills, restores and the bitwise probe
    rec = drill("recovery", lambda: fsweep.run_recovery(
        n_actors=64, duration_s=6.0, ingest_shards=2, flight_dir=flight))
    check(rec["oracle"]["oracle_bitwise_equal"] is True,
          "fleet recovery: restore equals the uninterrupted run, bitwise")
    check(rec["kills"] >= 1 and rec["restarts"] == rec["kills"]
          and rec["failed_restarts"] == 0,
          f"fleet recovery: kills {rec['kills']}, restarts "
          f"{rec['restarts']}, failed {rec['failed_restarts']}")
    check(rec["deadlocks"] == 0 and rec["hierarchy_violations"] == 0,
          f"fleet recovery: deadlocks {rec['deadlocks']}, violations "
          f"{rec['hierarchy_violations']}")
    print(f"[fleet recovery] {rec['kills']} kills, MTTR {rec['mttr_s']} s, "
          f"rows lost to the crash {rec['rows_lost_to_crash']}, fenced "
          f"{rec['rows_fenced']} rows in {rec['frames_fenced']} frames, "
          f"{rec['rows_inserted']} rows inserted, reconnect storm "
          f"{rec['reconnect_storm']} ({card})")

    # 28c: host, dealer and device sample paths; the device arm's ring and
    # dealer on cuda:0 with the reference's arm='scan'
    smp = drill("sampler", lambda: fsweep.run_sampler(
        n_actors=64, duration_s=2.0, device="cuda:0", flight_dir=flight))
    for arm in ("host", "dealer", "device"):
        row = smp["ab"][arm]
        check(row["deadlocks"] == 0 and row["hierarchy_violations"] == 0
              and row["trace_orphans"] == 0 and row["blocks_consumed"] > 0,
              f"fleet sampler {arm}: {row}")
    for arm in ("dealer", "device"):
        row = smp["ab"][arm]
        check(row["sample_path_buffer_acqs"] == 0
              and row["sampler"]["dealt_dead_tickets"] == 0,
              f"fleet sampler {arm}: consume path and dealt tickets {row}")
    check(smp["ab"]["device"]["device"] == "cuda:0",
          f"fleet sampler: the device arm ran on {smp['ab']['device']}")
    ch = smp["chaos"]
    check(ch["deadlocks"] == 0 and ch["hierarchy_violations"] == 0
          and ch["trace_orphans"] == 0
          and ch["sampler"]["dealt_dead_tickets"] == 0
          and ch["consumer"]["sample_path_buffer_acqs"] == 0
          and ch["consumer"]["consumer_kills"] >= 1
          and ch["fenced_frames"] >= 1,
          f"fleet sampler chaos: {ch['consumer']}, dead tickets "
          f"{ch['sampler']['dealt_dead_tickets']}")
    for arm in ("host", "dealer", "device"):
        row = smp["ab"][arm]
        print(f"[fleet sampler {arm}] wire_to_grad p95 "
              f"{row['wire_to_grad_p95_ms']} ms, deal_to_grad p95 "
              f"{row['deal_to_grad_p95_ms']} ms, blocks consumed "
              f"{row['blocks_consumed']}, blocks dealt "
              f"{(row['sampler'] or {}).get('dealt_blocks')}, rows inserted "
              f"{row['rows_inserted']}, buffer-lock acquisitions on the "
              f"consume path {row['sample_path_buffer_acqs']} ({card})")
    print(f"[fleet sampler chaos] {ch['consumer']}, shed rows "
          f"{ch['shed_rows']}, fenced frames {ch['fenced_frames']} ({card})")

    # 28d: the serving drill, its server on the card, one server kill
    srv = drill("serving", lambda: fsweep.run_serving(
        lane_counts=(4,), envs_per_lane=4, duration_s=1.5, server_kills=1,
        device="cuda:0"))
    sc = srv["chaos"]
    check(sc["device"] == "cuda:0", f"fleet serving: server on {sc['device']}")
    check(sc["server_kills"] == 1 and all(m is not None
                                          for m in sc["mttr_s"]),
          f"fleet serving: kills {sc['server_kills']}, MTTR {sc['mttr_s']}")
    check(sc["torn"]["accepted"] == 0 and sc["trace"]["orphans"] == 0
          and sc["hierarchy_violations"] == 0,
          f"fleet serving: torn {sc['torn']}, orphans "
          f"{sc['trace']['orphans']}, violations {sc['hierarchy_violations']}")
    for row in srv["sweep"]:
        check(row["hierarchy_violations"] == 0
              and row["trace_orphans"] == 0, f"fleet serving row {row}")
        print(f"[fleet serving] {row['n_lanes']} lanes: "
              f"{row['actions_per_sec']} actions/s, request latency "
              f"{row['latency_ms']} ms, occupancy {row['batch_occupancy']}"
              f" ({card})")
    pair = srv["batching"]
    print(f"[fleet serving] batched vs unbatched at {pair['n_lanes']} lanes:"
          f" {pair['batched_actions_per_sec']} vs "
          f"{pair['unbatched_actions_per_sec']} actions/s (x{pair['speedup']})"
          f"; chaos: MTTR {sc['mttr_s']} s, torn {sc['torn']}, "
          f"{sc['actions_per_sec']} actions/s ({card})")

    # 28e: the broadcast plane
    w = drill("weights", lambda: fsweep.run_weights(
        n_pullers=64, relay_depth=2, duration_s=3.0))
    check(w["torn"]["accepted"] == 0 and w["ledger"]["monotone"] is True
          and w["ledger"]["unpublished_accepted"] == 0
          and w["trace"]["orphans"] == 0 and w["hierarchy_violations"] == 0
          and w["oracle"]["delta_failures"] == 0
          and w["oracle"]["quant_failures"] == 0,
          f"fleet weights: torn {w['torn']}, ledger {w['ledger']}, orphans "
          f"{w['trace']['orphans']}, oracle {w['oracle']}")
    print(f"[fleet weights] {w['n_pullers']} pullers over a depth-"
          f"{w['relay_depth']} relay tree: "
          f"{w['snapshots_per_sec']} snapshots/s, delta hit rate "
          f"{w['delta_hit_rate']}, {w['bytes_per_sec']} B/s, staleness "
          f"{w['staleness_ms']} ms, {w['pullers_converged']} converged "
          f"({card})")

    # 28f: four real actor processes of the port (point) into K = 2
    act = drill("actors", lambda: FleetHarness(FleetConfig(
        n_actors=4, mode="actor", max_ticks=FLEET_ACTOR_TICKS,
        ingest_shards=2, chaos=ChaosConfig(seed=0), send_timeout=5.0,
        heartbeat_timeout=30.0, flight_dir=flight)).run())
    check(act["deadlocks"] == 0
          and act["locks"]["hierarchy_violations"] == 0
          and act["ingest"]["order_breaks"] == 0,
          f"fleet actors: deadlocks {act['deadlocks']}, locks "
          f"{act['locks']['hierarchy_violations']}, {act['ingest']}")
    steps = sum(act["lane_env_steps"])
    check(len(act["lane_env_steps"]) == 4
          and all(s == FLEET_ACTOR_TICKS * act["num_envs"]
                  for s in act["lane_env_steps"])
          and 0 < act["rows_inserted"] <= steps,
          f"fleet actors: env steps {act['lane_env_steps']}, rows "
          f"{act['rows_inserted']}")
    print(f"[fleet actors] 4 actor_main processes: {steps} env steps, "
          f"{act['rows_inserted']} rows in {act['duration_s']} s from the "
          f"spawn ({act['rows_per_sec']} rows/s, the processes' start "
          f"included) ({card})")
    return out



# phase 29: the runtime sentinels on the slice's paths
SENTINEL_CHUNKS = 3  # chunks of the ingest overlap's bracket
SENTINEL_DEALS = 4  # ingest+deal rounds of the dealer's bracket


def _sentinels(guard: str | None = None):
    """The three sentinels of ``io/profiling``, entered together (the
    transfer guard ``guard``); ``with`` it, then read each."""
    from d4pg_tpu_torch.io.profiling import (
        RecompileSentinel,
        ReshardSentinel,
        TransferSentinel,
    )

    stack = contextlib.ExitStack()
    rec = stack.enter_context(RecompileSentinel())
    tr = stack.enter_context(TransferSentinel(guard=guard))
    resh = stack.enter_context(ReshardSentinel())
    return stack, rec, tr, resh


def _sentinel_counts(rec, tr, resh) -> dict:
    return {"compilations": rec.compilations, "h2d": tr.h2d,
            "h2d_bytes": tr.h2d_bytes, "d2h": tr.d2h,
            "d2h_bytes": tr.d2h_bytes, "reshards": resh.reshards,
            "ops": dict(resh.ops)}


def _gate_clean(tag: str, rec, resh) -> None:
    rec.assert_clean(f"[sentinels 29] {tag}")
    resh.assert_clean(f"[sentinels 29] {tag}")


def phase_sentinels(dev, card: str) -> dict:
    """29: the reference's steady-state invariants, held with the port's
    sentinels (``io/profiling``: ``RecompileSentinel``,
    ``TransferSentinel``, ``ReshardSentinel``) at the slice's width
    (Humanoid: obs 376, act 17, 256x3, 51 atoms on [0, 800], B = 256, K
    = 40). The brackets hold only what the reference's hold (the chunk
    calls; ``IngestOverlap.commit``/``stage`` with the adds; the
    ingest+deal ticks with the pops); the launch counters are set to 0
    just before each and read just after, and every rate and check runs
    outside them. (a) The fused chunk over a 200,000-row ring under each
    projection arm, after a warm-up chunk: 0 compilations, ``h2d == d2h
    == 0``, 0 reshards, and no sync (``guard="disallow"``: CUDA's sync
    debug mode at ``error``); the arm's kernels and the descent K times;
    the host's enqueue ms and the wall ms per grad step of one bracketed
    chunk against one bare chunk, in turns (bare, bracketed, bracketed,
    bare). (b) The ingest overlap on that ring through a
    ``ReplayService`` (``pallas_ce``): ``SENTINEL_CHUNKS`` chunks, each
    after ``commit`` and before a 4,096-row add and ``stage``: host-to-
    device only from the pinned block (one copy per field per staged
    block, bytes = rows staged x row bytes), ``d2h == 0``, 0
    compilations. (c) The device dealer (``pallas``) at phase 22a's
    shape (a 200,000-row generation-tracked ring, Q = K x B per deal),
    ``SENTINEL_DEALS`` ingest+deal rounds of 4,096-row inserts after a
    warm-up round, audit off: 0 compilations, host-to-device bytes at
    most the staged frames and K x B float32 uniforms a deal (no sampled
    row crosses), ``d2h == 0``, 0 reshards, the descent once a deal; and
    ``deal`` alone under ``ReshardSentinel.inspect``. (d) The sharded
    chunk at 25a's shape (two shards in one process, ``einsum``): 0
    reshards (no collective at world 1: the bar is the cross-device
    copy), 0 compilations, the descent twice a grad step. A failed bar
    fails the script."""
    from d4pg_tpu_torch.distributed.replay_service import ReplayService
    from d4pg_tpu_torch.io.profiling import ReshardSentinel
    from d4pg_tpu_torch.learner.fused import (
        make_fused_chunk,
        make_sharded_fused_chunk,
    )
    from d4pg_tpu_torch.learner.pipeline import IngestOverlap
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.parallel import RankMesh
    from d4pg_tpu_torch.replay.device_sampler import DeviceSampleDealer
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay
    from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
    from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay
    from d4pg_tpu_torch.replay.staging import DealtBlockRing

    t_phase = time.perf_counter()
    out: dict = {"launches": {name: 0 for name in launch_counts()},
                 "paths": {}}

    def add_launches(counts):
        for name, n in counts.items():
            out["launches"][name] += n

    rng = np.random.default_rng(29)
    per = FusedDeviceReplay(CAPACITY, OBS, ACT, alpha=0.6, device=dev)
    for start in range(0, CAPACITY, FILL_BLOCK):
        per.add(random_rows(rng, min(FILL_BLOCK, CAPACITY - start)))
        per.drain()
    row_bytes = sum(a[0].numel() * a.element_size() for a in per.storage)
    torch.cuda.synchronize()

    # (a) the fused chunk, both arms
    states = {}
    for arm in ("pallas", "pallas_ce"):
        state = init_state(config(arm), seed=0, device=dev)
        fn = make_fused_chunk(config(arm), k=K, batch_size=BATCH)
        gen = torch.Generator(device=dev).manual_seed(0)
        per.trees, _ = fn(state, per.trees, per.storage, per.size,
                          generator=gen)  # warm-up
        torch.cuda.synchronize()
        times = {"bare": [], "bracketed": []}
        for turn in ("bare", "bracketed", "bracketed", "bare"):
            zero_counts()
            stack = (_sentinels("disallow") if turn == "bracketed"
                     else None)
            t0 = time.perf_counter()
            if stack is None:
                per.trees, m = fn(state, per.trees, per.storage, per.size,
                                  generator=gen)
            else:
                with stack[0]:
                    per.trees, m = fn(state, per.trees, per.storage,
                                      per.size, generator=gen)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            counts = launch_counts()
            check(counts == {n: K if n in fused_kernels(arm) else 0
                             for n in counts},
                  f"[sentinels 29a] {arm} {turn} chunk launches {counts}")
            check(bool(torch.isfinite(m["critic_loss"]).all()),
                  f"[sentinels 29a] {arm}: finite critic_loss")
            times[turn].append((1e3 * (t1 - t0) / K, 1e3 * (t2 - t0) / K))
            if stack is None:
                continue
            add_launches(counts)
            _, rec, tr, resh = stack
            _gate_clean(f"fused chunk ({arm})", rec, resh)
            check(tr.h2d == tr.d2h == 0, f"[sentinels 29a] {arm}: the "
                  f"chunk crossed the host/device line {tr.crossings}")
            out["paths"][f"chunk_{arm}"] = _sentinel_counts(rec, tr, resh)
        states[arm] = state
        host = {t: [round(h, 4) for h, _ in v] for t, v in times.items()}
        wall = {t: [round(w, 4) for _, w in v] for t, v in times.items()}
        out[f"cost_{arm}"] = {"host_ms": host, "wall_ms": wall}
        print(f"[sentinels 29a] fused chunk ({arm}): 0 compilations, 0 "
              f"crossings, 0 reshards, no sync (guard disallow); host ms "
              f"per grad step bare {host['bare']}, under the three "
              f"sentinels {host['bracketed']}; wall ms per grad step bare "
              f"{wall['bare']}, under them {wall['bracketed']} ({card})")

    # (b) the ingest overlap through a service, on the same ring
    cfg = config("pallas_ce")
    fn = make_fused_chunk(cfg, k=K, batch_size=BATCH)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = states["pallas_ce"]
    svc = ReplayService(per)
    ingest = IngestOverlap(svc)
    feed = random_rows(rng, FILL_BLOCK)
    try:
        svc.add(feed)
        svc.flush()
        ingest.commit()  # nothing in flight yet: a no-op
        ingest.stage()
        staged0, committed0 = ingest.rows_staged, ingest.rows_committed
        zero_counts()
        stack = _sentinels()
        with stack[0]:
            for _ in range(SENTINEL_CHUNKS):
                ingest.commit()
                per.trees, m = fn(state, per.trees, per.storage, per.size,
                                  generator=gen)
                svc.add(feed)
                svc.flush()
                ingest.stage()
        torch.cuda.synchronize()
        counts = launch_counts()
        add_launches(counts)
        _, rec, tr, resh = stack
        staged = ingest.rows_staged - staged0
        committed = ingest.rows_committed - committed0
        fields = len(per.storage)
        check(counts == {n: SENTINEL_CHUNKS * K if n in fused_kernels(
            "pallas_ce") else 0 for n in counts},
              f"[sentinels 29b] launches {counts}")
        _gate_clean("ingest overlap", rec, resh)
        check(staged == SENTINEL_CHUNKS * FILL_BLOCK
              and committed == SENTINEL_CHUNKS * FILL_BLOCK,
              f"[sentinels 29b] rows staged {staged}, committed "
              f"{committed}")
        check(tr.h2d <= fields * SENTINEL_CHUNKS
              and tr.h2d_bytes == staged * row_bytes and tr.d2h == 0,
              f"[sentinels 29b] host-to-device only from the staged block: "
              f"{tr.h2d} copies, {tr.h2d_bytes} B for {staged} rows of "
              f"{row_bytes} B, d2h {tr.d2h} ({tr.crossings})")
        out["paths"]["ingest"] = {**_sentinel_counts(rec, tr, resh),
                                  "rows_staged": staged,
                                  "row_bytes": row_bytes}
        print(f"[sentinels 29b] ingest overlap, {SENTINEL_CHUNKS} chunks: "
              f"{tr.h2d} host-to-device copies ({fields} fields a block), "
              f"{tr.h2d_bytes} B = {staged} rows staged x {row_bytes} B, "
              f"d2h {tr.d2h}, 0 compilations, 0 reshards ({card})")
    finally:
        ingest.release()
        svc.close()
    del per, states, state, svc, ingest
    torch.cuda.synchronize()

    # (c) the device dealer at phase 22a's shape
    dbuf = FusedDeviceReplay(CAPACITY, OBS, ACT, alpha=0.6, device=dev,
                             gen_tracked=True)
    ring = DealtBlockRing(1)
    dealer = DeviceSampleDealer(CAPACITY, [ring], k=K, batch_size=BATCH,
                                beta_schedule=SharedBetaSchedule(),
                                min_size=BATCH, seed=29, arm="pallas")
    dealer.resync(dbuf)

    def tick(rows, seq):
        dealer.publish(dealer.ingest_and_deal([(dbuf.add(rows), seq, None)],
                                              dbuf))
        blocks = 0
        while ring.pop(timeout=0) is not None:
            blocks += 1
        return blocks

    check(tick(random_rows(rng, FILL_BLOCK), 0) == 1,
          "[sentinels 29c] warm-up deal")
    torch.cuda.synchronize()
    frames = [random_rows(rng, FILL_BLOCK) for _ in range(SENTINEL_DEALS)]
    zero_counts()
    stack = _sentinels()
    with stack[0]:
        dealt = sum(tick(rows, i + 1) for i, rows in enumerate(frames))
    torch.cuda.synchronize()
    counts = launch_counts()
    add_launches(counts)
    _, rec, tr, resh = stack
    u_bytes = K * BATCH * 4
    frame_bytes = SENTINEL_DEALS * FILL_BLOCK * row_bytes
    check(dealt == SENTINEL_DEALS and counts == {
        n: SENTINEL_DEALS if n == "descent" else 0 for n in counts},
          f"[sentinels 29c] {dealt} blocks, launches {counts}")
    _gate_clean("device ingest+deal", rec, resh)
    check(tr.h2d_bytes <= frame_bytes + SENTINEL_DEALS * u_bytes
          and tr.d2h == 0,
          f"[sentinels 29c] host-to-device {tr.h2d_bytes} B over "
          f"{frame_bytes} B of staged frames and {SENTINEL_DEALS} x "
          f"{u_bytes} B of uniforms; d2h {tr.d2h} ({tr.crossings})")
    deal_resh = ReshardSentinel()
    zero_counts()
    deal_resh.inspect(dealer.deal, dbuf,
                      np.zeros((K, BATCH), np.float32), dbuf.size, 0.4)
    torch.cuda.synchronize()
    check(launch_counts()["descent"] == 1, "[sentinels 29c] deal inspected")
    deal_resh.assert_clean("[sentinels 29c] device deal dispatch")
    out["paths"]["dealer"] = {**_sentinel_counts(rec, tr, resh),
                              "frame_bytes": frame_bytes,
                              "uniform_bytes": SENTINEL_DEALS * u_bytes}
    print(f"[sentinels 29c] device dealer, {SENTINEL_DEALS} ingest+deal "
          f"rounds: {tr.h2d} host-to-device copies, {tr.h2d_bytes} B "
          f"(staged frames {frame_bytes} B, uniforms "
          f"{SENTINEL_DEALS} x {u_bytes} B), d2h {tr.d2h}, 0 compilations, "
          f"0 reshards, deal alone 0 reshards ({card})")
    del dbuf, dealer, ring
    torch.cuda.synchronize()

    # (d) the sharded chunk at 25a's shape
    mesh = RankMesh.local(dev, MESH_SHARDS)
    sbuf = ShardedFusedReplay(CAPACITY, OBS, ACT, mesh, alpha=0.6)
    for start in range(0, CAPACITY, FILL_BLOCK):
        sbuf.add(random_rows(rng, min(FILL_BLOCK, CAPACITY - start)))
        sbuf.drain()
    state = init_state(config("einsum"), seed=0, device=dev)
    fn = make_sharded_fused_chunk(config("einsum"), mesh, k=K,
                                  batch_size=BATCH)
    gen = torch.Generator(device=dev).manual_seed(2)
    trees, _ = fn(state, sbuf.trees, sbuf.storage, sbuf.size,
                  generator=gen)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    stack = _sentinels()
    with stack[0]:
        trees, m = fn(state, trees, sbuf.storage, sbuf.size, generator=gen)
    torch.cuda.synchronize()
    counts = launch_counts()
    add_launches(counts)
    _, rec, tr, resh = stack
    check(counts == {n: MESH_SHARDS * K if n == "descent" else 0
                     for n in counts},
          f"[sentinels 29d] launches {counts}")
    check(bool(torch.isfinite(m["critic_loss"]).all()),
          "[sentinels 29d] finite critic_loss")
    _gate_clean("sharded chunk", rec, resh)
    out["paths"]["sharded_chunk"] = _sentinel_counts(rec, tr, resh)
    print(f"[sentinels 29d] sharded chunk, {MESH_SHARDS} shards: 0 "
          f"reshards (ops {resh.ops}), 0 compilations; h2d {tr.h2d} "
          f"({tr.h2d_bytes} B), d2h {tr.d2h} ({tr.d2h_bytes} B) ({card})")
    del sbuf, trees
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[sentinels 29] phase in {out['seconds']:.2f} s; launches "
          f"inside the brackets {out['launches']} ({card})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from d4pg_tpu_torch.ops.kernels import library

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    lib = library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    kernels = [phase_projection(dev), phase_descent(dev),
               *phase_projection_ce(dev)]
    phase_autotune(dev)
    phase_reference(dev)
    per, uniform = fill_buffers(dev)
    # both arms warmed up, then timed in turns (A B B A A B B A A B) on
    # the one ring, TIMED_CHUNKS chunks per arm in windows of 2
    arm_runs = {arm: slice_arm(dev, per, config(arm), arm,
                               fused_kernels(arm), TIMED_CHUNKS)
                for arm in ("pallas", "pallas_ce")}
    for arm in ("pallas", "pallas_ce", "pallas_ce", "pallas") * 2 + (
            "pallas", "pallas_ce"):
        arm_runs[arm][0](WINDOW_CHUNKS)
    arms = {arm: finish() for arm, (_, finish) in arm_runs.items()}
    phase_uniform(dev, uniform)
    del uniform  # phase 16 times the MoG critic over ``per``
    phase_ingest(dev)
    hooks = DriverHooks()
    drv = phase_driver(card, hooks)
    phase_device_ring_commits(dev)
    host = phase_host_chunks(dev, card)
    drv_host = phase_driver_host(card, hooks, drv["auto"])
    phase_pixel_reference(dev)
    pixel = phase_pixel_slice(dev)
    mog = phase_mog(dev, per)
    del per
    families = phase_driver_families(card, hooks)
    phase_her_ingest(dev)
    her = phase_her_driver(card, hooks)
    remote = phase_remote_driver(card, hooks)
    phase_sharded_ingest(dev)
    plane = phase_weight_plane(dev, card)
    sharded = phase_sharded_driver(card, hooks, remote)
    serving = phase_serving(dev, card)
    serving_drv = phase_serving_driver(card, hooks, remote)
    dealer = phase_dealer(dev, card)
    dealt = phase_dealt_driver(card, hooks, drv_host)
    recovery = phase_recovery(dev, card)
    recovery_drv = phase_recovery_driver(
        card, hooks, drv["own_grad_steps_per_sec_resume"])
    updates = phase_update_plane(dev, card)
    elastic_drv = phase_elastic_driver(card, hooks, dealt)
    elastic = phase_elastic_drill(card)
    mesh = phase_mesh_chunk(dev, card)
    mesh_check = phase_mesh_check(dev, card)
    mesh_drv = phase_mesh_driver(card)
    replicas = phase_replica_group(dev, card)
    mesh_ab = phase_mesh_ab(dev, card)
    replica_drv = phase_replica_driver(card, hooks)
    model_axis = phase_model_axis(dev, card, pixel)
    fleet = phase_fleet(card)
    sentinels = phase_sentinels(dev, card)
    # each kernel's launches from the run of the arm whose path it is on;
    # the driver's from its explicit-arm run (2 cycles, 80 grad steps);
    # the host path's from its timed windows (both storages, 800 grad
    # steps) and from its driver runs (``auto``'s arm, 200 grad steps)
    for kern in kernels:
        arm = "pallas" if kern["name"] == "projection" else "pallas_ce"
        kern["launches"] = arms[arm]["launches"][kern["name"]]
        kern["driver_launches"] = drv["launches"][kern["name"]]
        kern["host_launches"] = sum(
            host[storage][arm]["launches"][kern["name"]] for storage in host)
        kern["host_driver_launches"] = sum(
            run["launches"][kern["name"]] for run in drv_host.values())
        # the new paths: the pixel slice's timed windows (both dtypes,
        # 480 grad steps), the MoG windows (240), the family driver runs
        kern["pixel_launches"] = sum(
            arm["launches"][kern["name"]] for arm in pixel.values())
        kern["mog_launches"] = mog["launches"][kern["name"]]
        kern["family_driver_launches"] = sum(
            run["launches"][kern["name"]] for run in families.values())
        # this slice's paths: the HER driver runs (120 grad steps), the
        # remote-actor driver runs (200)
        kern["her_driver_launches"] = her["launches"][kern["name"]]
        kern["remote_driver_launches"] = remote["launches"][kern["name"]]
        # the sharded driver run of phase 20c (120 grad steps)
        kern["sharded_driver_launches"] = sharded["launches"][kern["name"]]
        # this slice: the serving driver (21b, 120 grad steps) and the
        # dealt drivers (22b: pallas, scan, host, auto with 2 learners)
        kern["serving_driver_launches"] = \
            serving_drv["launches"][kern["name"]]
        kern["dealt_driver_launches"] = dealt["launches"][kern["name"]]
        # this slice: the two K = 40 chunks after the restore (23a), the
        # resumed driver cycle (23b, 40 grad steps) and the replicas'
        # rounds through the update plane (23c: 6 rounds of 40, the
        # rounds of three windows of UPDATE_WINDOW_S and the killed
        # replica's)
        kern["recovery_launches"] = recovery["launches"][kern["name"]]
        kern["recovery_driver_launches"] = \
            recovery_drv["launches"][kern["name"]]
        kern["update_plane_launches"] = updates["launches"][kern["name"]]
        # this slice: the autoscaled driver (24a) and the elastic drill
        # (24b, none: its server runs the actor MLP only)
        kern["elastic_driver_launches"] = \
            elastic_drv["launches"][kern["name"]]
        kern["elastic_drill_launches"] = elastic["launches"][kern["name"]]
        # this slice: the sharded fused chunk's timed windows (25a, 320
        # grad steps on two local shards, the descent twice a step), the
        # two ranks of the check (25b, 6 grad steps each) and the
        # two-rank driver runs (25c, 80 grad steps a rank a run); the
        # mesh arm projects with einsum, so the projection kernels launch
        # on none of them
        kern["mesh_launches"] = mesh["launches"][kern["name"]]
        kern["mesh_check_launches"] = (mesh_check["launches"]
                                       if kern["name"] == "descent" else 0)
        kern["mesh_driver_launches"] = (mesh_drv["launches"]
                                        if kern["name"] == "descent" else 0)
        # this slice: the replica group's gates and timed rounds (26a:
        # N = 1, 2, 4, each kernel of the arm once per replica per grad
        # step), the A/B drill's two arms (26b), the mesh-native driver
        # (26c: einsum on host trees, none) and the model axis's sharded
        # chunks (27a: the descent once per grad step on each rank)
        kern["replica_launches"] = replicas["launches"][kern["name"]]
        kern["mesh_ab_launches"] = mesh_ab["launches"][kern["name"]]
        kern["replica_driver_launches"] = \
            replica_drv["launches"][kern["name"]]
        kern["model_axis_launches"] = model_axis["launches"][kern["name"]]
        # this slice: the fleet's drills (28a-f), none
        kern["fleet_launches"] = fleet["launches"][kern["name"]]
        # this slice: the sentinels' brackets (29a-d: each arm's chunk,
        # the ingest overlap's chunks, the dealer's deals, the sharded
        # chunk)
        kern["sentinel_launches"] = sentinels["launches"][kern["name"]]
        if kern["name"] == "descent":
            # the dealt plane's shape: one launch per deal over Q = K * B
            # flat queries (22a), and the driver's Q = 40 * 64 at 2^20
            kern["dealt_launches"] = dealer["launches"]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by"):
                kern[f"dealt_{key}"] = dealer["q10240"][key]
                kern[f"dealt_driver_{key}"] = dealer["q2560"][key]
                # the sharded chunk's shape: Q = 128 over 2^17 leaves
                kern[f"mesh_{key}"] = mesh["descent"][key]
    for arm, result in arms.items():
        print(f"[{arm}] grad_steps_per_s {result['grad_steps_per_s']:.1f} "
              f"on {card}")
    print(f"[driver] grad_steps_per_sec per cycle "
          f"{drv['grad_steps_per_sec']} (EWMA), own "
          f"{drv['own_grad_steps_per_sec']} (eval in the background), "
          f"{drv['own_grad_steps_per_sec_sync_eval']} (eval between "
          f"cycles), env_steps_per_sec "
          f"{drv['env_steps_per_sec']}, auto {drv['auto']!r}, device busy "
          f"share {drv['device_busy_share']} on {card}")
    for storage, arms_ in host.items():
        for arm, st in arms_.items():
            print(f"[host {storage}] [{arm}] grad_steps_per_s "
                  f"{st['grad_steps_per_s']:.1f}, host "
                  f"{st['host_ms_per_chunk']:.2f} ms/chunk, H2D "
                  f"{st['h2d_bytes_per_chunk']:.0f} B/chunk, waits "
                  f"{st['waits_per_chunk']:.3f}/chunk on {card}")
    for tag, run in drv_host.items():
        print(f"[driver {tag}] own grad-steps/s "
              f"{[round(x, 2) for x in run['own_grad_steps_per_sec']]}, "
              f"env_steps_per_sec {run['env_steps_per_sec']} on {card}")
    for arm, st in pixel.items():
        print(f"[{arm}] grad_steps_per_s {st['grad_steps_per_s']:.2f}, "
              f"device busy share {st['device_busy_share']}, peak device "
              f"memory {st['peak_bytes'] / 1e9:.3f} GB (ring "
              f"{st['ring_bytes'] / 1e9:.3f} GB), "
              f"{st['flops_per_s'] / 1e12:.2f} TFLOP/s "
              f"({100 * st['peak_share']:.2f}% of peak) on {card}")
    print(f"[mog] grad_steps_per_s {mog['grad_steps_per_s']:.2f}, device "
          f"busy share {mog['device_busy_share']}, peak device memory "
          f"{mog['peak_bytes'] / 1e9:.3f} GB on {card}")
    for tag, run in families.items():
        print(f"[driver {tag}] own grad-steps/s "
              f"{[round(x, 2) for x in run['own_grad_steps_per_sec']]}, "
              f"env_steps_per_sec {run['env_steps_per_sec']} on {card}")
    print(f"[driver her] own grad-steps/s "
          f"{[round(x, 2) for x in her['own_grad_steps_per_sec']]} (arm "
          f"{her['arm']!r}) against phase 11's in-process point driver "
          f"{[round(x, 2) for x in drv['own_grad_steps_per_sec']]} on "
          f"{card}")
    for tag, run in remote["runs"].items():
        cores = {k: [round(x, 3) for x in v]
                 for k, v in run["cores"].items()}
        print(f"[driver {tag}] own grad-steps/s "
              f"{[round(x, 2) for x in run['own_grad_steps_per_sec']]}, "
              f"rows/s received {[round(x, 1) for x in run['rows_per_sec']]}"
              f" against phase 11's "
              f"{[round(x, 2) for x in drv['own_grad_steps_per_sec']]}; "
              f"learner process {cores['process']} cores, decoding "
              f"{cores['decode']}, commit {cores['commit']}, "
              f"device busy share {run['device_busy_share']} on {card}")
    print(f"[driver sharded] own grad-steps/s "
          f"{[round(x, 2) for x in sharded['own_grad_steps_per_sec']]}, "
          f"ratio to 19a's {[round(x, 3) for x in sharded['ratio_to_19a']]}"
          f"; rows/s per shard "
          f"{[[round(x, 1) for x in c] for c in sharded['rows_per_sec_per_shard']]}"
          f"; the learner's CPU ms per grad step "
          f"{[round(x, 2) for x in sharded['cpu_ms_per_grad_step']]}; "
          f"wire_to_grad p50 {sharded['latency']['wire_to_grad']['p50']} ms;"
          f" weight frames bf16 full / delta bytes "
          f"{plane['bf16']['full_bytes']} / {plane['bf16']['delta_bytes']} "
          f"on {card}")
    for tag, res in serving.items():
        print(f"[serving {tag}] {res['requests_per_s']:.1f} requests/s, "
              f"p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms on "
              f"{card}")
    print(f"[driver serving] own grad-steps/s "
          f"{[round(x, 2) for x in serving_drv['own_grad_steps_per_sec']]}"
          f", rows/s {[round(x, 1) for x in serving_drv['rows_per_sec']]}"
          f" against 19a's "
          f"{[round(x, 2) for x in remote['runs']['remote_point']['own_grad_steps_per_sec']]}"
          f" on {card}")
    for name in ("deal", "settle"):
        t = dealer[name]
        print(f"[dealer {name}] host enqueue {t['host_ms']} ms, device span "
              f"{t['span_ms']} ms, profiler {t['device_ms']} ms in "
              f"{t['kernels']} kernels and copies on {card}")
    print(f"[dealer] descent at Q = {K * BATCH} "
          f"{dealer['q10240']['ms'] * 1e3:.3f} us, at Q = "
          f"{K * DRIVER_BATCH} over 2^20 {dealer['q2560']['ms'] * 1e3:.3f}"
          f" us on {card}")
    for tag, run in dealt["runs"].items():
        print(f"[driver dealt {tag}] own grad-steps/s "
              f"{[round(x, 2) for x in run['own_grad_steps_per_sec']]}, "
              f"deal-to-grad p50 {run['deal_to_grad_p50_ms']} ms, replica "
              f"CPU {run['replica_cpu_ms_per_grad_step']:.2f} ms per grad "
              f"step on {card}")
    print(f"[recovery] snapshot {recovery['snapshot_s']:.4f} s (lock "
          f"{recovery['lock_s']:.4f} s), sidecar "
          f"{recovery['sidecar_bytes']} B (write {recovery['write_s']:.4f} "
          f"s, read {recovery['read_s']:.4f} s), restore "
          f"{recovery['restore_s']:.4f} s; resumed driver cycle own "
          f"grad-steps/s "
          f"{[round(x, 2) for x in recovery_drv['own_grad_steps_per_sec']]}"
          f" against the learner-only resume "
          f"{[round(x, 2) for x in drv['own_grad_steps_per_sec_resume']]} "
          f"on {card}")
    for codec, res in updates["codecs"].items():
        print(f"[update plane {codec}] {res['rounds_per_s']:.3f} rounds/s "
              f"over {res['wall_s']:.2f} s, round trip over n = "
              f"{res['submits']}: p50 {res['rtt_p50_ms']:.2f} ms, p99 "
              f"{res['rtt_p99_ms']:.2f} ms, max {res['rtt_max_ms']:.2f} ms, "
              f"frame {res['frame_bytes']} B on {card}")
    print(f"[driver elastic] own grad-steps/s "
          f"{[round(x, 2) for x in elastic_drv['own_grad_steps_per_sec']]}"
          f" against 22b's auto_learners2 "
          f"{[round(x, 2) for x in dealt['runs']['auto_learners2']['own_grad_steps_per_sec']]}"
          f"; {elastic_drv['ticks']} ticks, {elastic_drv['actuations']} "
          f"actuations; the drill's gate {elastic['gate']} on {card}")
    print(f"[mesh] 25a grad-steps/s {[round(x, 2) for x in mesh['windows']]}"
          f", device busy {mesh['device_busy_ms']} ms per grad step; 25b "
          f"gradient average {[round(x, 3) for x in mesh_check['reduce_ms_per_step']]}"
          f" ms per grad step (gloo); 25c own grad-steps/s "
          f"{mesh_drv['runs']['train']['own_grad_steps_per_sec']} (two ranks "
          f"sharing the card over gloo: no multi-GPU rate) on {card}")
    for n, run in replicas["runs"].items():
        print(f"[replicas] N = {n}: own grad-steps/s per replica "
              f"{[round(x, 2) for x in run['own_grad_steps_per_s']]}, all "
              f"{[round(x, 2) for x in run['all_grad_steps_per_s']]}; merge "
              f"{[round(x, 3) for x in run['merge_ms']]} ms; peak "
              f"{run['peak_bytes'] / 1e9:.3f} GB on {card}")
    for tag, row in mesh_ab["rows"].items():
        print(f"[mesh A/B {tag}] updates/s socket "
              f"{row['socket']['updates_per_sec']}, collective "
              f"{row['collective']['updates_per_sec']}; p50 ratio "
              f"{row['agg_latency_ratio_p50']} on {card}")
    print(f"[replicas driver] own grad-steps/s "
          f"{replica_drv['runs']['train']['own_grad_steps_per_sec']}; "
          f"[model axis] 27a max abs err {model_axis['param_abs_err']:.3e}"
          f", 27b grad-steps/s {model_axis['pair_rates']} on {card}")
    cost = {arm: {turn: [round(x, 3) for x in ms]
                  for turn, ms in sentinels[f"cost_{arm}"]["host_ms"].items()}
            for arm in ("pallas", "pallas_ce")}
    print(f"[sentinels] host ms per grad step of a fused chunk, bare and "
          f"under the three sentinels: {cost}; h2d bytes: ingest "
          f"{sentinels['paths']['ingest']['h2d_bytes']}, dealer "
          f"{sentinels['paths']['dealer']['h2d_bytes']}; phase "
          f"{sentinels['seconds']:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
