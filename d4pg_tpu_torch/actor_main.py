"""Remote actor runner: ``python -m d4pg_tpu_torch.actor_main --learner_host ...``

Counterpart of ``d4pg_tpu/actor_main.py``: acting in another process or
on another host, streaming transitions to the learner's
``TransitionReceiver`` (``distributed/transport``) and pulling weights
from its ``WeightServer`` (``distributed/weight_server``, the v1 frames).
Actors are stateless: kill one and start another; replay and weights
live with the learner. The frames are the reference's, so this runner
feeds a JAX learner as well as the port's, and the reference's runner
feeds the port's learner.

``--her 1`` runs a ``GoalActorWorker`` on one env: whole episodes, the
originals and their HER relabels streamed with the count flag (relabels
off), the normalizer statistics adopted from the weight frames. Without
it an ``EnvPool`` of ``--num_envs`` envs runs an ``ActorWorker``.

Not ported yet, each raising ``NotImplementedError``: ``--weight_codec``
(the v2 weight plane, ROADMAP Queue 1 item 12) and ``--policy_port``
(the serving plane, item 13).

Spawned children (``train.py --actor_procs N``, through
``run_local_actor_process``) act on the CPU and never create a CUDA
context: the card belongs to the learner, as in the reference, whose
children force JAX onto the CPU.
"""

from __future__ import annotations

import argparse
import os

from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.distributed.actor import ActorWorker, GoalActorWorker
from d4pg_tpu_torch.distributed.transport import (
    CoalescingSender,
    TransitionSender,
)
from d4pg_tpu_torch.distributed.weight_server import WeightClient
from d4pg_tpu_torch.envs.vector import EnvPool
from d4pg_tpu_torch.replay.uniform import TransitionBatch
from d4pg_tpu_torch.serving.client import ActorConfig
from d4pg_tpu_torch.train import infer_dims, make_env_fn


class RemoteReplayClient:
    """ReplayService-shaped adapter over the transition socket."""

    def __init__(self, sender: TransitionSender):
        self._sender = sender

    def add(self, batch: TransitionBatch, actor_id: str = "remote",
            block: bool = True, timeout: float | None = None,
            count_env_steps: bool = True) -> bool:
        # TCP gives ordering and backpressure; count_env_steps crosses the
        # wire as the frame's count flag. Under drop_on_timeout the sender
        # sheds a timed-out frame and returns False (counted by the actor)
        del actor_id, block, timeout
        return self._sender.send(batch, count_env_steps=count_env_steps)


def _refuse_unported(weight_codec: str | None,
                     policy_port: int | None) -> None:
    if weight_codec is not None:
        raise NotImplementedError(
            f"--weight_codec {weight_codec} selects the v2 weight plane, "
            "which the PyTorch port does not have yet (ROADMAP Queue 1 "
            "item 12); the v1 puller is the default")
    if policy_port is not None:
        raise NotImplementedError(
            "--policy_port selects the serving plane, which the PyTorch "
            "port does not have yet (ROADMAP Queue 1 item 13)")


def run_actor(
    cfg: ExperimentConfig,
    learner_host: str,
    transitions_port: int,
    weights_port: int,
    actor_id: str = "remote-0",
    max_ticks: int | None = None,
    secret: str | None = None,
    send_timeout: float = 300.0,
    send_retries: int | None = None,
    drop_on_timeout: bool = False,
    codec: str = "npz",
    trace_sample: float = 0.0,
    expect_generation: bool = False,
    weight_codec: str | None = None,
    policy_port: int | None = None,
) -> int:
    """Act until ``max_ticks`` pool ticks (HER: env steps) are done, or
    forever; returns the env steps taken."""
    _refuse_unported(weight_codec, policy_port)
    cfg = cfg.resolve()
    obs_dim, act_dim, obs_dtype = infer_dims(cfg)
    # acting needs the networks' shapes only: the projection arm is
    # resolved on the CPU, where it is picked without timing the card
    config = cfg.learner_config(obs_dim, act_dim, device="cpu")
    sender = CoalescingSender(learner_host, transitions_port,
                              actor_id=actor_id, secret=secret,
                              retry_timeout=send_timeout,
                              max_retries=send_retries,
                              drop_on_timeout=drop_on_timeout,
                              codec=codec, trace_sample=trace_sample,
                              expect_generation=expect_generation)
    weights = WeightClient(learner_host, weights_port, secret=secret)
    actor_cfg = ActorConfig(
        epsilon_0=cfg.epsilon_0, min_epsilon=cfg.min_epsilon,
        epsilon_horizon=cfg.epsilon_horizon, n_step=cfg.n_steps,
        gamma=cfg.gamma, reward_scale=cfg.reward_scale, noise=cfg.noise,
        random_eps=cfg.random_eps, ou_theta=cfg.ou_theta,
        ou_sigma=cfg.ou_sigma, ou_mu=cfg.ou_mu, device=cfg.actor_device)
    pool = None
    goal_env = None
    if cfg.her:
        if cfg.num_envs > 1:
            print(f"[{actor_id}] --her runs a single env per remote actor "
                  f"(episode-granular HER relabeling); ignoring --num_envs "
                  f"{cfg.num_envs}. Launch more actor processes for width.",
                  flush=True)
        goal_env = make_env_fn(cfg, seed=cfg.seed)()
        actor = GoalActorWorker(
            actor_id, config, actor_cfg, goal_env,
            RemoteReplayClient(sender), weights, her_ratio=cfg.her_ratio,
            rng_seed=cfg.seed, seed=cfg.seed)
    else:
        pool = EnvPool([make_env_fn(cfg, seed=cfg.seed + i)
                        for i in range(cfg.num_envs)], seed=cfg.seed)
        actor = ActorWorker(actor_id, config, actor_cfg, pool,
                            RemoteReplayClient(sender), weights,
                            seed=cfg.seed, obs_dtype=obs_dtype)
    try:
        done = 0
        while max_ticks is None or done < max_ticks:
            if cfg.her:
                done += actor.run_episode(cfg.max_steps)
            else:
                chunk = (1000 if max_ticks is None
                         else min(1000, max_ticks - done))
                actor.run(chunk)
                done += chunk
            sender.flush()  # a partial block must not outlive the loop
    except (KeyboardInterrupt, ConnectionError, OSError) as e:
        print(f"actor {actor_id} stopping: {type(e).__name__}: {e}",
              flush=True)
    finally:
        if sender.frames_dropped or actor.dropped_batches:
            # shed rows are benign but never silent
            print(f"actor {actor_id} shed {sender.frames_dropped} frames "
                  f"({sender.retries} transport retries) under "
                  "backpressure", flush=True)
        sender.close()
        weights.close()
        if pool is not None:
            pool.close()
        if goal_env is not None and hasattr(goal_env, "close"):
            goal_env.close()
    return actor.env_steps


def run_local_actor_process(
    cfg: ExperimentConfig,
    learner_host: str,
    transitions_port: int,
    weights_port: int,
    actor_id: str,
    secret: str | None = None,
    expect_generation: bool = False,
) -> None:
    """Entry point of a spawned actor process (``train.py --actor_procs
    N``). Hides the card from this process before anything can touch it
    and acts on the CPU: the card belongs to the learner. One intra-op
    thread: a batch of a few rows through the actor MLP gains nothing
    from more, and N children each taking every core would starve the
    learner's process of its host CPU."""
    import dataclasses

    import torch

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    cfg = dataclasses.replace(cfg, actor_device="cpu")
    try:
        run_actor(cfg, learner_host, transitions_port, weights_port,
                  actor_id=actor_id, secret=secret,
                  expect_generation=expect_generation)
    except KeyboardInterrupt:
        pass


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="d4pg_tpu_torch.actor_main")
    p.add_argument("--learner_host", required=True)
    p.add_argument("--transitions_port", type=int, required=True)
    p.add_argument("--weights_port", type=int, required=True)
    p.add_argument("--actor_id", default="remote-0")
    p.add_argument("--env", default="Pendulum-v1")
    p.add_argument("--num_envs", type=int, default=4,
                   help="vectorized env pool width; with --her 1 the remote "
                        "actor always runs a single env")
    p.add_argument("--n_steps", type=int, default=None,
                   help="n-step horizon (default: from the env preset)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise", choices=("gaussian", "ou"), default="gaussian")
    p.add_argument("--random_eps", type=float, default=0.0)
    p.add_argument("--her", type=int, choices=(0, 1), default=0)
    p.add_argument("--her_ratio", type=float, default=0.8)
    p.add_argument("--max_steps", type=int, default=None,
                   help="episode horizon (default: from the env preset)")
    p.add_argument("--max_ticks", type=int, default=None)
    p.add_argument("--secret", default="",
                   help="shared secret matching the learner's --serve_secret")
    p.add_argument("--actor_device", choices=("cpu", "default"),
                   default="cpu")
    p.add_argument("--send_timeout", type=float, default=300.0,
                   help="seconds a frame may retry across reconnects")
    p.add_argument("--send_retries", type=int, default=None,
                   help="max reconnect attempts per frame (default: "
                        "unbounded within --send_timeout)")
    p.add_argument("--drop_on_timeout", type=int, choices=(0, 1), default=0,
                   help="1: shed timed-out frames (counted) and keep "
                        "acting; 0: raise and stop (default)")
    p.add_argument("--codec", choices=("npz", "raw"), default="npz",
                   help="wire frame format: npz (self-describing) or raw "
                        "(v2 column frames)")
    p.add_argument("--trace_sample", type=float, default=0.0,
                   help="fraction of raw frames stamped with a trace id and "
                        "birth timestamp (requires --codec raw)")
    p.add_argument("--expect_generation", type=int, choices=(0, 1),
                   default=0,
                   help="1: read the learner's generation greeting on "
                        "connect and stamp raw frames with it")
    p.add_argument("--weight_codec", choices=("f32", "bf16", "int8"),
                   default=None,
                   help="the v2 weight plane (not ported yet: raises)")
    p.add_argument("--policy_port", type=int, default=None,
                   help="the serving plane (not ported yet: raises)")
    return p


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    _refuse_unported(ns.weight_codec, ns.policy_port)
    if ns.actor_device == "cpu":
        # acting on the host: keep this process off the card entirely
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    cfg = ExperimentConfig(
        env=ns.env, num_envs=ns.num_envs, n_steps=ns.n_steps,
        max_steps=ns.max_steps, seed=ns.seed, noise=ns.noise,
        random_eps=ns.random_eps, her=bool(ns.her), her_ratio=ns.her_ratio,
        actor_device=ns.actor_device)
    steps = run_actor(cfg, ns.learner_host, ns.transitions_port,
                      ns.weights_port, ns.actor_id, ns.max_ticks,
                      secret=ns.secret or None,
                      send_timeout=ns.send_timeout,
                      send_retries=ns.send_retries,
                      drop_on_timeout=bool(ns.drop_on_timeout),
                      codec=ns.codec, trace_sample=ns.trace_sample,
                      expect_generation=bool(ns.expect_generation))
    print(f"collected {steps} env steps")
    return steps


if __name__ == "__main__":
    main()
