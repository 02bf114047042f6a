"""Throttled sender lanes: the per-actor load the fleet plane stresses.

Counterpart of ``d4pg_tpu/fleet/sender.py``. A ``ThrottledSender`` is
not a full actor (no env, no policy, no n-step folder): it is the
transport-facing slice of one, a paced stream of transition blocks
pushed through a real ``CoalescingSender`` over real TCP, with a seeded
``ActorChaos`` stream deciding per block whether to deliver, drop, delay
or crash. That slice is what saturates at a 256-actor fan-out, so it is
what the harness scales to 256 of on one host: a lane costs one mostly
sleeping thread and one shared block, where a full actor would cost an
env pool and a policy per lane and measure the host's cores instead.

Lanes run as threads by default; ``FleetHarness(mode='process')`` runs
the same loop (``_process_lane_main``) in spawned processes, and
``mode='actor'`` spawns real ``actor_main.run_actor`` processes
(``_actor_lane_main``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from d4pg_tpu_torch.distributed.transport import (
    CoalescingSender,
    ReconnectingClient,
)
from d4pg_tpu_torch.fleet.chaos import ActorChaos
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.replay.uniform import TransitionBatch


def synthetic_block(rows: int, obs_dim: int, act_dim: int,
                    seed: int = 0) -> TransitionBatch:
    """One reusable block of random transitions (shared read-only by every
    lane — the senders copy rows into their own preallocated columns, so
    one template serves a 256-lane fleet without 256 payload copies)."""
    rng = np.random.default_rng(seed)
    return TransitionBatch(
        obs=rng.standard_normal((rows, obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (rows, act_dim)).astype(np.float32),
        reward=rng.standard_normal(rows).astype(np.float32),
        next_obs=rng.standard_normal((rows, obs_dim)).astype(np.float32),
        done=np.zeros(rows, np.float32),
        discount=np.full(rows, 0.99, np.float32),
    )


class ThrottledSender:
    """One fleet lane: throttled blocks through a chaos-wrapped transport.

    The loop per tick: draw the next chaos event, then deliver / drop /
    delay / crash accordingly, then sleep out the remainder of the tick
    period (``block_rows / rows_per_sec``). A lane that falls behind does
    NOT burst to catch up — the throttle bounds offered load so the sweep
    measures the plane at a known demand, not a thundering herd.

    Crash semantics: the socket is torn down abruptly — no flush, no
    shutdown handshake — exactly what a SIGKILL'd actor process looks
    like to the learner. After ``restart_delay_s`` the lane reconnects
    (bounded attempts, counted) and the first DELIVERED block closes the
    crash→recovery interval recorded in ``recovery_s``.
    """

    def __init__(
        self,
        actor_index: int,
        actor_id: str,
        host: str,
        port: int,
        template: TransitionBatch,
        chaos: ActorChaos,
        rows_per_sec: float = 20.0,
        send_timeout: float = 1.0,
        max_retries: Optional[int] = 4,
        secret: Optional[str] = None,
        max_ticks: Optional[int] = None,
        stop: Optional[threading.Event] = None,
        connect_stagger_s: float = 0.0,
        codec: str = "npz",
        trace_sample: float = 0.0,
        expect_generation: bool = False,
        reconnect_jitter_s: float = 0.0,
        rate_fn=None,
    ):
        self.actor_index = actor_index
        self.actor_id = actor_id
        self._addr = (host, port)
        self._template = template
        self.chaos = chaos
        self._block_rows = int(np.asarray(template.obs).shape[0])
        self._period = self._block_rows / float(rows_per_sec)
        # Elastic traffic model (elastic/traffic.py): rate_fn maps MODEL
        # time (seconds of offered load already emitted, a pure
        # recurrence over the lane's own tick periods) to rows/sec. Model
        # time — not the wall clock — keeps the offered-load trace a
        # deterministic function of the seed: scheduler jitter changes
        # when blocks go out, never how many.
        self._rate_fn = rate_fn
        self._model_t = 0.0
        self._send_timeout = send_timeout
        self._max_retries = max_retries
        self._secret = secret
        self._max_ticks = max_ticks
        self._stop = stop if stop is not None else threading.Event()
        self._connect_stagger_s = connect_stagger_s
        self._codec = codec
        self._trace_sample = float(trace_sample)
        # crash-recovery plane: read the receiver's generation greeting
        # (service_chaos runs — the receiver must be greeting-armed) and
        # spread the post-service-restart reconnect storm with a seeded
        # per-actor upward jitter on the first retry of an episode
        self._expect_generation = bool(expect_generation)
        self._reconnect_jitter_s = float(reconnect_jitter_s)
        # counters (absorbed across crash-replaced sender instances)
        self.storm_jitters = 0
        self.storm_jitter_s: list[float] = []
        self.frames_traced = 0
        self.ticks = 0
        self.rows_attempted = 0
        self.rows_delivered = 0
        self.rows_dropped_chaos = 0
        self.rows_dropped_backpressure = 0
        self.retries = 0
        self.crashes = 0
        self.failed_restarts = 0
        self.recovery_s: list[float] = []
        self.latencies_ms: list[float] = []
        self._crashed_at: float | None = None

    # -- lifecycle ---------------------------------------------------------
    def _make_sender(self) -> CoalescingSender:
        # One frame per tick: min_block == max_block == the template size,
        # and the interval flush is disabled — the lane, not the coalescer,
        # paces the stream. backoff keeps retries inside the send budget.
        return CoalescingSender(
            self._addr[0], self._addr[1], actor_id=self.actor_id,
            secret=self._secret, retry_timeout=self._send_timeout,
            max_retries=self._max_retries, drop_on_timeout=True,
            min_block=self._block_rows, max_block=self._block_rows,
            flush_interval=1e9, backoff_base=0.05, backoff_max=1.0,
            backoff_seed=self.chaos.config.seed * 100_003 + self.actor_index,
            codec=self._codec,
            trace_sample=self._trace_sample,
            expect_generation=self._expect_generation,
            reconnect_jitter_s=self._reconnect_jitter_s,
        )

    def _absorb(self, sender: CoalescingSender) -> None:
        self.rows_delivered += sender.delivered_rows
        self.rows_dropped_backpressure += sender.dropped_rows
        self.retries += sender.retries
        self.frames_traced += sender.frames_traced
        self.storm_jitters += sender.storm_jitters
        self.storm_jitter_s.extend(sender.storm_jitter_s)

    def _sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._stop.wait(seconds)

    # -- the lane loop -----------------------------------------------------
    def run(self) -> None:
        try:
            self._run_lane()
        except Exception as e:  # noqa: BLE001 — top frame of the lane
            contained_crash("fleet.sender", e)

    def _run_lane(self) -> None:
        self._sleep(self._connect_stagger_s)  # de-synchronize the storm
        sender = self._reconnect()
        next_t = time.monotonic()
        try:
            while not self._stop.is_set() and (
                    self._max_ticks is None or self.ticks < self._max_ticks):
                ev = self.chaos.next()
                self.ticks += 1
                if ev.kind == "crash":
                    self.crashes += 1
                    self._crashed_at = time.monotonic()
                    if sender is not None:
                        self._absorb(sender)
                        # abrupt death: skip CoalescingSender.close's flush
                        ReconnectingClient.close(sender)
                    sender = None
                    self._sleep(ev.arg)
                    sender = self._reconnect()
                elif ev.kind == "drop":
                    self.rows_dropped_chaos += self._block_rows
                else:
                    if ev.kind == "delay":
                        self._sleep(ev.arg)
                    if sender is None:
                        sender = self._reconnect()
                    if sender is not None:
                        self._send_block(sender)
                if self._rate_fn is not None:
                    # traffic-model pacing: recompute the tick period from
                    # the modeled rate at the lane's model clock, then
                    # advance the clock by that period
                    rate = max(1e-6, float(self._rate_fn(self._model_t)))
                    self._period = self._block_rows / rate
                    self._model_t += self._period
                next_t += self._period
                wait = next_t - time.monotonic()
                if wait > 0:
                    self._sleep(wait)
                else:
                    next_t = time.monotonic()  # behind: no catch-up burst
        finally:
            if sender is not None:
                self._absorb(sender)
                try:
                    ReconnectingClient.close(sender)
                except OSError:
                    pass

    def _reconnect(self) -> CoalescingSender | None:
        """Bounded reconnect loop (a restarting actor retries its learner
        address, it does not die on the first refused connect)."""
        for _ in range(20):
            if self._stop.is_set():
                return None
            try:
                return self._make_sender()
            except (OSError, ConnectionError):
                self._sleep(0.1)
        self.failed_restarts += 1
        return None

    def _send_block(self, sender: CoalescingSender) -> None:
        self.rows_attempted += self._block_rows
        t0 = time.perf_counter()
        ok = sender.send(self._template)
        self.latencies_ms.append(1e3 * (time.perf_counter() - t0))
        if ok and self._crashed_at is not None:
            self.recovery_s.append(time.monotonic() - self._crashed_at)
            self._crashed_at = None

    def stop(self) -> None:
        self._stop.set()

    # -- results -----------------------------------------------------------
    def summary(self) -> dict:
        return {
            "actor_id": self.actor_id,
            "ticks": self.ticks,
            "rows_attempted": self.rows_attempted,
            "rows_delivered": self.rows_delivered,
            "rows_dropped_chaos": self.rows_dropped_chaos,
            "rows_dropped_backpressure": self.rows_dropped_backpressure,
            "retries": self.retries,
            "crashes": self.crashes,
            "failed_restarts": self.failed_restarts,
            "frames_traced": self.frames_traced,
            "storm_jitters": self.storm_jitters,
            "storm_jitter_s": list(self.storm_jitter_s),
            "recovery_s": list(self.recovery_s),
            "latencies_ms": list(self.latencies_ms),
            "model_t": self._model_t,
            "chaos_log": [tuple(ev) for ev in self.chaos.log],
        }


def _process_lane_main(kwargs: dict, duration_s: float, out_queue) -> None:
    """Entry point for a subprocess lane (``mp.get_context('spawn')``):
    rebuilds the chaos stream and template from seeds, runs the same lane
    loop for ``duration_s``, ships the summary back over the queue."""
    from d4pg_tpu_torch.fleet.chaos import ChaosConfig

    chaos = ActorChaos(ChaosConfig(**kwargs.pop("chaos_config")),
                       kwargs["actor_index"], kwargs["actor_id"])
    template = synthetic_block(
        kwargs.pop("block_rows"), kwargs.pop("obs_dim"),
        kwargs.pop("act_dim"), seed=kwargs.pop("template_seed"))
    lane = ThrottledSender(template=template, chaos=chaos, **kwargs)
    timer = threading.Timer(duration_s, lane.stop)
    timer.daemon = True
    timer.start()
    try:
        lane.run()
    finally:
        timer.cancel()
        out_queue.put(lane.summary())


def _actor_lane_main(cfg_kwargs: dict, host: str, transitions_port: int,
                     weights_port: int, actor_id: str, max_ticks: int,
                     send_timeout: float, max_retries, out_queue,
                     codec: str = "npz", trace_sample: float = 0.0) -> None:
    """Entry point for a real actor lane (``FleetHarness(mode='actor')``):
    a spawned process running the port's whole ``actor_main.run_actor``
    path (env pool, policy inference, n-step folding, coalescing
    transport, live weight pulls) against the harness's servers. The card
    is hidden from the process and it acts on the CPU with one intra-op
    thread, as ``actor_main.run_local_actor_process`` does; the fleet
    member's degradation policy (shed and count) is on, so a slow
    receiver costs rows, not a wedged lane."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    from d4pg_tpu_torch.actor_main import run_actor
    from d4pg_tpu_torch.config import ExperimentConfig

    torch.set_num_threads(1)
    steps = 0
    try:
        steps = run_actor(ExperimentConfig(**cfg_kwargs), host,
                          transitions_port, weights_port, actor_id=actor_id,
                          max_ticks=max_ticks, send_timeout=send_timeout,
                          send_retries=max_retries, drop_on_timeout=True,
                          codec=codec, trace_sample=trace_sample)
    finally:
        out_queue.put({"actor_id": actor_id, "env_steps": int(steps)})
