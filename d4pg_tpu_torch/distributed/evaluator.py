"""Evaluator: greedy rollouts against the latest published weights.

Counterpart of ``Evaluator`` and ``AsyncEvaluator`` in
``d4pg_tpu/distributed/evaluator.py``: run n greedy episodes with the
weights the ``WeightStore`` holds, report their mean return, the
0.95/0.05 EWMA of it, the success rate and the learner step the weights
were published at. ``AsyncEvaluator`` runs the rollouts on a background
thread, so the learner never waits for them; a failed eval is printed
and the thread goes on, and a crash of the thread's own loop is counted
(``obs.containment.contained_crash``). Inference goes through the
same policy client as the actors (``serving/client``), on the CPU by
default. A goal-conditioned env's dict observation is flattened to
[observation, desired goal] and ``success_rate`` reads the env's
``is_success`` (``goal_conditioned`` is the reference's flag; the
flattening keys on the observation's type, as there), and ``obs_norm`` (the service's live
``RunningMeanStd``, read only) standardizes the policy input as the
replay rows were.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np

from d4pg_tpu_torch.envs.wrappers import flatten_goal_obs, rescale_action
from d4pg_tpu_torch.learner.state import D4PGConfig
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.serving.client import ActorConfig, LocalPolicyClient

EWMA_OLD, EWMA_NEW = 0.95, 0.05


class Evaluator:
    def __init__(
        self,
        config: D4PGConfig,
        env_fn: Callable[[], object],
        weights,
        max_steps: int = 1000,
        goal_conditioned: bool = False,
        device: str = "cpu",
        obs_norm=None,
        learner_device=None,
    ):
        self.config = config
        self.env = env_fn()
        self.weights = weights
        self.max_steps = max_steps
        self.goal_conditioned = goal_conditioned
        # the policy was trained on normalized rows: greedy eval applies
        # the same (current) statistics, read only
        self.obs_norm = obs_norm
        self.ewma_return: Optional[float] = None
        self._low = np.asarray(self.env.action_space.low, np.float32)
        self._high = np.asarray(self.env.action_space.high, np.float32)
        self.policy = LocalPolicyClient(
            config, ActorConfig(device=device), weights,
            learner_device=learner_device)

    def _greedy_episode(self, seed: int | None = None) -> tuple[float, bool]:
        reset_kw = {"seed": seed} if seed is not None else {}
        obs, _ = self.env.reset(**reset_kw)
        total, success = 0.0, False
        for _ in range(self.max_steps):
            flat = flatten_goal_obs(obs)
            if self.obs_norm is not None:
                flat = self.obs_norm.normalize(flat)
            a = self.policy.greedy_actions(flat[None])[0]
            obs, r, term, trunc, info = self.env.step(
                rescale_action(a, self._low, self._high))
            total += float(r)
            success = success or bool(info.get("is_success", False))
            if term or trunc:
                break
        return total, success

    def evaluate(self, n_trials: int = 10, seed: int | None = None) -> dict:
        """Run n greedy trials; returns the mean return, its EWMA, the
        success rate and the learner step of the evaluated weights."""
        _, published_step = self.policy.snapshot_pull()
        returns, successes = [], []
        for i in range(n_trials):
            ep_seed = None if seed is None else seed + i
            ret, suc = self._greedy_episode(ep_seed)
            returns.append(ret)
            successes.append(suc)
        avg = float(np.mean(returns))
        if self.ewma_return is None:
            self.ewma_return = avg
        else:
            self.ewma_return = EWMA_OLD * self.ewma_return + EWMA_NEW * avg
        return {
            "avg_test_reward": avg,
            "ewma_test_reward": self.ewma_return,
            "success_rate": float(np.mean(successes)),
            "learner_step": published_step,
        }


class AsyncEvaluator:
    """Evaluation on a background thread: ``request()`` enqueues an eval
    against the current weights (dropped when one is already queued) and
    ``latest()`` returns the most recent completed result."""

    def __init__(self, evaluator: Evaluator):
        self._ev = evaluator
        self._requests: queue.Queue = queue.Queue(maxsize=1)
        self._latest: Optional[dict] = None
        self._lock = threading.Lock()
        # accepted-but-unfinished requests: raised before the queue put,
        # lowered after the eval ends, so wait() cannot slip between the
        # worker's dequeue and the rollouts
        self._outstanding = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def request(self, n_trials: int, seed: int | None = None) -> bool:
        with self._lock:
            self._outstanding += 1
        try:
            self._requests.put_nowait((n_trials, seed))
            return True
        except queue.Full:
            with self._lock:
                self._outstanding -= 1
            return False

    def latest(self) -> Optional[dict]:
        with self._lock:
            return None if self._latest is None else dict(self._latest)

    def wait(self, timeout: float = 300.0) -> Optional[dict]:
        """Wait for pending requests; returns the final metrics."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._outstanding == 0:
                    break
            time.sleep(0.01)
        return self.latest()

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    n_trials, seed = self._requests.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    result = self._ev.evaluate(n_trials, seed=seed)
                    with self._lock:
                        self._latest = result
                except Exception:  # noqa: BLE001 — an eval crash must not kill training
                    print(f"evaluator failed:\n{traceback.format_exc()}",
                          flush=True)
                finally:
                    with self._lock:
                        self._outstanding -= 1
        except Exception as e:  # noqa: BLE001 — counted, not silent
            contained_crash("evaluator.loop", e)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
