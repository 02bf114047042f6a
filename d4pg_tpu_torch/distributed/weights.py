"""Versioned weight distribution from learner to actors and evaluator.

Counterpart of ``d4pg_tpu/distributed/weights.py``: the learner publishes
actor parameters with a version number; actors and the evaluator pull
when they see a newer version. A publish may carry the observation
normalizer's ``(mean, std, clip)`` snapshot (``norm_stats``), which the
TCP weight server ships to remote actors with the weights. The
reference's fencing state (a generation, publish timestamps) and the
relay's verbatim republish (``publish_versioned``) serve the v2 weight
plane and wait for it (ROADMAP Queue 1 item 12).

Copy rule: the port's learner updates its modules in place (an Adam step
writes into the very tensors an ``nn.Module`` holds), where a JAX array
never changes. So ``publish`` never stores a reference to the learner's
tensors: it stores a copy of every tensor, on the CPU by default, or on
the tensor's own device with ``to_host=False`` (a device copy queued on
the learner's stream, so it holds the weights as of the publish, not as
of the next Adam step, without a host sync). Readers get a dict of
parameter name -> tensor that nothing else writes.
"""

from __future__ import annotations

from typing import Any

import torch

from d4pg_tpu_torch.core.locking import TieredLock


def copy_params(params: Any, to_host: bool = True) -> dict[str, torch.Tensor]:
    """Detached copies of ``params`` (an ``nn.Module`` or a mapping of
    name -> tensor): on the CPU, or on each tensor's own device with
    ``to_host=False``."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if to_host:
        return {name: t.detach().to("cpu", copy=True)
                for name, t in params.items()}
    return {name: t.detach().clone() for name, t in params.items()}


class WeightStore:
    """Thread-safe versioned parameter store (single writer, many
    readers). All state sits under one declared-tier lock (``wstore``)."""

    def __init__(self):
        self._store_lock = TieredLock("wstore")
        self._version = 0
        self._params: dict[str, torch.Tensor] | None = None
        self._step = 0
        self._norm_stats: tuple | None = None

    def publish(self, params: Any, step: int, to_host: bool = True,
                norm_stats: tuple | None = None) -> int:
        """Learner side: publish a copy of the actor's parameters (see the
        module docstring). ``to_host=True`` copies to the CPU, which waits
        for the learner's queued work on the card; ``to_host=False``
        copies on the card without waiting. ``norm_stats`` is the
        normalizer's ``(mean, std, clip)`` snapshot, kept until a later
        publish brings another. Returns the new version."""
        copied = copy_params(params, to_host)
        with self._store_lock:
            self._version += 1
            self._params = copied
            self._step = int(step)
            if norm_stats is not None:
                self._norm_stats = norm_stats
            return self._version

    @property
    def norm_stats(self) -> tuple | None:
        """The last published (mean, std, clip), or None when observation
        normalization is off."""
        with self._store_lock:
            return self._norm_stats

    @property
    def version(self) -> int:
        with self._store_lock:
            return self._version

    @property
    def step(self) -> int:
        """Learner step at the last publish."""
        with self._store_lock:
            return self._step

    def get(self) -> tuple[int, Any]:
        """Reader side: (version, params); params None until the first
        publish."""
        with self._store_lock:
            return self._version, self._params

    def snapshot(self) -> tuple[int, Any, int]:
        """(version, params, step) read atomically."""
        with self._store_lock:
            return self._version, self._params, self._step

    def snapshot_ex(self) -> dict:
        """Version, params, step and norm stats in one lock round trip
        (the weight server's read: a publish between separate reads would
        pair one version's params with another's step or statistics)."""
        with self._store_lock:
            return {
                "version": self._version,
                "params": self._params,
                "step": self._step,
                "norm_stats": self._norm_stats,
            }

    def get_if_newer(self, have_version: int) -> tuple[int, Any] | None:
        with self._store_lock:
            if self._version > have_version:
                return self._version, self._params
            return None
