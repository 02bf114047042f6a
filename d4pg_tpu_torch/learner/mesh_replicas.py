"""Mesh-native learner replicas: N replicas in one process, merged on the
device.

Counterpart of ``d4pg_tpu/learner/mesh_replicas.py``. The in-process
replica plane (``learner/replica.py`` + ``learner/aggregator.py``) pays,
every round, a device-to-host copy of each replica's networks, host
numpy merge arithmetic and a host-to-device copy of the basis. Here the
replicas' parameters never leave the card: the merge is a few
reductions over one stacked ``[N, ...]`` axis on the device, and each
replica adopts the result with a device copy.

Placement (``parallel/mesh.replica_mesh``): replica i on ``devices[i]``
while there are devices, then round robin, so on one card all N stack
on it. The reference raises ``replica mesh needs N devices`` there; the
port places them instead (a placement rule, not a feature). One process
drives them all: ranks sharing one card would reduce through the host
over gloo (4.80-6.09 ms of host clock per grad step on an H100 for the
data-parallel plane's gradient average, ``PERF.md`` §6).

The stacked state. Each replica keeps its own ``D4PGState``: its
modules, its own ``torch.optim.Adam`` and its own generator. The merge
stacks the four ``PARAM_FIELDS`` at merge time: per dtype, each
replica's tensors concatenated into one row of an ``[N, P]`` tensor
(``torch.cat`` and ``torch.stack``, one launch each), the merge reduces
over the N rows, and every replica copies the merged row back into its
own tensors (``torch._foreach_copy_``). The alternative, the replicas'
parameters as views into a persistent ``[N, P]`` tensor, would make every
``Parameter`` a view: ``copy.deepcopy`` and ``torch.save`` of one
replica then carry the whole N-row storage, and a parameter whose
``.data`` is replaced loses the view silently. Stacking at merge time
leaves Adam's in-place step and ``--share_encoder``'s ties (copies, not
aliases: the actor's encoder is merged from its own equal values) as
they are in one learner, for a copy of a few MB per round.

Merge semantics (``make_collective_merge``), the host ``Aggregator``'s:

  - N = 1: the identity, no arithmetic (the N = 1 oracle stays bitwise
    against ``FusedLoop``: the stack, split and adopting copy move the
    replica's own values);
  - ``sync``: the N rows summed in float64, divided by N (a 0-dim
    float64 divisor on the device: the IEEE quotient), cast back, as
    ``aggregator._mean``;
  - ``async``: round-synchronous submissions in replica order have lag
    i, so the fold starts from replica 0 and blends replica i at
    ``w = float32(max(1 / (1 + i), 1 / clip))`` as ``m + w * (x - m)`` in
    three separate float32 operations (sub, mul, add), exactly
    ``aggregator._blend``; ``torch.lerp`` and ``addcmul`` round
    differently or contract to an FMA, so neither is used. The fold is
    bitwise the host aggregator's.

A merge copies nothing to the host and waits for nothing: the store
publishes with ``to_host=False`` (a device copy queued behind the
merge), and ``last_merge_s`` is the host's enqueue time.

The engines. ``load(buffer)`` drains a host-filled ``FusedDeviceReplay``
and shares its ring storage, read only, among the replicas on its card
(the chunk never writes storage; a replica on another card gets a
copy); each replica gets its own copy of the PER trees and its own live
size. ``_fused_steps`` / ``run_round`` run the port's fused chunk
(``learner/fused.make_fused_chunk``) for each replica in turn on one
stream, chunk by chunk, each replica sampling with its own state's
generator (the reference's replica samples with its own key); on the
card that is the descent kernel and the arm's projection kernels once
per replica per grad step. ``step_host_chunks`` trains replica i on the
i-th of ``[N, K, B, ...]`` host chunks through ``multi_update_step``,
the K-step update ``LearnerReplica``'s host mode runs. There is no
``torch.func.vmap``: the CUDA kernels have no batching rule and Adam
steps in place, so a loop over the replicas is the simple, correct
design.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from d4pg_tpu_torch.learner.aggregator import tree_map
from d4pg_tpu_torch.learner.fused import make_fused_chunk
from d4pg_tpu_torch.learner.replica import _MODULES, PARAM_FIELDS
from d4pg_tpu_torch.learner.state import (
    D4PGConfig,
    D4PGState,
    refuse_contrastive,
)
from d4pg_tpu_torch.learner.update import multi_update_step
from d4pg_tpu_torch.parallel.mesh import replica_mesh
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.uniform import TransitionBatch

MODES = ("async", "sync")


def _fold(x: torch.Tensor, clip: float) -> torch.Tensor:
    """The async fold over the rows of ``x`` [N, ...] (module docstring)."""
    m = x[0].clone()
    for i in range(1, x.shape[0]):
        w = torch.full((), float(np.float32(max(1.0 / (1.0 + i),
                                                1.0 / clip))),
                       dtype=x.dtype, device=x.device)
        d = x[i] - m
        d.mul_(w)
        m.add_(d)
    return m


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The sync average over the rows of ``x`` [N, ...]."""
    n = torch.full((), float(x.shape[0]), dtype=torch.float64,
                   device=x.device)
    return (x.to(torch.float64).sum(0) / n).to(x.dtype)


def make_collective_merge(n: int, mode: str,
                          clip: float = 8.0) -> Callable[[Any], Any]:
    """The merge of a tree (nested dicts) of ``[N, ...]`` stacked tensors
    into the tree of merged tensors (module docstring). Raises for an
    unknown mode or ``clip < 1``, as the reference does."""
    if mode not in MODES:
        raise ValueError(f"unknown aggregation mode {mode!r}")
    if clip < 1.0:
        raise ValueError(f"clip={clip} must be >= 1 (floor 1/clip <= 1)")

    def merge(stacked: Any) -> Any:
        if n == 1:
            return tree_map(lambda x: x[0], stacked)  # exact identity
        if mode == "sync":
            return tree_map(_mean, stacked)
        return tree_map(lambda x: _fold(x, clip), stacked)

    return merge


def _param_tensors(state: D4PGState) -> list[tuple[str, str, torch.Tensor]]:
    """``(field, name, tensor)`` of the four networks in a fixed order;
    the tensors share storage with the modules (``state_dict``)."""
    return [(f, name, t) for f in PARAM_FIELDS
            for name, t in getattr(state, _MODULES[f]).state_dict().items()]


class MeshReplicaGroup:
    """N learner replicas in one process, merged on the device.

    ``states`` are the per-replica initial ``D4PGState``s (the driver
    builds them with ``learner/replica.replica_state``: identical
    networks, each its own Adam states and generator); the group owns
    and updates them. ``store`` is an optional ``WeightStore``: each
    round's merged params are published through it (``extract`` /
    ``norm_stats`` as in ``Aggregator``). ``devices`` is the placement's
    device list (``replica_mesh``); ``None`` keeps each state on its own
    device. The fused engine needs ``load(buffer)``;
    ``step_host_chunks`` is the service-sampled engine of the driver."""

    def __init__(
        self,
        config: D4PGConfig,
        states: list[D4PGState],
        *,
        k: int,
        batch_size: int,
        mode: str = "async",
        clip: float = 8.0,
        store=None,
        extract: Optional[Callable[[Any], Any]] = None,
        norm_stats: Optional[Callable[[], tuple | None]] = None,
        prioritized: bool = True,
        alpha: float = 0.6,
        beta0: float = 0.4,
        beta_steps: int = 100_000,
        devices=None,
    ):
        refuse_contrastive(config, "the replica group")
        self.n = len(states)
        if self.n < 1:
            raise ValueError("need at least one replica state")
        self._merge_fn = make_collective_merge(self.n, mode, clip)
        self.devices = ([s.device for s in states] if devices is None
                        else replica_mesh(self.n, devices))
        for i, (s, dev) in enumerate(zip(states, self.devices)):
            if s.device != dev:
                raise ValueError(
                    f"replica {i}'s state is on {s.device}, its placement "
                    f"is {dev}: build it there (replica_state on the "
                    "placement's device)")
        self._config = config
        self._states = list(states)
        self.k = max(1, int(k))
        self._batch_size = int(batch_size)
        self.mode = mode
        self.clip = float(clip)
        self._store = store
        self._extract = extract
        self._norm_stats = norm_stats
        self._prioritized = bool(prioritized)
        self._alpha = float(alpha)
        self._beta0 = float(beta0)
        self._beta_steps = int(beta_steps)
        self._storage: dict | None = None
        self._trees: list | None = None
        self._sizes: list[int] | None = None
        self._chunk_fns: dict[int, Callable] = {}
        self.steps_done = 0  # per-replica grad steps
        self.rounds = 0
        self.last_merge_s: Optional[float] = None
        self.last_metrics = None
        self._merged = None  # the last merged tree (device tensors)
        self._versions: list[int] = []

    # -- replay engines ------------------------------------------------------
    def load(self, buffer) -> None:
        """Drain a host-filled ``FusedDeviceReplay``; share its ring with
        the replicas on its card (a copy for each other card), give each
        replica its own copy of the PER trees and its live size."""
        buffer.drain()
        storage = buffer.storage
        self._storage = {
            dev: storage if dev == storage.obs.device
            else TransitionBatch(*[t.to(dev) for t in storage])
            for dev in dict.fromkeys(self.devices)}
        self._trees = ([dper.PerTrees(*[t.to(dev, copy=True)
                                        for t in buffer.trees])
                        for dev in self.devices]
                       if self._prioritized else None)
        self._sizes = [int(buffer.size)] * self.n

    def _chunk_for(self, k: int) -> Callable:
        """The fused chunk of length ``k`` (cached)."""
        if k not in self._chunk_fns:
            self._chunk_fns[k] = make_fused_chunk(
                self._config, k=k, batch_size=self._batch_size,
                prioritized=self._prioritized, alpha=self._alpha,
                beta0=self._beta0, beta_steps=self._beta_steps)
        return self._chunk_fns[k]

    def _fused_steps(self, n: int) -> None:
        if self._storage is None:
            raise RuntimeError("fused engine not loaded: call load(buffer)")
        done = 0
        while done < n:
            k = min(self.k, n - done)
            fn = self._chunk_for(k)
            metrics = []
            for i, (state, dev) in enumerate(zip(self._states,
                                                 self.devices)):
                storage = self._storage[dev]
                if self._prioritized:
                    self._trees[i], m = fn(state, self._trees[i], storage,
                                           self._sizes[i],
                                           generator=state.generator)
                else:
                    m = fn(state, storage, self._sizes[i],
                           generator=state.generator)
                metrics.append(m)
            self.last_metrics = self._stack(metrics)
            done += k
        self.steps_done += done

    def step_host_chunks(self, batches, weights=None) -> dict:
        """The service-sampled engine: replica i trains on ``batches[i]``
        of ``[N, K, B, ...]`` host chunks (and IS ``weights[i]`` [K, B])
        through ``multi_update_step``. Returns the stacked metrics: [N, K]
        scalars and [N, K, B] ``td_error`` (for the PER write-back)."""
        metrics = []
        for i, (state, dev) in enumerate(zip(self._states, self.devices)):
            b = TransitionBatch(*[torch.as_tensor(f[i], device=dev)
                                  for f in batches])
            w = (None if weights is None
                 else torch.as_tensor(weights[i], device=dev))
            metrics.append(multi_update_step(self._config, state, b, w))
        self.steps_done += int(np.shape(batches[0])[1])  # [N, K, ...] -> K
        self.last_metrics = self._stack(metrics)
        return self.last_metrics

    def _stack(self, metrics: list[dict]) -> dict:
        dev = self.devices[0]
        return {name: torch.stack([m[name].to(dev) for m in metrics])
                for name in metrics[0]}

    # -- the round -----------------------------------------------------------
    def merge(self) -> Any:
        """Merge the replicas' current params on the device, adopt the
        result as every replica's next basis (device copies), publish it
        through the store when one is attached. Returns the merged tree
        ``{field: {name: tensor}}`` on ``devices[0]``."""
        t0 = time.perf_counter()
        merged = self._merge_stacked()
        self.last_merge_s = time.perf_counter() - t0
        self._merged = merged
        self.rounds += 1
        if self._store is not None:
            pub = self._extract(merged) if self._extract else merged
            norm = self._norm_stats() if self._norm_stats else None
            step = max(int(s.step) for s in self._states)
            self._versions.append(self._store.publish(
                pub, step=step, to_host=False, norm_stats=norm))
        return merged

    @torch.no_grad()
    def _merge_stacked(self) -> dict:
        dev0 = self.devices[0]
        per_replica = [_param_tensors(s) for s in self._states]
        layout = per_replica[0]
        dtypes = list(dict.fromkeys(t.dtype for _, _, t in layout))
        merged = {f: {} for f in PARAM_FIELDS}
        for dt in dtypes:
            pos = [j for j, (_, _, t) in enumerate(layout) if t.dtype == dt]
            stacked = torch.stack([
                torch.cat([tensors[j][2].reshape(-1) for j in pos]).to(dev0)
                for tensors in per_replica])  # [N, P]
            row = self._merge_fn({"row": stacked})["row"]  # [P]
            views = torch.split(row, [layout[j][2].numel() for j in pos])
            for j, v in zip(pos, views):
                f, name, t = layout[j]
                merged[f][name] = v.view(t.shape)
            for i, tensors in enumerate(per_replica):
                src = row if self.devices[i] == dev0 else row.to(
                    self.devices[i])
                torch._foreach_copy_(
                    [tensors[j][2] for j in pos],
                    [v.view(layout[j][2].shape) for j, v in zip(
                        pos, torch.split(src, [layout[j][2].numel()
                                               for j in pos]))])
        for state in self._states:
            state.targets_tied = False  # the merged targets may be untied
        return merged

    def run_round(self, n: int) -> dict:
        """One round: ``n`` fused grad steps per replica, then the merge
        (the counterpart of N thread replicas each doing basis adoption,
        ``n`` steps and a submit)."""
        self._fused_steps(n)
        self.merge()
        return {"rounds": self.rounds, "steps": self.steps_done,
                "merge_s": self.last_merge_s,
                "version": self._versions[-1] if self._versions else None}

    # -- inspection ----------------------------------------------------------
    def merged_params(self, to_host: bool = True) -> Any:
        """The last merged tree (None before the first merge), copied to
        the host by default."""
        if self._merged is None:
            return None
        if not to_host:
            return self._merged
        return tree_map(lambda t: t.to("cpu", copy=True), self._merged)

    def state_slice(self, i: int) -> D4PGState:
        """Replica ``i``'s live state."""
        return self._states[i]

    @property
    def versions(self) -> list[int]:
        return list(self._versions)

    def stats(self) -> dict:
        return {"n": self.n, "mode": self.mode, "rounds": self.rounds,
                "steps": self.steps_done, "merge_s": self.last_merge_s,
                "devices": [str(d) for d in self.devices]}

    def close(self) -> None:
        self._chunk_fns.clear()
        self._storage = None
        self._trees = None
