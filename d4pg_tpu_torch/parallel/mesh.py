"""The rank mesh: one process per rank, one device per rank; and the
replica placement.

Counterpart of ``d4pg_tpu/parallel/mesh.py``. The reference's mesh is one
process over N devices (single host) or one process per host over that
host's devices (multi-host). Here both are ranks of one
``torch.distributed`` process group, each rank on one device: the Ape-X
layout the reference's multi-host path already uses, where each rank owns
its replay shards and its actors and only gradients and a few scalars
cross ranks.

A ``RankMesh`` is this rank's view of the ``(data, model)`` mesh: the
world size, its rank, the model-parallel degree ``model_parallel`` (mp),
the data-axis shards it owns (``n_local`` per rank, so ``n_shards =
world / mp * n_local``), its device, the backend and the groups. Rank r
sits at ``(r // mp, r % mp)``: data index, model index, the order in
which the reference reshapes its devices into ``(dp, mp)``. The ranks
that share a model index form a data group (gradients and metrics are
averaged over it), the ranks of one data row a model group (the split
encoder's activations are gathered over it, ``parallel/model_axis.py``).
A world of 1 has no process group and its reductions are local: that is
the world-1 mesh itself (``RankMesh.local``), one process that may hold
several shards, as the reference's single-host mesh holds one per device.

Collectives go through these groups: ``group`` carries device tensors
over the world (``nccl`` when every rank on a host has a card of its
own, else the gloo group), ``data_group`` and ``model_group`` device
tensors over the two axes (the world group and none at mp = 1), and
``cpu_group`` (gloo) carries host values: pad widths, normalizer deltas,
resume agreement. Gloo reduces CUDA tensors through ``all_reduce`` and
``broadcast`` only, so those are the only collectives on device tensors
under gloo: the model axis gathers through an ``all_reduce`` of a
zero-filled full tensor (exact: it adds zeros), and through
``all_gather_into_tensor`` under nccl.

``replica_mesh`` is the placement of mesh-native learner replicas
(``learner/mesh_replicas.py``): replica i on device i while there are
devices, then round robin, so on one card every replica stacks on it.
The reference raises when there are fewer devices than replicas; in the
port that is a placement rule, not a refusal.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
# mesh-native learner replicas: an [N, ...] stack of per-replica states
# and the merge over it (``learner/mesh_replicas.py``)
REPLICA_AXIS = "replica"

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Mesh geometry: data_parallel x model_parallel devices."""

    data_parallel: int = -1  # -1: all remaining devices
    model_parallel: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        mp = max(1, self.model_parallel)
        dp = self.data_parallel
        if dp == -1:
            if n_devices % mp:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"model_parallel={mp}")
            dp = n_devices // mp
        if dp * mp != n_devices:
            raise ValueError(
                f"mesh {dp}x{mp} != {n_devices} devices; fix MeshSpec")
        return dp, mp


def replica_mesh(n_replicas: int, devices=None) -> list[torch.device]:
    """Replica i's device: ``devices[i]`` while there are devices, then
    round robin (see the module docstring). ``devices`` defaults to every
    CUDA card, and raises without one."""
    if int(n_replicas) < 1:
        raise ValueError(f"n_replicas={n_replicas} must be >= 1")
    if devices is None:
        from d4pg_tpu_torch import resolve_device

        resolve_device("cuda")  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("replica_mesh needs at least one device")
    return [devices[i % len(devices)] for i in range(int(n_replicas))]


@dataclasses.dataclass
class RankMesh:
    """This rank's view of the mesh (see the module docstring)."""

    world: int
    rank: int
    device: torch.device
    n_local: int = 1
    backend: str | None = None  # None: a world of 1, no process group
    group: Any = None  # device tensors, every rank
    cpu_group: Any = None  # host values (gloo)
    model_parallel: int = 1
    data_group: Any = None  # device tensors, the ranks of one model index
    model_group: Any = None  # device tensors, the ranks of one data row
    # host seconds spent in this rank's model-axis and data-axis
    # collectives (the split encoder's gathers and gradient sums; the
    # gradient and metric averages)
    comm_s: dict = dataclasses.field(
        default_factory=lambda: {"model": 0.0, "data": 0.0})

    @classmethod
    def local(cls, device: str | torch.device,
              n_local: int = 1) -> "RankMesh":
        """The world-1 mesh: one process holding ``n_local`` shards."""
        return cls(world=1, rank=0, device=torch.device(device),
                   n_local=int(n_local))

    @property
    def data_size(self) -> int:
        """Ranks along the data axis (dp)."""
        return self.world // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    @property
    def n_shards(self) -> int:
        return self.data_size * self.n_local

    @property
    def local_start(self) -> int:
        """The first data-axis shard this rank owns (by data index: the
        ranks of one data row hold the same shards)."""
        return self.data_index * self.n_local

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _group(self, t: torch.Tensor):
        return self.cpu_group if t.device.type == "cpu" else self.group

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place over every rank (``sum``, ``min`` or ``max``)."""
        if self.world > 1:
            import torch.distributed as dist

            dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]),
                            group=self._group(t))
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the sum over the data axis divided by its size (a
        0-dim divisor on ``t``'s device: the IEEE quotient on every
        device). At mp = 1 that is every rank."""
        if self.data_size > 1:
            import torch.distributed as dist

            t0 = time.perf_counter()
            group = (self._group(t) if self.model_parallel == 1
                     else self.data_group)
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            t.div_(torch.full((), float(self.data_size), dtype=t.dtype,
                              device=t.device))
            self.comm_s["data"] += time.perf_counter() - t0
        return t

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the sum over this rank's model group."""
        if self.model_parallel > 1:
            import torch.distributed as dist

            t0 = time.perf_counter()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.model_group)
            self.comm_s["model"] += time.perf_counter() - t0
        return t

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's ``t`` joined along ``dim`` in model-index
        order (a new contiguous tensor)."""
        t = t.contiguous()
        mp = self.model_parallel
        if mp == 1:
            return t
        import torch.distributed as dist

        t0 = time.perf_counter()
        if self.backend == "nccl":
            flat = torch.empty((mp, *t.shape), dtype=t.dtype,
                               device=t.device)
            dist.all_gather_into_tensor(flat, t, group=self.model_group)
            out = torch.cat(flat.unbind(0), dim=dim)
        else:
            # gloo: an all_reduce of a zero-filled full tensor into which
            # each rank wrote its slice (exact: the other terms are zeros)
            shape = list(t.shape)
            n = shape[dim]
            shape[dim] = n * mp
            out = torch.zeros(shape, dtype=t.dtype, device=t.device)
            out.narrow(dim, self.model_index * n, n).copy_(t)
            dist.all_reduce(out, op=dist.ReduceOp.SUM,
                            group=self.model_group)
        self.comm_s["model"] += time.perf_counter() - t0
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.world > 1:
            import torch.distributed as dist

            dist.broadcast(t, src=src, group=self._group(t))
        return t

    def gather_host(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's ``arr`` (same shape and dtype), stacked in rank
        order [world, ...], over the host group."""
        arr = np.ascontiguousarray(arr)
        if self.world == 1:
            return arr[None].copy()
        import torch.distributed as dist

        mine = torch.from_numpy(arr.copy())
        out = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(out, mine, group=self.cpu_group)
        return np.stack([t.numpy() for t in out])

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` on every rank (pickled over the host
        group; tensors inside must be on the CPU)."""
        if self.world == 1:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.cpu_group)
        return box[0]

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self.cpu_group)

    def describe(self) -> str:
        model = (f", model axis {self.model_parallel} (data index "
                 f"{self.data_index}, model index {self.model_index})"
                 if self.model_parallel > 1 else "")
        return (f"rank {self.rank}/{self.world} on {self.device}, shards "
                f"[{self.local_start}, {self.local_start + self.n_local}) "
                f"of {self.n_shards}{model}, backend "
                f"{self.backend or 'none'}")
