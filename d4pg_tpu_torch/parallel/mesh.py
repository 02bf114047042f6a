"""The rank mesh: one process per rank, one device per rank.

Counterpart of ``d4pg_tpu/parallel/mesh.py``. The reference's mesh is one
process over N devices (single host) or one process per host over that
host's devices (multi-host). Here both are ranks of one
``torch.distributed`` process group, each rank on one device: the Ape-X
layout the reference's multi-host path already uses, where each rank owns
its replay shards and its actors and only gradients and a few scalars
cross ranks.

A ``RankMesh`` is this rank's view of the ``data`` axis: the world size,
its rank, the data-axis shards it owns (``n_local`` per rank, so
``n_shards = world * n_local``), its device, the backend and the groups.
A world of 1 has no process group and its reductions are local: that is
the world-1 mesh itself (``RankMesh.local``), one process that may hold
several shards, as the reference's single-host mesh holds one per device.

Collectives go through two groups: ``group`` carries device tensors
(``nccl`` when every rank on a host has a card of its own, else the gloo
group) and ``cpu_group`` (gloo) carries host values: pad widths,
normalizer deltas, resume agreement. Gloo reduces CUDA tensors through
``all_reduce`` and ``broadcast`` only, so those are the only collectives
on device tensors.

The ``model`` axis keeps its name and its place in ``MeshSpec``; a
``model_parallel > 1`` mesh is not ported (ROADMAP Queue 1 item 16b).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
# mesh-native learner replicas (ROADMAP Queue 1 item 15b)
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


def check_model_axis(model_parallel: int) -> None:
    """The model axis resolves in the partition rules, but a mesh with
    ``model_parallel > 1`` is not ported."""
    if int(model_parallel) > 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel} (the model axis) selects a "
            "path the PyTorch port does not have yet (ROADMAP Queue 1 "
            "item 16b)")


@dataclasses.dataclass
class RankMesh:
    """This rank's view of the data axis (see the module docstring)."""

    world: int
    rank: int
    device: torch.device
    n_local: int = 1
    backend: str | None = None  # None: a world of 1, no process group
    group: Any = None  # device tensors
    cpu_group: Any = None  # host values (gloo)

    @classmethod
    def local(cls, device: str | torch.device,
              n_local: int = 1) -> "RankMesh":
        """The world-1 mesh: one process holding ``n_local`` shards."""
        return cls(world=1, rank=0, device=torch.device(device),
                   n_local=int(n_local))

    @property
    def n_shards(self) -> int:
        return self.world * self.n_local

    @property
    def local_start(self) -> int:
        """The first data-axis shard this rank owns."""
        return self.rank * self.n_local

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
        """In place: the sum over ranks divided by the world size (a 0-dim
        divisor on ``t``'s device: the IEEE quotient on every device)."""
        if self.world > 1:
            self.all_reduce(t, "sum")
            t.div_(torch.full((), float(self.world), dtype=t.dtype,
                              device=t.device))
        return t

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
        return (f"rank {self.rank}/{self.world} on {self.device}, shards "
                f"[{self.local_start}, {self.local_start + self.n_local}) "
                f"of {self.n_shards}, backend {self.backend or 'none'}")
