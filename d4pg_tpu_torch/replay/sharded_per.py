"""Sharded device replay: ring + PER trees split over the ``data`` axis.

Counterpart of ``d4pg_tpu/replay/sharded_per.py``. Each data-axis shard
owns a slice of the transition ring and its own PER sum/min tree pair; a
rank holds the ``n_local`` shards it owns (``parallel/mesh.RankMesh``) on
its device as ``[n_local, cap_shard, ...]`` tensors, ``cap_shard =
next_pow2(ceil(capacity / n_shards))``. The sharded fused chunk
(``learner/fused.make_sharded_fused_chunk``) samples ``B / n_shards``
rows from each shard's tree and writes each shard's TD errors back into
its own tree: batch rows never cross ranks, only gradients and one
minimum per step do (the Ape-X sharded-replay layout).

Host bookkeeping mirrors the reference's: ``add`` stages host rows
(bounded at the local capacity, oldest dropped), ``drain`` flushes them
at chunk boundaries on the learner thread, round-robin over the local
shards (``_rr``), keeping the newest rows when the backlog overflows.
A rank inserts only its own rows, so no rank waits for another and no
pad width is agreed: the reference's allgather of a pad width exists to
make its insert one SPMD program, which the port's insert is not.
Checkpoints hold this rank's shard-set (``state_dict``), and a restore
refuses a flat checkpoint, another data-parallel degree and another
shard range.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.segment_tree import next_pow2
from d4pg_tpu_torch.replay.uniform import (
    TransitionBatch,
    field_layouts,
    pack_rows,
    torch_dtype,
    validate_rows,
)


class ShardedPerTrees(NamedTuple):
    """The local shards' tree pairs, leading axis = local shard."""

    sum_tree: torch.Tensor  # [n_local, 2 * cap_shard] float32
    min_tree: torch.Tensor  # [n_local, 2 * cap_shard] float32
    max_priority: torch.Tensor  # [n_local] per-shard running max

    @property
    def cap_shard(self) -> int:
        return self.sum_tree.shape[1] // 2

    def shard(self, s: int) -> dper.PerTrees:
        """Local shard ``s``'s trees as views (writes land in these)."""
        return dper.PerTrees(self.sum_tree[s], self.min_tree[s],
                             self.max_priority[s])

    def set_shard(self, s: int, t: dper.PerTrees) -> None:
        """Copy shard ``s``'s new trees in place."""
        self.sum_tree[s].copy_(t.sum_tree)
        self.min_tree[s].copy_(t.min_tree)
        self.max_priority[s].copy_(t.max_priority)

    def clone(self) -> "ShardedPerTrees":
        return ShardedPerTrees(*[t.clone() for t in self])


class ShardedFusedReplay:
    """This rank's shards of the data-sharded ring and trees."""

    def __init__(self, capacity: int, obs_dim, act_dim: int, mesh,
                 alpha: float = 0.6, prioritized: bool = True,
                 obs_dtype=None):
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.n_shards
        self.n_local = mesh.n_local
        self.local_start = mesh.local_start
        self.cap_shard = next_pow2(
            max(1, int(np.ceil(capacity / self.n_shards))))
        self.capacity = self.cap_shard * self.n_shards
        self.prioritized = bool(prioritized)
        self.alpha = float(alpha)
        n, c = self.n_local, self.cap_shard
        self.storage = TransitionBatch(*[
            torch.zeros((n, c, *shape), dtype=torch_dtype(dtype),
                        device=self.device)
            for shape, dtype in field_layouts(obs_dim, act_dim, obs_dtype)])
        self.trees = (ShardedPerTrees(
            sum_tree=torch.zeros((n, 2 * c), dtype=torch.float32,
                                 device=self.device),
            min_tree=torch.full((n, 2 * c), float("inf"),
                                dtype=torch.float32, device=self.device),
            max_priority=torch.ones((n,), dtype=torch.float32,
                                    device=self.device))
            if self.prioritized else None)
        # ring cursors and live sizes of the local shards (host ints)
        self._head = np.zeros(n, np.int64)
        self._size = np.zeros(n, np.int64)
        # the local shard that receives the next staged row
        self._rr = 0
        self._staged: list[TransitionBatch] = []
        self._staged_rows = 0

    @property
    def local_capacity(self) -> int:
        """Rows this rank's shard-set holds (the capacity on a world of
        one rank)."""
        return self.cap_shard * self.n_local

    # -- ingest side (under the service's buffer lock) ---------------------
    def add(self, batch: TransitionBatch) -> None:
        """Stage host rows; bounded at the local capacity (oldest staged
        dropped: the next drain would overwrite them anyway)."""
        nrows = np.asarray(batch.obs).shape[0]
        if nrows == 0:
            return
        if nrows > self.local_capacity:
            raise ValueError(
                f"batch of {nrows} exceeds capacity {self.local_capacity}")
        self._staged.append(TransitionBatch(*[np.asarray(v) for v in batch]))
        self._staged_rows += nrows
        while (self._staged_rows - self._staged[0].obs.shape[0]
               >= self.local_capacity):
            self._staged_rows -= self._staged.pop(0).obs.shape[0]

    def __len__(self) -> int:
        """This rank's rows, live and staged (its warm-up gate)."""
        return int(min(self._size.sum() + self._staged_rows,
                       self.local_capacity))

    @property
    def size(self) -> np.ndarray:
        """Live rows of each local shard [n_local] (the chunk's ``size``)."""
        return self._size.copy()

    # -- learner side ------------------------------------------------------
    def drain(self) -> int:
        """Flush the staged rows round-robin over the local shards; each
        shard writes its rows at its ring cursor and enters them in its
        trees at ``max_priority ** alpha``. Learner thread only."""
        if not self._staged:
            return 0
        batch = (self._staged[0] if len(self._staged) == 1 else
                 TransitionBatch(*[
                     np.concatenate([b[f] for b in self._staged])
                     for f in range(len(TransitionBatch._fields))]))
        self._staged.clear()
        self._staged_rows = 0
        nrows = batch.obs.shape[0]
        if nrows > self.local_capacity:
            # keep the newest rows that fit: more than cap_shard rows on a
            # shard would be duplicate slots in one write
            batch = TransitionBatch(*[v[-self.local_capacity:]
                                      for v in batch])
            nrows = self.local_capacity
        n, cap = self.n_local, self.cap_shard
        shard_of = (self._rr + np.arange(nrows)) % n
        self._rr = int((self._rr + nrows) % n)
        for s in range(n):
            take = np.flatnonzero(shard_of == s)
            if not len(take):
                continue
            slots = (self._head[s] + np.arange(len(take))) % cap
            idx = torch.from_numpy(slots).to(self.device)
            for arr, v in zip(self.storage, batch):
                arr[s, idx] = torch.from_numpy(
                    np.ascontiguousarray(v[take])).to(self.device)
            if self.trees is not None:
                self.trees.set_shard(s, dper.insert(self.trees.shard(s), idx,
                                                    self.alpha))
            self._head[s] = int((self._head[s] + len(take)) % cap)
            self._size[s] = int(min(self._size[s] + len(take), cap))
        return nrows

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        """This rank's shard-set as host numpy (after a drain)."""
        self.drain()
        d = pack_rows(self.storage, 0, 0, self.capacity)
        d["sharded"] = {
            "head": self._head.copy(),
            "size": self._size.copy(),
            "rr": self._rr,
            "n_shards": self.n_shards,
            "n_local": self.n_local,
            "local_start": self.local_start,
        }
        if self.trees is not None:
            d["sharded"]["leaf_priorities"] = (
                self.trees.sum_tree[:, self.cap_shard:].cpu().numpy())
            d["sharded"]["max_priority"] = (
                self.trees.max_priority.cpu().numpy())
        return d

    def load_state_dict(self, d: dict) -> None:
        """Restore this rank's shard-set; the trees are rebuilt level by
        level from the live leaves."""
        s = d.get("sharded")
        if s is None:
            raise ValueError(
                "replay checkpoint was saved by a non-sharded buffer; "
                "resume with the same replay layout (data_parallel=1 or "
                "host storage)")
        if int(s["n_shards"]) != self.n_shards:
            raise ValueError(
                "sharded replay checkpoint requires the same data-parallel "
                f"degree (got {s['n_shards']}, have {self.n_shards})")
        n_local, start = int(s["n_local"]), int(s["local_start"])
        if n_local != self.n_local or start != self.local_start:
            raise ValueError(
                f"replay snapshot covers shards [{start}, {start + n_local})"
                f" but this rank owns [{self.local_start}, "
                f"{self.local_start + self.n_local}); resume with the same "
                "rank topology")
        validate_rows({k: v for k, v in d.items() if k != "sharded"},
                      self.capacity)
        for arr, f in zip(self.storage, TransitionBatch._fields):
            arr.copy_(torch.from_numpy(np.array(d["rows"][f])))
        self._head = np.asarray(s["head"]).astype(np.int64).copy()
        self._size = np.asarray(s["size"]).astype(np.int64).copy()
        self._rr = int(s["rr"])
        self._staged.clear()
        self._staged_rows = 0
        if self.trees is None:
            return
        n, c = self.n_local, self.cap_shard
        leaves = np.asarray(s["leaf_priorities"], np.float32)
        sum_tree = np.zeros((n, 2 * c), np.float32)
        min_tree = np.full((n, 2 * c), np.inf, np.float32)
        for sh in range(n):
            sz = int(self._size[sh])
            sum_tree[sh, c:c + sz] = leaves[sh, :sz]
            min_tree[sh, c:c + sz] = leaves[sh, :sz]
        lo = c
        while lo > 1:  # internal nodes, one level at a time
            lo //= 2
            sum_tree[:, lo:2 * lo] = sum_tree[:, 2 * lo:4 * lo].reshape(
                n, -1, 2).sum(-1)
            min_tree[:, lo:2 * lo] = min_tree[:, 2 * lo:4 * lo].reshape(
                n, -1, 2).min(-1)
        for dst, src in zip(self.trees, (
                sum_tree, min_tree,
                np.asarray(s["max_priority"], np.float32))):
            dst.copy_(torch.from_numpy(src))
