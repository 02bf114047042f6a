"""Replay buffer for the fused device path: ring + PER trees on the card.

Counterpart of ``d4pg_tpu/replay/fused_buffer.py``. ``add`` (any thread,
under the service's buffer lock) only
copies host rows into a preallocated column-major staging ring; every
device write happens on the learner thread, which owns the ring and the
trees. With ``ingest_shards=K > 1`` the staging is a
``staging.MultiRingStaging``: ``add_sharded`` pushes into one shard's
own ring under that ring's leaf lock alone (the replay service's shard
workers call it without the buffer lock), and the rings merge in
admission-ticket order into the frame stream the two calls below read.
A block moves in two calls:

  - ``stage_block()`` copies the next pending frame (at most
    ``block_rows`` rows) out of the staging ring into a dedicated block
    (pinned host memory when the buffer is on the card) and starts ONE
    ``non_blocking`` host-to-device copy of it on a side stream, then
    records an event after it;
  - ``commit_staged()`` makes the learner's stream wait on that event,
    then writes the block into the ring (``device_ring.block_write``)
    and, with ``prioritized=True``, inserts it into the PER trees at
    ``max_priority ** alpha``.

The dedicated block is there because ``HostStagingRing.frame()`` returns
views into a ring that ``push`` overwrites once the rows are popped: an
asynchronous copy straight from those views could land rows a later push
has already written. The in-flight depth is one block, so one pinned
block serves; before refilling it, ``stage_block`` waits for the copy
that read it (long done by then), and the side stream waits for the
commit that last read the device block. ``drain`` is stage + commit per
block until the staging ring is empty (cycle boundaries); the learner's
per-chunk schedule (``learner/pipeline.IngestOverlap``) interleaves the
two calls with the chunks so the copy rides under a chunk's compute.
The ring and trees a sequence of adds leaves are bitwise those of the
synchronous drain, whatever ``add`` does while a block is in flight.
``drain_per_row`` lands the staged rows one row per ring write and tree
insert: the oracle the block path is held to, bitwise. The unified
registry counts ``fused.rows_staged``, ``fused.rows_committed`` and
``fused.blocks_committed``.

Generation-tracked mode (``gen_tracked=True``, the device-dealt plane of
``replay/device_sampler.DeviceSampleDealer``): ``add`` pre-assigns and
returns the rows' ring slots and bumps a host int64 generation mirror;
the dealer drains every staged row inside the same buffer-lock window,
so assignment order is commit order (an ``add`` that would overflow the
staging ring raises rather than drop rows). The commit lands the rows,
their entry priority and a bump of the device int32 generation array
``gen`` together. The entry priority ``max_priority ** alpha`` is
computed on the host in float64 and cast to float32 (the host scalar
``max_priority`` is the dealer's), so the device trees hold the float32
host twin's leaf bits. ``apply_priorities`` scatters settled write-backs
into the trees (duplicate slots: the last wins, ``device_per.set_leaves``).

Checkpoints and crash recovery: ``state_dict`` drains the staging, then
copies the live rows, the live leaves of the sum tree (they hold
``priority ** alpha``) and ``max_priority`` to the host as numpy, one
device-to-host copy per field; ``load_state_dict`` writes them back into
a fresh buffer and rebuilds both trees with one ``device_per.set_leaves``
over the live slots (the leaves are written as they are, not raised to
alpha again), which gives the trees' every node the bits the running
buffer held. Generation-tracked, ``max_priority`` is the host scalar
(write-back settles raise it between commits; the device copy refreshes
only at the next commit), and a load opens a fresh generation epoch:
live slots at 1, the rest 0, host mirror and device array alike, so a
block dealt before the load carries generations that no longer match
and is fenced at its settle. ``snapshot`` and ``restore`` add the
sharded staging plane's ticket floor (``staging.MultiRingStaging``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_ring import DeviceStore
from d4pg_tpu_torch.replay.uniform import (
    TransitionBatch,
    field_layouts,
    torch_dtype,
)


class HostStagingRing:
    """Preallocated column-major host staging for fixed-size block frames.

    One buffer per transition field (``specs``: its row's ``(shape,
    dtype)``), ``n_blocks * block_rows`` rows; when producers outrun the
    drains by more than that, the oldest staged rows are dropped (they
    would be overwritten by the next drains anyway)."""

    def __init__(self, specs, block_rows: int, n_blocks: int):
        self.block_rows = int(block_rows)
        self.size = self.block_rows * max(2, int(n_blocks))
        self._arrays = [np.zeros((self.size, *shape), dtype)
                        for shape, dtype in specs]
        self._r = 0  # absolute rows consumed
        self._w = 0  # absolute rows written

    def __len__(self) -> int:
        return self._w - self._r

    def push(self, batch: TransitionBatch) -> None:
        n = np.asarray(batch.obs).shape[0]
        if n > self.size:  # keep only the newest ring-full
            batch = TransitionBatch(*[np.asarray(v)[-self.size:]
                                      for v in batch])
            n = self.size
        off = self._w % self.size
        first = min(n, self.size - off)
        for dst, src in zip(self._arrays, batch):
            src = np.asarray(src, dst.dtype)
            dst[off:off + first] = src[:first]
            dst[:n - first] = src[first:]
        self._w += n
        self._r = max(self._r, self._w - self.size)  # drop oldest

    def frame(self) -> tuple[TransitionBatch, int]:
        """The next pending rows as contiguous views (at most one block,
        capped at the ring boundary) and their count (0 when empty)."""
        off = self._r % self.size
        n = min(len(self), self.block_rows, self.size - off)
        return TransitionBatch(*[a[off:off + n] for a in self._arrays]), n

    def pop(self, n: int) -> None:
        self._r += n

    def take(self, n: int) -> list[TransitionBatch]:
        """Pop the ``n`` oldest staged rows as one or two per-field view
        batches (two when the run wraps the ring boundary). Zero-copy: the
        views hold only until the writer laps the ring."""
        n = min(n, len(self))
        if n <= 0:
            return []
        off = self._r % self.size
        first = min(n, self.size - off)
        out = [TransitionBatch(*[a[off:off + first] for a in self._arrays])]
        if first < n:
            out.append(TransitionBatch(*[a[:n - first]
                                         for a in self._arrays]))
        self._r += n
        return out


class FusedDeviceReplay:
    """Fixed-capacity device ring + (``prioritized``) device PER trees;
    ``trees`` is ``None`` for uniform replay. ``obs_dim`` is an int or an
    [H, W, C] tuple, stored as ``obs_dtype`` (``uniform.obs_layout``:
    uint8 frames by default) in the staging ring, the pinned block and
    the device ring alike."""

    def __init__(self, capacity: int, obs_dim, act_dim: int,
                 alpha: float = 0.6, prioritized: bool = True,
                 device: str | torch.device | None = None,
                 block_rows: int | None = None, staging_blocks: int = 8,
                 ingest_shards: int = 1, obs_dtype=None,
                 gen_tracked: bool = False):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.block_rows = int(block_rows if block_rows is not None
                              else min(4096, self.capacity))
        self._store = DeviceStore(self.capacity, obs_dim, act_dim,
                                  self.device, self.block_rows, obs_dtype)
        self.prioritized = bool(prioritized)
        self.trees = (dper.init(self.capacity, self.device)
                      if self.prioritized else None)
        self.size = 0
        self.head = 0
        self.gen_tracked = bool(gen_tracked)
        if self.gen_tracked:
            if not self.prioritized:
                raise ValueError("gen_tracked needs prioritized=True (it "
                                 "serves the PER dealt plane)")
            if int(ingest_shards) > 1:
                raise ValueError(
                    "gen_tracked needs ingest_shards=1: direct-staged "
                    "shard rows bypass add(), which assigns the slots")
            self.max_priority = 1.0
            self.generation = np.zeros(self.capacity, np.int64)
            self.gen = torch.zeros(self.capacity, dtype=torch.int32,
                                   device=self.device)
            self._next_slot = 0
        n_blocks = min(int(staging_blocks),
                       -(-self.capacity // self.block_rows))
        specs = field_layouts(obs_dim, act_dim, obs_dtype)
        self.ingest_shards = max(1, int(ingest_shards))
        if self.ingest_shards > 1:
            from d4pg_tpu_torch.replay.staging import MultiRingStaging

            self._staging = MultiRingStaging(specs, self.block_rows,
                                             n_blocks, self.ingest_shards)
        else:
            self._staging = HostStagingRing(specs, self.block_rows, n_blocks)
        pin = self.device.type == "cuda"
        # the one in-flight block: host side (pinned on the card) and its
        # device twin, both allocated once
        self._host_block = TransitionBatch(*[
            torch.zeros((self.block_rows, *shape), dtype=torch_dtype(dtype),
                        pin_memory=pin) for shape, dtype in specs])
        self._dev_block = (TransitionBatch(*[
            torch.zeros((self.block_rows, *shape), dtype=torch_dtype(dtype),
                        device=self.device) for shape, dtype in specs])
            if pin else self._host_block)
        self._copy_stream = torch.cuda.Stream(self.device) if pin else None
        self._copied = None  # event: the H2D copy of the block is done
        self._consumed = None  # event: the last commit has read the block
        self._inflight = 0  # rows of the staged, uncommitted block

    def add(self, batch: TransitionBatch):
        """Stage host rows (numpy arrays); no device work. Sharded, the
        rows go to shard 0's ring. Generation-tracked, returns the ring
        slots the rows will land in (see the module docstring)."""
        n = np.asarray(batch.obs).shape[0]
        if not self.gen_tracked:
            if n:
                self._staging.push(batch)
            return None
        if n == 0:
            return np.empty(0, np.int64)
        if len(self._staging) + n > self._staging.size:
            raise RuntimeError(
                "gen_tracked staging overflow: the dealer must drain every "
                f"add within its buffer-lock window (backlog "
                f"{len(self._staging)} + {n} > {self._staging.size})")
        slots = (self._next_slot + np.arange(n)) % self.capacity
        self._next_slot = int((self._next_slot + n) % self.capacity)
        self.generation[slots] += 1
        self._staging.push(batch)
        return slots

    def add_sharded(self, batch: TransitionBatch, shard: int,
                    ticket: int | None = None) -> None:
        """Stage host rows into shard ``shard``'s own ring: safe without
        the service's buffer lock, since each ring has one pushing worker
        and its own leaf lock against the learner's merge. ``ticket``
        orders the merge and must ascend per shard (the admission ticket
        does)."""
        if not np.asarray(batch.obs).shape[0]:
            return
        if self.ingest_shards > 1:
            self._staging.push(batch, shard=shard, ticket=ticket)
        else:
            self._staging.push(batch)

    def __len__(self) -> int:
        # staged and in-flight rows count toward warm-up: they land before
        # the next chunk
        return min(self.size + len(self._staging) + self._inflight,
                   self.capacity)

    @property
    def storage(self) -> TransitionBatch:
        return self._store.arrays

    # Every caller of the mutating learner-side entry points below
    # reaches them through ReplayService.ingest_stage/ingest_commit/
    # drain_device/load_replay_state, i.e. under the service's buffer
    # lock; the guarded-by annotations declare that caller contract to
    # the unguarded-shared-write lock-graph rule.
    def stage_block(self) -> int:  # jaxlint: guarded-by=_buffer_lock
        """Copy the next pending frame into the dedicated block and start
        its host-to-device copy (see the module docstring). No-op while a
        block is in flight (the depth is one). Returns rows staged."""
        if self._inflight:
            return 0
        frame, n = self._staging.frame()
        if n == 0:
            return 0
        if self._copied is not None:
            self._copied.synchronize()  # the pinned block is free again
        for dst, src in zip(self._host_block, frame):
            dst[:n].numpy()[...] = src
        self._staging.pop(n)
        if self._copy_stream is not None:
            if self._consumed is not None:
                self._copy_stream.wait_event(self._consumed)
            with torch.cuda.stream(self._copy_stream):
                for dst, src in zip(self._dev_block, self._host_block):
                    dst[:n].copy_(src[:n], non_blocking=True)
                self._copied = torch.cuda.Event()
                self._copied.record(self._copy_stream)
        self._inflight = n
        REGISTRY.counter("fused.rows_staged").inc(n)
        return n

    def commit_staged(self) -> int:  # jaxlint: guarded-by=_buffer_lock
        """Land the staged block: ring write, then (PER) tree insert, on
        the learner's stream after the block's copy. Learner thread only.
        Returns rows committed."""
        n = self._inflight
        if not n:
            return 0
        if self._copied is not None:
            torch.cuda.current_stream(self.device).wait_event(self._copied)
        self._store.write_block(self.head, self._dev_block, n)
        if self.gen_tracked:
            idx = (self.head + torch.arange(n, device=self.device)
                   ) % self.capacity
            # host float64 pow, float32 cast: the trees see host-rounded
            # values only
            p_ins = float(np.float32(self.max_priority ** self.alpha))
            trees = dper.set_leaves(self.trees, idx, torch.full(
                (n,), p_ins, dtype=torch.float32, device=self.device))
            self.trees = trees._replace(max_priority=torch.full(
                (), self.max_priority, dtype=torch.float32,
                device=self.device))
            self.gen[idx] += 1  # a block's slots are distinct
        elif self.prioritized:
            idx = (self.head + torch.arange(n, device=self.device)
                   ) % self.capacity
            self.trees = dper.insert(self.trees, idx, self.alpha)
        if self._copy_stream is not None:
            self._consumed = torch.cuda.Event()
            self._consumed.record(torch.cuda.current_stream(self.device))
        self.head = (self.head + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        self._inflight = 0
        REGISTRY.counter("fused.rows_committed").inc(n)
        REGISTRY.counter("fused.blocks_committed").inc()
        return n

    # priority write-back for the dealt plane: reached from the device
    # dealer's settle inside the commit thread's buffer-lock window
    def apply_priorities(self, idx: torch.Tensor,  # jaxlint: guarded-by=_buffer_lock
                         p_alpha: torch.Tensor) -> None:
        """Scatter settled write-back priorities (already ``** alpha``,
        float32, on the device) into the trees; duplicate slots keep the
        last value. The commit thread is the one caller."""
        self.trees = dper.set_leaves(self.trees, idx, p_alpha)

    def drain(self) -> int:
        """Move every staged row to the device, one block per stage and
        commit (the in-flight block first). Returns the rows committed."""
        total = self.commit_staged()
        while self.stage_block():
            total += self.commit_staged()
        return total

    def state_dict(self) -> dict:
        """The ring and trees as host numpy (see the module docstring).
        Learner thread (or under the service's buffer lock)."""
        from d4pg_tpu_torch.replay.uniform import pack_rows

        self.drain()
        # a copy even on the CPU, where .cpu() would alias the ring
        rows = TransitionBatch(*[
            arr[:self.size].to("cpu", copy=True).numpy()
            for arr in self.storage])
        d = pack_rows(rows, self.head, self.size, self.capacity)
        if self.trees is not None:
            cap = self.trees.capacity
            d["leaf_priorities"] = self.trees.sum_tree[
                cap:cap + self.size].to("cpu", copy=True).numpy()
            d["max_priority"] = (float(self.max_priority) if self.gen_tracked
                                 else float(self.trees.max_priority))
        return d

    # restore mutates ring and tree state: reached through ReplayService.
    # load_replay_state under the buffer lock, like the paths above
    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:  # jaxlint: guarded-by=_buffer_lock
        """Load a ``state_dict`` into this buffer (same capacity): rows,
        head and size, both trees rebuilt over the live slots, and
        generation-tracked, a fresh generation epoch."""
        from d4pg_tpu_torch.replay.uniform import unpack_rows

        batch, head, size = unpack_rows(d, self.capacity)
        if batch is not None:
            with warnings.catch_warnings():
                # rows unpickled from a sidecar view its read-only bytes;
                # copy_ only reads them
                warnings.filterwarnings("ignore", "The given NumPy array is "
                                        "not writable")
                for arr, v in zip(self.storage, batch):
                    arr[:size].copy_(torch.from_numpy(
                        np.ascontiguousarray(v)))
        self.size = size
        self.head = head
        if self.trees is not None:
            trees = dper.init(self.capacity, self.device)
            if size:
                trees = dper.set_leaves(
                    trees, torch.arange(size, device=self.device),
                    torch.as_tensor(np.asarray(d["leaf_priorities"],
                                               np.float32),
                                    device=self.device))
            self.trees = trees._replace(max_priority=torch.full(
                (), float(d.get("max_priority", 1.0)), dtype=torch.float32,
                device=self.device))
        if self.gen_tracked:
            self.max_priority = float(d.get("max_priority", 1.0))
            self._next_slot = self.head
            self.generation = np.zeros(self.capacity, np.int64)
            self.generation[:self.size] = 1
            self.gen = torch.as_tensor(self.generation.astype(np.int32),
                                       device=self.device)

    def snapshot(self) -> dict:
        """``state_dict`` plus the sharded staging plane's ticket floor:
        the drain inside ``state_dict`` lands every staged row, so the cut
        holds no row in flight."""
        d = self.state_dict()
        stg = getattr(self._staging, "snapshot", None)
        if stg is not None:
            d["staging"] = stg()
        return d

    def restore(self, d: dict) -> None:
        """Load a ``snapshot`` into this (fresh) buffer, the staging
        plane's ticket floor included."""
        self.load_state_dict(d)
        stg = getattr(self._staging, "restore", None)
        if stg is not None and "staging" in d:
            stg(d["staging"])

    def drain_per_row(self) -> int:
        """Land every staged row one at a time: a ring write and a tree
        insert per row (an in-flight block lands first, as a block). The
        oracle the block path is held to; no loop runs it."""
        total = self.commit_staged()
        while True:
            frame, n = self._staging.frame()
            if n == 0:
                break
            rows = [np.array(v[:n]) for v in frame]
            self._staging.pop(n)
            for i in range(n):
                idx = np.array([self.head], np.int64)
                self._store.write(idx, TransitionBatch(
                    *[v[i:i + 1] for v in rows]))
                if self.prioritized:
                    self.trees = dper.insert(
                        self.trees, torch.as_tensor(idx, device=self.device),
                        self.alpha)
                self.head = (self.head + 1) % self.capacity
                self.size = min(self.size + 1, self.capacity)
            total += n
        return total
