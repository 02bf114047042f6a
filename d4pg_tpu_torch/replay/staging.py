"""Host-to-device staging: pinned blocks used in turns, and the
double-buffered chunk stager.

Counterpart of ``DeviceStager`` in ``d4pg_tpu/replay/staging.py``. While
the card runs chunk t, the host samples chunk t + 1 and starts its copy,
so the copy rides under chunk t's compute.

A copy without blocking the host (``non_blocking=True``) needs pinned
host memory, and the pinned block must not be written again while its
copy is in flight. ``PinnedBlocks`` keeps two pinned blocks per field
and alternates them; each block carries the CUDA event recorded after
the copy that last read it, and the host waits on that event (counted in
``waits``; it is normally long done) before it fills the block again.

``DeviceStager`` stages a sample's numpy leaves through a
``PinnedBlocks`` into two device blocks, also used in turns, on a side
stream: before writing a device block the side stream waits for the
work already queued on the learner's stream (which holds the last reader
of that block, the chunk staged two samples earlier), and ``next`` makes
the learner's stream wait on the copy before it hands the batch over.
Leaves that are tensors already (rows a device ring gathered) pass
through. On the CPU the numpy leaves become tensors without a copy.

``MultiRingStaging`` is the host half of the sharded ingest plane: K
private column-major staging rings (one per ingest shard, so K workers
copy rows at once) whose rows merge back, in admission-ticket order, into
the one frame stream ``FusedDeviceReplay.stage_block`` reads.

``DealtBlockRing`` is a bounded queue of dealt blocks from the
sample-on-ingest dealer (``replay/sampler.py``) to one learner replica.
Its blocks may hold tensors on the card: the ring holds their only
references, so dropping a block returns its memory to torch's caching
allocator (stream-ordered, so a kernel still queued on it is safe).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.core.locking import TieredCondition, TieredLock
from d4pg_tpu_torch.obs.registry import REGISTRY
from d4pg_tpu_torch.replay.uniform import torch_dtype


class MultiRingStaging:
    """K per-shard host staging rings and a ticket-ordered merge ring.

    The consumer side is ``HostStagingRing``'s (``frame``, ``pop``,
    ``take``, ``__len__``), so ``FusedDeviceReplay.stage_block``,
    ``commit_staged`` and ``drain_per_row`` read the merged stream
    unchanged: ``stage_block`` still copies each frame into its own
    pinned block before the copy to the card.

    Ownership: shard ``i``'s worker is the only pusher of ring ``i``; the
    ring and its ``(ticket, rows)`` records are guarded by one leaf lock
    (the ``ring`` tier, the lowest), held only for the slice copy and
    never while taking a service or buffer lock. Every pushed batch
    carries its admission ticket (ascending per ring). ``frame`` refills
    the merge ring from the record with the smallest ticket among the
    ring heads, so at quiescence the rows reach the card in admission
    order, the order of one ring; rows a straggling shard has not pushed
    yet can be overtaken, and the merge never waits for a slow shard.
    When a ring overflows and drops its oldest rows, the same rows are
    trimmed off its oldest records, so tickets stay aligned with rows.
    """

    def __init__(self, specs, block_rows: int, n_blocks: int,
                 shards: int):
        from d4pg_tpu_torch.replay.fused_buffer import HostStagingRing

        self.shards = max(1, int(shards))
        self.block_rows = int(block_rows)
        self._rings = [HostStagingRing(specs, block_rows, n_blocks)
                       for _ in range(self.shards)]
        self._ring_locks = [TieredLock("ring") for _ in range(self.shards)]
        self._records: list[deque] = [deque() for _ in range(self.shards)]
        self._merge = HostStagingRing(specs, block_rows, 2)
        self._ticket = itertools.count()

    def __len__(self) -> int:
        n = len(self._merge)
        for i in range(self.shards):
            with self._ring_locks[i]:
                n += len(self._rings[i])
        return n

    # -- producer side (one worker per shard) ------------------------------
    def push(self, batch, shard: int = 0, ticket: int | None = None) -> None:
        i = shard % self.shards
        ring, records = self._rings[i], self._records[i]
        REGISTRY.counter("staging.rows_pushed").inc(
            int(np.asarray(batch.obs).shape[0]))
        with self._ring_locks[i]:
            t = next(self._ticket) if ticket is None else ticket
            n = min(int(np.asarray(batch.obs).shape[0]), ring.size)
            overflow = max(0, len(ring) + n - ring.size)
            ring.push(batch)
            # the ring dropped its oldest rows for these: trim the same
            # rows off the oldest records
            while overflow and records:
                t0, n0 = records[0]
                if n0 <= overflow:
                    records.popleft()
                    overflow -= n0
                else:
                    records[0] = (t0, n0 - overflow)
                    overflow = 0
            records.append((t, n))

    # -- consumer side (learner thread) ------------------------------------
    def _refill(self) -> None:
        """Move rows into the merge ring, smallest head ticket first,
        until it holds a block or the shard rings run dry."""
        while len(self._merge) < self.block_rows:
            best = None
            for i in range(self.shards):
                with self._ring_locks[i]:
                    if self._records[i]:
                        t = self._records[i][0][0]
                        if best is None or t < best[0]:
                            best = (t, i)
            if best is None:
                return
            ticket, i = best
            with self._ring_locks[i]:
                if not self._records[i] or self._records[i][0][0] != ticket:
                    continue  # a push overflowed the head away; look again
                _, n = self._records[i].popleft()
                room = self._merge.size - len(self._merge)
                if n > room:
                    # only part of the record fits: the rest keeps its
                    # ticket at the head
                    self._records[i].appendleft((ticket, n - room))
                    n = room
                for piece in self._rings[i].take(n):
                    self._merge.push(piece)

    def snapshot(self) -> dict:
        """The ticket floor and the rows still staged at a (drained) cut;
        taking one ticket to learn the floor is harmless, tickets need
        only ascend per ring."""
        floor = next(self._ticket)
        return {"ticket_floor": int(floor), "staged_rows": len(self)}

    def restore(self, d: dict) -> None:
        """Seat the ticket counter above a snapshot's floor, so every push
        after it merges after every ticket before it. Ring contents are
        not restored: a consistent cut has none."""
        self._ticket = itertools.count(int(d.get("ticket_floor", 0)) + 1)

    def frame(self):
        self._refill()
        return self._merge.frame()

    def pop(self, n: int) -> None:
        self._merge.pop(n)

    def take(self, n: int):
        self._refill()
        return self._merge.take(n)


class PinnedBlocks:
    """Two pinned host blocks (one flat buffer per array) used in turns;
    see the module docstring."""

    def __init__(self):
        self._bufs: list[list[torch.Tensor] | None] = [None, None]
        self._events: list[torch.cuda.Event | None] = [None, None]
        self._turn = 0
        self.waits = 0  # fills that found their block's copy in flight

    def fill(self, arrays: list[np.ndarray]) -> tuple[int, list[torch.Tensor]]:
        """Copy ``arrays`` into the next block; returns ``(slot, pinned
        views shaped like the arrays)``. The caller starts the copies that
        read the views, then calls :meth:`release`."""
        slot = self._turn
        self._turn = (slot + 1) % len(self._bufs)
        event = self._events[slot]
        if event is not None and not event.query():
            self.waits += 1
            event.synchronize()
        bufs = self._bufs[slot]
        if bufs is None or len(bufs) != len(arrays) or any(
                b.dtype != torch_dtype(a.dtype) or b.numel() < a.size
                for b, a in zip(bufs, arrays)):
            bufs = self._bufs[slot] = [
                torch.empty(max(a.size, 1), dtype=torch_dtype(a.dtype),
                            pin_memory=True) for a in arrays]
        views = []
        for buf, a in zip(bufs, arrays):
            view = buf[:a.size].view(a.shape)
            view.numpy()[...] = a
            views.append(view)
        return slot, views

    def release(self, slot: int, stream: torch.cuda.Stream) -> None:
        """Record, on ``stream``, the event after the copies that read
        ``slot``'s views."""
        event = torch.cuda.Event()
        event.record(stream)
        self._events[slot] = event


def _flatten(payload):
    """(leaves, rebuild) over nested tuples (NamedTuples included);
    ``None`` leaves stay ``None``."""
    if isinstance(payload, tuple):
        parts = [_flatten(p) for p in payload]
        sizes = [len(leaves) for leaves, _ in parts]

        def rebuild(leaves):
            out, i = [], 0
            for (_, sub), n in zip(parts, sizes):
                out.append(sub(leaves[i:i + n]))
                i += n
            return (type(payload)(*out) if hasattr(payload, "_fields")
                    else tuple(out))

        return [leaf for leaves, _ in parts for leaf in leaves], rebuild
    return [payload], lambda leaves: leaves[0]


class DeviceStager:
    """Double-buffered prefetch of host samples onto ``device`` (default
    ``cuda``). ``sample_fn`` returns ``(payload, aux)``: the payload is
    staged, the aux (PER slots and generations) rides along on the host.
    A staged payload stays valid until the second ``next`` after the one
    that returned it."""

    def __init__(self, sample_fn: Callable[[], tuple],
                 device: str | torch.device | None = None):
        self._sample = sample_fn
        self.device = resolve_device(device)
        self._inflight = None
        card = self.device.type == "cuda"
        self._pinned = PinnedBlocks() if card else None
        self._stream = torch.cuda.Stream(self.device) if card else None
        self._dev_blocks: list[list[torch.Tensor] | None] = [None, None]
        self.h2d_bytes = 0  # bytes copied host-to-device

    @property
    def waits(self) -> int:
        """Fills that waited for a pinned block's copy."""
        return 0 if self._pinned is None else self._pinned.waits

    def _put(self):
        payload, aux = self._sample()
        leaves, rebuild = _flatten(payload)
        host = [i for i, leaf in enumerate(leaves)
                if isinstance(leaf, np.ndarray)]
        ready = None
        if self._pinned is None:
            for i in host:
                leaves[i] = torch.from_numpy(np.ascontiguousarray(leaves[i]))
        elif host:
            arrays = [np.ascontiguousarray(leaves[i]) for i in host]
            main = torch.cuda.current_stream(self.device)
            slot, pinned = self._pinned.fill(arrays)
            blocks = self._dev_blocks[slot]
            if blocks is None or [b.shape for b in blocks] != [
                    p.shape for p in pinned] or [b.dtype for b in blocks] != [
                    p.dtype for p in pinned]:
                blocks = self._dev_blocks[slot] = [
                    torch.empty(p.shape, dtype=p.dtype, device=self.device)
                    for p in pinned]
            # the block's last reader is queued on the learner's stream
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                for dst, src in zip(blocks, pinned):
                    dst.copy_(src, non_blocking=True)
            self._pinned.release(slot, self._stream)
            ready = torch.cuda.Event()
            ready.record(self._stream)
            for i, dst in zip(host, blocks):
                leaves[i] = dst
            self.h2d_bytes += sum(a.nbytes for a in arrays)
        return rebuild(leaves), aux, ready

    def next(self, prefetch: bool = True):
        """``(payload, aux)`` of the prefetched sample, and (unless
        ``prefetch=False``) the start of the following one's staging. Pass
        ``prefetch=False`` for the last sample before an
        ``invalidate()``."""
        out = self._inflight if self._inflight is not None else self._put()
        self._inflight = self._put() if prefetch else None
        payload, aux, ready = out
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        return payload, aux

    def invalidate(self) -> None:
        """Drop the in-flight sample; the next ``next()`` samples fresh."""
        self._inflight = None


class DealtBlockRing:
    """Bounded ring of ready-to-train dealt blocks for one learner replica.

    One producer (the commit thread's dealer, which reserves room with
    ``room()`` under its ``sampler`` lock and pushes after releasing it,
    so a reserved push fails only on a closed ring) and one consumer (the
    replica). All queue state is under one ``ring``-tier condition, the
    bottom tier, so the replica's blocking ``pop`` holds nothing above it
    and never the buffer lock.

    ``on_room`` (set by ``ReplayService.attach_dealer``) is called after
    a pop or a clear frees room, with the ring condition released, so it
    may take the commit condition at top level: it wakes the commit loop
    for a top-up deal, or a consumer faster than the commit cadence would
    starve on an empty ring."""

    def __init__(self, capacity: int = 4):
        self.capacity = max(1, int(capacity))
        self._cond = TieredCondition("ring")
        self._q: deque = deque()
        self._closed = False
        self.on_room: Callable[[], None] | None = None

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def room(self) -> int:
        with self._cond:
            return 0 if self._closed else max(0, self.capacity - len(self._q))

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def offer(self, block) -> bool:
        """Producer push; False when closed or full."""
        with self._cond:
            if self._closed or len(self._q) >= self.capacity:
                return False
            self._q.append(block)
            self._cond.notify_all()
            return True

    def pop(self, timeout: float | None = None):
        """The next block, waiting up to ``timeout`` seconds (forever when
        None); None on timeout or close."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._q:
                if self._closed:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
            block = self._q.popleft()
            self._cond.notify_all()
        kick = self.on_room
        if kick is not None:
            kick()
        return block

    def clear(self) -> int:
        """Drop every queued block (a respawned consumer must not train on
        blocks dealt to its predecessor); returns how many."""
        with self._cond:
            n = len(self._q)
            self._q.clear()
            self._cond.notify_all()
        kick = self.on_room
        if n and kick is not None:
            kick()
        return n

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

