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

``MultiRingStaging`` and ``DealtBlockRing`` of the reference wait for
ROADMAP Queue 1 items 12 and 14.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device


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
                b.dtype != _torch_dtype(a) or b.numel() < a.size
                for b, a in zip(bufs, arrays)):
            bufs = self._bufs[slot] = [
                torch.empty(max(a.size, 1), dtype=_torch_dtype(a),
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


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(a[:0]).dtype


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
