"""The learner's two pipelines: ingest against the fused chunk, and the
host-sampled K-chunk pipeline.

Counterpart of ``d4pg_tpu/learner/pipeline.py`` (``IngestOverlap``,
``IngestDispatchError``, ``ChunkPipeline``).

**IngestOverlap** (the fused path). The fused path's only host job is
moving staged actor rows into the device ring between chunks
(``replay/fused_buffer.py``); this schedule overlaps the copy with the
chunk:

    ingest.commit()        # block t's ring write + tree insert
    queue fused chunk t
    ingest.stage()         # block t+1's host-to-device copy, riding
                           # under chunk t's compute

so at most one explicit host-to-device copy per chunk in steady state; a
deeper backlog drains at cycle boundaries (``flush``).

Single consumer, enforced: the handoff mutates the service's one staged
block, and two dispatchers would interleave ring writes. Construction
claims the service's ingest-dispatch slot (weakly held: a dropped
overlap releases it, a successor calls ``release()``), and every call
holds a non-blocking busy token, so a concurrent commit/stage/flush
raises ``IngestDispatchError`` instead of corrupting replay.

**ChunkPipeline** (the host-sampled path, ``--fused_replay off``). One
chunk t:

  1. take chunk t, sampled and staged while chunk t - 1 ran, and start
     staging chunk t + 1 (``replay/staging.DeviceStager``);
  2. queue the K-step update of chunk t (``multi_update_step``);
  3. start the copy of chunk t's td errors into pinned host memory
     (``non_blocking``) and record an event after it;
  4. once more than ``depth`` chunks are in flight, write back the oldest
     one's priorities ``|td| + 1e-6``, waiting on its event only (no
     device-wide synchronize, no ``.item()``).

PER priorities therefore land at most ``(depth + 1) * K`` grad steps
late (bounded lag, as in Ape-X). After each chunk is queued the trace
recorder's ``mark_grad`` stamps the traces committed before it, as
``FusedLoop`` does.
"""

from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager
from typing import Any, Callable, Optional

import numpy as np
import torch

from d4pg_tpu_torch.obs.trace import RECORDER as trace_recorder
from d4pg_tpu_torch.replay.staging import DeviceStager


class IngestDispatchError(RuntimeError):
    """A second consumer raced the service's single ingest-dispatch slot
    (two live ``IngestOverlap`` owners, or concurrent calls on one)."""


class IngestOverlap:
    def __init__(self, service):
        owner_ref = getattr(service, "_ingest_overlap_owner", None)
        owner = owner_ref() if owner_ref is not None else None
        if owner is not None:
            raise IngestDispatchError(
                "ReplayService already has a live IngestOverlap consumer "
                f"({owner!r}); the fused ingest handoff is single-consumer "
                "— release() the current owner first")
        service._ingest_overlap_owner = weakref.ref(self)
        self._service = service
        # held across each dispatch; contention IS the defect, so the
        # loser raises instead of waiting
        self._busy = threading.Lock()
        self.rows_committed = 0
        self.rows_staged = 0
        self.blocks = 0

    @contextmanager
    def _dispatch(self, op: str):
        if not self._busy.acquire(blocking=False):
            raise IngestDispatchError(
                f"concurrent IngestOverlap.{op}() while another dispatch "
                "is in flight — the double-buffer handoff is "
                "single-consumer")
        try:
            owner_ref = getattr(self._service, "_ingest_overlap_owner", None)
            if owner_ref is None or owner_ref() is not self:
                raise IngestDispatchError(
                    f"IngestOverlap.{op}() after ownership moved to another "
                    "consumer (release()d, or a successor claimed the slot)")
            yield
        finally:
            self._busy.release()

    def commit(self) -> int:
        with self._dispatch("commit"):
            n = self._service.ingest_commit()
            self.rows_committed += n
            self.blocks += 1 if n else 0
            return n

    def stage(self) -> int:
        with self._dispatch("stage"):
            n = self._service.ingest_stage()
            self.rows_staged += n
            return n

    def flush(self) -> int:
        """Synchronous full drain (cycle boundary): every staged row lands
        before the next sample."""
        with self._dispatch("flush"):
            n = self._service.drain_device()
            self.rows_committed += n
            return n

    def release(self) -> None:
        """Give up the service's ingest-dispatch slot (idempotent)."""
        owner_ref = getattr(self._service, "_ingest_overlap_owner", None)
        if owner_ref is not None and owner_ref() is self:
            self._service._ingest_overlap_owner = None


class ChunkPipeline:
    """Drives ``update_fn(state, batches[, weights]) -> (state, metrics)``
    over prefetched chunks (see the module docstring).

    ``sample_fn() -> ((batches, weights), aux)``: the host sample of one
    [K, B, ...] chunk (numpy rows, or rows a device ring gathered);
    ``weights`` and ``aux`` are None for uniform replay.
    ``write_back(aux, priorities)``: the PER update, priorities [K, B]
    float32. ``device``: where the chunks go (default ``cuda``)."""

    def __init__(
        self,
        update_fn: Callable,
        sample_fn: Callable[[], tuple],
        write_back: Optional[Callable[[Any, np.ndarray], None]] = None,
        device: str | torch.device | None = None,
        use_weights: bool = True,
        depth: int = 2,
    ):
        self._update = update_fn
        self._write_back = write_back
        self._use_weights = use_weights
        self._stager = DeviceStager(sample_fn, device=device)
        self._depth = max(1, int(depth))
        self.waits = 0  # write-backs whose td copy was still in flight

    @property
    def stager(self) -> DeviceStager:
        return self._stager

    def invalidate(self) -> None:
        """Drop the staged chunk (sync-mode cycle boundary: train only on
        samples taken after the collect)."""
        self._stager.invalidate()

    def run(self, state, n_chunks: int, on_chunk: Optional[Callable] = None,
            final_prefetch: bool = True):
        """Run ``n_chunks`` chunks; returns ``(state, metrics of the last
        chunk, stacked [K])``. ``on_chunk(state)`` fires after each chunk
        is queued. Pass ``final_prefetch=False`` when the caller will
        ``invalidate()`` before the next run."""
        metrics = None
        pending: list = []
        for i in range(n_chunks):
            prefetch = final_prefetch or (i + 1 < n_chunks)
            (batches, w), aux = self._stager.next(prefetch=prefetch)
            if self._use_weights:
                state, metrics = self._update(state, batches, w)
            else:
                state, metrics = self._update(state, batches)
            td = metrics.get("td_error") if self._write_back else None
            pending.append((aux, _start_fetch(td)))
            trace_recorder.mark_grad()
            while len(pending) > self._depth:
                self._flush(pending.pop(0))
            if on_chunk is not None:
                on_chunk(state)
        for p in pending:
            self._flush(p)
        return state, metrics

    def _flush(self, pending) -> None:
        aux, fetched = pending
        if aux is None or fetched is None:
            return
        td, event = fetched
        if event is not None:
            if not event.query():
                self.waits += 1
                event.synchronize()
            td = td.numpy()
        self._write_back(aux, np.abs(td) + 1e-6)


def _start_fetch(td):
    """``(host td, event)``: a card tensor starts its copy into pinned
    memory and records an event after it; a CPU tensor is already on the
    host (event None); None stays None."""
    if td is None:
        return None
    if td.device.type != "cuda":
        return td.numpy(), None
    host = torch.empty(td.shape, dtype=td.dtype, pin_memory=True)
    host.copy_(td, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(td.device))
    return host, event
