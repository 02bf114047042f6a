"""Double-buffered ingest against the in-flight fused chunk.

Counterpart of ``IngestOverlap`` and ``IngestDispatchError`` in
``d4pg_tpu/learner/pipeline.py``. The fused path's only host job is
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
raises ``IngestDispatchError`` instead of corrupting replay. The
host-sampled ``ChunkPipeline`` waits for the host replay slice.
"""

from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager


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
