"""The training loops a learner replica drives: fused chunks and dealt
blocks.

Counterpart of ``d4pg_tpu/learner/loop.py`` (``FusedLoop``,
``DealtLoop``). ``FusedLoop.run`` cuts
``n`` grad steps into chunks of K and calls the fused chunk
(``learner/fused.py``) for each, the last chunk shorter when K does not
divide ``n``. The chunk functions are cached per chunk length. The state
is updated in place, and the random draws come from the loop's
``generator``, where the reference threads a PRNG key through its state.

With a ``service`` (the ``ReplayService`` actors stream into) the loop
claims the service's single ingest-dispatch slot
(``learner/pipeline.IngestOverlap``) and follows the reference's
schedule: a full ``flush`` at the start of ``run`` (every row staged by
the collect phase lands before training), then per chunk

    ingest.commit()   # the staged block lands in the ring and trees
    queue chunk t     # K fused grad steps
    ingest.stage()    # the next block's copy rides under chunk t

Without one (``service=None``) it runs against a buffer filled between
runs. After each chunk the trace recorder's ``mark_grad`` stamps the
traces whose rows committed before it (``obs/trace``; a no-op when none
is pending). Each chunk, commit to ``mark_grad``, is a ``learner.chunk``
span (``io/profiling.span``).

``DealtLoop`` is the consumer half of the sample-on-ingest plane
(``replay/sampler.py``): per block it pops the replica's ring (a
leaf-tier wait, never the buffer lock), runs K grad steps on the block's
rows with the dealer's IS weights, and queues the TD priorities back
through ``service.queue_writeback`` (the ``sampler`` tier). Host blocks
(numpy rows) are copied to the learner's device; device blocks (the
device dealer's gathers, on the default stream the update runs on) go
in as they are. The write-back is the loop's one host sync: the [K, B]
TD errors, slots and generations, never the rows.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from d4pg_tpu_torch.io.profiling import span
from d4pg_tpu_torch.learner.fused import (
    make_fused_chunk,
    make_sharded_fused_chunk,
)
from d4pg_tpu_torch.learner.pipeline import IngestOverlap
from d4pg_tpu_torch.learner.state import D4PGConfig, D4PGState
from d4pg_tpu_torch.obs.trace import RECORDER as trace_recorder
from d4pg_tpu_torch.replay.uniform import TransitionBatch


class FusedLoop:
    """Drives fused replay+learn chunks against a ``FusedDeviceReplay``
    (its ``storage``, ``size`` and, when ``prioritized``, ``trees``),
    fed by ``service`` when one is given. With a ``mesh`` (a
    ``parallel/mesh.RankMesh``) the buffer is this rank's
    ``ShardedFusedReplay`` and the chunks are the sharded ones
    (``learner/fused.make_sharded_fused_chunk``)."""

    def __init__(
        self,
        config: D4PGConfig,
        buffer,
        *,
        k: int,
        batch_size: int,
        generator: torch.Generator,
        prioritized: bool = True,
        alpha: float = 0.6,
        beta0: float = 0.4,
        beta_steps: int = 100_000,
        service=None,
        mesh=None,
    ):
        if service is not None and not all(
                hasattr(service, op) for op in
                ("ingest_commit", "ingest_stage", "drain_device")):
            raise TypeError(
                f"service must be a ReplayService (ingest_commit, "
                f"ingest_stage, drain_device), got {type(service).__name__}")
        if prioritized and buffer.trees is None:
            raise ValueError("prioritized=True needs a buffer with PER trees")
        self._config = config
        self._buffer = buffer
        self.k = max(1, int(k))
        self._batch_size = int(batch_size)
        self._generator = generator
        self._prioritized = bool(prioritized)
        self._alpha = float(alpha)
        self._beta0 = float(beta0)
        self._beta_steps = int(beta_steps)
        self._mesh = mesh
        self._fns: dict[int, Callable] = {}
        self.ingest = IngestOverlap(service) if service is not None else None
        self.steps_done = 0
        self.chunks = 0

    def fused_for(self, k: int) -> Callable:
        """The fused-chunk function for chunk length ``k`` (cached)."""
        if k not in self._fns:
            kwargs = dict(k=k, batch_size=self._batch_size,
                          prioritized=self._prioritized, alpha=self._alpha,
                          beta0=self._beta0, beta_steps=self._beta_steps)
            self._fns[k] = (
                make_sharded_fused_chunk(self._config, self._mesh, **kwargs)
                if self._mesh is not None
                else make_fused_chunk(self._config, **kwargs))
        return self._fns[k]

    def run(
        self,
        state: D4PGState,
        n: int,
        on_chunk: Callable[[D4PGState, int], None] | None = None,
    ) -> dict[str, torch.Tensor] | None:
        """``n`` fused grad steps on ``state`` (in place). Returns the LAST
        chunk's metrics stacked along its length (``None`` when
        ``n <= 0``). ``on_chunk(state, k)`` runs after each chunk."""
        buffer = self._buffer
        metrics = None
        done = 0
        if self.ingest is not None:
            self.ingest.flush()
        while done < n:
            k = min(self.k, n - done)
            fn = self.fused_for(k)
            with span("learner.chunk").at(state.step):
                if self.ingest is not None:
                    self.ingest.commit()
                if self._prioritized:
                    buffer.trees, metrics = fn(state, buffer.trees,
                                               buffer.storage, buffer.size,
                                               generator=self._generator)
                else:
                    metrics = fn(state, buffer.storage, buffer.size,
                                 generator=self._generator)
                if self.ingest is not None:
                    self.ingest.stage()
                trace_recorder.mark_grad()
            done += k
            self.steps_done += k
            self.chunks += 1
            if on_chunk is not None:
                on_chunk(state, k)
        return metrics

    def close(self) -> None:
        """Release the service's ingest-dispatch slot so a successor
        consumer can claim it."""
        if self.ingest is not None:
            self.ingest.release()


class DealtLoop:
    """Drives dealt blocks from a ``DealtBlockRing`` through
    ``update_fn(state, batches, weights) -> metrics`` (in place, stacked
    [K] metrics with ``td_error`` [K, B]). ``stop`` (an ``Event``) lets the
    owning replica abandon a waiting pop."""

    def __init__(self, update_fn, ring, service, *, device,
                 stop=None, pop_timeout: float = 0.2):
        self._update = update_fn
        self._ring = ring
        self._service = service
        self._device = torch.device(device)
        self._stop = stop
        self._pop_timeout = float(pop_timeout)
        self.steps_done = 0
        self.blocks = 0

    def run(
        self,
        state: D4PGState,
        n: int,
        on_chunk: Callable[[D4PGState, int], None] | None = None,
    ) -> dict[str, torch.Tensor] | None:
        """At least ``n`` grad steps from dealt blocks (a block carries K,
        so the last may overshoot); returns the last block's stacked
        metrics (``None`` when nothing was consumed: a closed ring)."""
        dev = self._device
        metrics = None
        done = 0
        while done < n and (self._stop is None or not self._stop.is_set()):
            block = self._ring.pop(timeout=self._pop_timeout)
            if block is None:
                if self._ring.closed:
                    break
                continue
            batches = TransitionBatch(*[torch.as_tensor(f, device=dev)
                                        for f in block.batches])
            metrics = self._update(state, batches,
                                   torch.as_tensor(block.weights, device=dev))
            td = np.abs(metrics["td_error"].cpu().numpy()) + 1e-6
            idx = np.asarray(torch.as_tensor(block.idx).cpu())
            gen = np.asarray(torch.as_tensor(block.gen).cpu())
            self._service.queue_writeback(idx, td, gen)
            trace_recorder.mark_grad()
            k = int(idx.shape[0])
            done += k
            self.steps_done += k
            self.blocks += 1
            if on_chunk is not None:
                on_chunk(state, k)
        return metrics
