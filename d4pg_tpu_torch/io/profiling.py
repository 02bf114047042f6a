"""Step-rate tracking, the runtime sentinels and the hot path's spans.

Counterpart of ``d4pg_tpu/io/profiling.py``: ``StepTimer`` (an EWMA of
grad steps per second over explicitly bracketed spans, so eval, collect
and checkpoint time between brackets do not dilute it) and the three
sentinels that hold the hot path's steady-state invariants
(``RecompileSentinel``, ``TransferSentinel``, ``ReshardSentinel``). The
reference's XLA trace capture is the driver's ``--profile_dir``
(``torch.profiler``) here.

Work on the card is asynchronous: the host returns from a chunk once its
kernels are queued. So with a CUDA ``device`` both ends of a
``StepTimer`` span synchronize it: the start so earlier queued work is
not counted, the end so the rate covers the kernels and not only their
queueing.

**What replaces XLA's event stream and HLO scan.** The port has no XLA,
so the sentinels keep the reference's names, attributes, error types and
registry counters, with PyTorch mechanisms under them:

- ``RecompileSentinel`` listens to ``record_build``, one event hook that
  the code which builds or tunes on the hot path calls when it really
  does: a kernel library compiled by nvcc (``ops/kernels.build``) or
  loaded (``ops/kernels.library``), an autotuner timing run
  (``ops/autotune.autotune_projection``, ``autotune_sampler``). A reuse
  or a cache hit calls nothing, as a jit cache hit records no
  ``backend_compile_duration`` event in the reference.
- ``TransferSentinel`` and ``ReshardSentinel`` are a
  ``TorchDispatchMode``: they see every operator below autograd and
  classify it by the devices of its sources and destinations, where the
  reference patches ``jax.device_put``/``device_get`` and scans the
  compiled HLO text.

**Units differ from the reference's.** The reference counts *calls* to
``jax.device_put``, and one call moves a whole tree. The port counts
*operators*: a staged block moves as one ``copy_`` per
``TransitionBatch`` field (``replay/fused_buffer.stage_block``), so "one
put of a block" is here "one copy per field, and the block's bytes"
(``h2d_bytes``). The port also counts what the reference's entry-point
patch cannot see: the device dealer's K x B float32 uniforms, one copy
of 40,960 B a deal at K = 40, B = 256 (``replay/device_sampler.
_to_device``), which the reference hands its jitted deal as numpy. A
point-to-point exchange counts its ``send`` and its ``recv`` apart,
each on its own rank, where the reference's HLO holds one
``collective-permute``.

**What a dispatch mode cannot see.** A dispatch mode is per thread:
operators of other threads (a commit thread, a server) are not counted,
where the reference's patch of ``jax.device_put`` is process-wide. Data
that a constructor copies below the dispatcher
(``torch.tensor(data, device=...)``) and the host staging a gloo
collective does for a CUDA tensor are not operators either; with
``guard="disallow"`` on the card a blocking copy of the first kind
raises. Each operator runs Python while a sentinel's mode is entered,
so none may wrap a window whose rate is reported.

The port's lint (``d4pg_tpu_torch/lint/__init__.py``) still carries none
of the JAX-only families these sentinels twin (``recompile-hazard``,
``device-put-in-loop``, ``sharding-spec-drift``): they stay out by the
decision recorded in ROADMAP item 18.

**Spans.** ``span(name)`` marks one layer of the learner's hot path (the
names are ``SPAN_NAMES``; the port has no counterpart in the reference,
whose XLA trace names its fused ops). A span is active only while
``torch.profiler`` is on or after ``spans.enable()``; inactive, its site
reads one flag and does nothing else. Active, it opens a profiler range
of its name (``_RecordFunctionFast``, which the kineto trace keeps on
the host thread beside the operators it runs, and which is not a user
annotation), stamps its host start and end with ``time.time_ns()`` (the
clock of the profiler's events), links to the span it opened in, carries
the grad step (``span("learner.step").at(state.step)``) and, on the card,
records a CUDA event at each end. ``spans.summary()`` (the ``spans``
provider of ``obs.REGISTRY``) reads the table; it alone waits for the
events.
"""

from __future__ import annotations

import collections
import functools
import itertools
import re
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

from d4pg_tpu_torch.obs.registry import REGISTRY


class StepTimer:
    def __init__(self, alpha: float = 0.9,
                 device: str | torch.device | None = None):
        self._alpha = alpha
        self._device = None if device is None else torch.device(device)
        self._t0: float | None = None
        self.rate: float | None = None

    def _sync(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int) -> float | None:
        if self._t0 is None:
            return self.rate
        self._sync()
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if dt > 0 and n_steps > 0:
            inst = n_steps / dt
            self.rate = (inst if self.rate is None
                         else self._alpha * self.rate
                         + (1 - self._alpha) * inst)
        return self.rate


# -- the build and tuning events (RecompileSentinel) -------------------------

_BUILD_LISTENERS: list = []


def record_build(what: str) -> None:
    """Report that ``what`` was really built, loaded or tuned just now.
    Every entered ``RecompileSentinel`` counts it; with none entered it
    costs one empty loop."""
    for listener in tuple(_BUILD_LISTENERS):
        listener(what)


class RecompileError(AssertionError):
    """A region that must be build-free built, loaded or tuned code."""


class RecompileSentinel:
    """Counts the builds, library loads and autotuner timing runs inside
    the bracketed region (``record_build`` events from any thread), which
    stall the port's steady state as a recompile stalls the reference's.
    After warm-up, wrap the hot loop and call :meth:`assert_clean`:

        with RecompileSentinel() as sentinel:
            for _ in range(n):
                metrics = update_step(config, state, batch, w)
        sentinel.assert_clean()

    Events before ``__enter__`` or after ``__exit__`` do not count.
    ``events`` names what fired, in order."""

    def __init__(self):
        self.compilations = 0
        self.events: list[str] = []
        self._mu = threading.Lock()
        self._active = False

    def _on_event(self, what: str) -> None:
        with self._mu:
            if self._active:
                self.compilations += 1
                self.events.append(what)

    def __enter__(self) -> "RecompileSentinel":
        with self._mu:
            self._active = True
        _BUILD_LISTENERS.append(self._on_event)
        return self

    def __exit__(self, *exc) -> None:
        with self._mu:
            self._active = False
        try:
            _BUILD_LISTENERS.remove(self._on_event)
        except ValueError:
            pass
        REGISTRY.counter("profiling.recompiles").inc(self.compilations)

    def assert_clean(self, what: str = "steady-state region") -> None:
        if self.compilations:
            raise RecompileError(
                f"{what} triggered {self.compilations} compilation(s) "
                f"after warm-up ({', '.join(self.events)}): a kernel build "
                "or an autotuner race on the hot path, a cache key that "
                "misses")


# -- operator classification (TransferSentinel, ReshardSentinel) -------------

# operators that hand a card tensor's value to the host as a Python value
_TO_NUMBER = ("_local_scalar_dense", "equal", "is_nonzero")
# operators whose job is the copy: a 0-dim source moves too
_COPIES = ("_to_copy", "copy_", "_copy_from", "_copy_from_and_resize")
# the port's collectives (``parallel/mesh.RankMesh``) and the reshard
# operators by class; any other collective is tallied under its own name
_COLLECTIVES = {
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "broadcast_": "broadcast",
    "barrier": "barrier",
}
DEVICE_COPY = "device-copy"  # a copy between two different accelerators
RESHARD_CLASSES = ("all-to-all", "collective-permute", DEVICE_COPY)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_host(dev: torch.device) -> bool:
    return dev.type == "cpu"


def _same(a: torch.device, b: torch.device) -> bool:
    """One device, where a device without an index (``cuda``) is the
    current one of its type."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def classify(func, args, kwargs) -> tuple[str, int] | None:
    """Whether one operator moves values across the host/device line or
    between two accelerators: ``("h2d" | "d2h" | "device-copy", bytes)``,
    else ``None``. Decided from the arguments alone, before the operator
    runs. The destination is the written arguments, else the ``device``
    argument, else the accelerator the inputs sit on (where the operator
    computes). A CPU source of a computing operator moves only if it has
    a dimension: a 0-dim CPU tensor is a scalar passed by value."""
    ins = [t for t in tree_flatten((args, kwargs))[0]
           if isinstance(t, torch.Tensor)]
    if not ins:
        return None
    name = func.overloadpacket.__name__
    if name in _TO_NUMBER:
        on_card = [t for t in ins if not _is_host(t.device)]
        if not on_card:
            return None
        return "d2h", (1 if name != "_local_scalar_dense"
                       else on_card[0].element_size())
    written = []
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        written += [t for t in tree_flatten(value)[0]
                    if isinstance(t, torch.Tensor)]
    if written:
        dsts = {t.device for t in written}
        srcs = [t for t in ins if not any(t is w for w in written)]
    elif kwargs.get("device") is not None:
        dsts = {torch.device(kwargs["device"])}
        srcs = ins
    else:
        dsts = {t.device for t in ins if not _is_host(t.device)}
        srcs = ins
    copy = name in _COPIES
    if any(not _is_host(d) for d in dsts):
        host = [t for t in srcs if _is_host(t.device)
                and (copy or t.dim() > 0)]
        if host:
            return "h2d", sum(map(_nbytes, host))
        other = [t for t in srcs if not _is_host(t.device)
                 and not any(_same(t.device, d) for d in dsts)]
        if copy and other:
            return DEVICE_COPY, sum(map(_nbytes, other))
        return None
    card = [t for t in srcs if not _is_host(t.device)]
    if card:
        return "d2h", sum(map(_nbytes, card))
    return None


class _Mode(TorchDispatchMode):
    """Calls ``on_op(func, args, kwargs)`` before each operator of the
    entering thread runs."""

    def __init__(self, on_op):
        super().__init__()
        self._on_op = on_op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._on_op(func, args, kwargs)
        return func(*args, **kwargs)


class TransferSentinel:
    """Counts the operators that move values across the host/device line
    in the bracketed region, on the entering thread: ``h2d`` (a CPU source,
    an accelerator destination: a copy, or a CPU index or operand with a
    dimension handed to a card operator) and ``d2h`` (a card source, a CPU
    destination, blocking or not, pinned or not, and ``item``, ``equal``
    and ``is_nonzero`` read from a card tensor), with their bytes
    (``h2d_bytes``, ``d2h_bytes``; a Python number counts its element).
    An operator counts when it is issued, so one that raises counts too.
    ``crossings`` lists ``(direction, operator, bytes)`` in order.

    Units: one staged block is one copy per ``TransitionBatch`` field and
    the block's bytes, where the reference counts one ``device_put`` of
    the block (see the module docstring).

    ``guard="disallow"`` sets ``torch.cuda.set_sync_debug_mode("error")``
    for the bracket and restores the previous level on exit, so a stream
    sync or a blocking copy inside raises. Like the reference's
    ``jax.transfer_guard``, the guard is inert on the CPU, where host and
    device memory are one: there is no CUDA to sync.

        with TransferSentinel() as t:
            run_fused_chunk()
        assert t.total == 0
    """

    def __init__(self, guard: str | None = None):
        if guard not in (None, "disallow"):
            raise ValueError(f"unknown transfer guard {guard!r} (want "
                             "'disallow' or None)")
        self.h2d = 0
        self.d2h = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.crossings: list[tuple[str, str, int]] = []
        self._guard = guard
        self._mode = None
        self._sync_mode = None

    @property
    def total(self) -> int:
        return self.h2d + self.d2h

    def _on_op(self, func, args, kwargs) -> None:
        found = classify(func, args, kwargs)
        if found is None or found[0] == DEVICE_COPY:
            return
        direction, n = found
        if direction == "h2d":
            self.h2d += 1
            self.h2d_bytes += n
        else:
            self.d2h += 1
            self.d2h_bytes += n
        self.crossings.append((direction, str(func), n))

    def __enter__(self) -> "TransferSentinel":
        self._mode = _Mode(self._on_op)
        self._mode.__enter__()
        if self._guard is not None and torch.cuda.is_available():
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self._sync_mode is not None:
                torch.cuda.set_sync_debug_mode(self._sync_mode)
                self._sync_mode = None
        finally:
            mode, self._mode = self._mode, None
            mode.__exit__(*exc)
            REGISTRY.counter("profiling.explicit_h2d").inc(self.h2d)
            REGISTRY.counter("profiling.explicit_d2h").inc(self.d2h)


class ReshardError(AssertionError):
    """A path that must keep one layout moved data between layouts."""


# the reshard operators by their names in an operator or profiler table
# (``c10d::alltoall_base_``, ``c10d.send.default``), and the profiler's
# name of a peer-to-peer copy between two cards
_RESHARD_TEXT = re.compile(
    r"c10d(?:::|\.)(alltoall_base_|alltoall_|send|recv_any_source_|recv_)"
    r"(?!\w)|Memcpy PtoP")


class ReshardSentinel:
    """Counts the operators that move data between layouts: an all-to-all
    (``c10d.alltoall*``), a point-to-point ``send`` or ``recv`` (the
    reference's ``collective-permute``), and a copy between two
    accelerators (``cuda:i`` to ``cuda:j``, the implicit reshard, class
    ``device-copy``). An all-reduce, all-gather or broadcast is tallied in
    ``ops`` under its class but is not a reshard: that is data
    parallelism. Every collective of the port goes through
    ``parallel/mesh.RankMesh``, so the operators are the whole story.

        sentinel = ReshardSentinel()
        sentinel.inspect(fn, *args)   # runs fn once under the mode
        sentinel.assert_clean("fused learner path")
        assert sentinel.steady_state_reshards == 0

    Entered as a context manager it counts the bracketed region of the
    entering thread. ``inspect_text`` counts the reshard operators' names
    in a text (an operator or profiler event table), as the reference
    scans HLO text; it tallies the reshard classes only."""

    def __init__(self):
        self.reshards = 0
        self.ops: dict[str, int] = {}
        self._mode = None
        self._at_enter = 0

    @property
    def steady_state_reshards(self) -> int:
        return self.reshards

    def _tally(self, cls: str) -> None:
        self.ops[cls] = self.ops.get(cls, 0) + 1
        if cls in RESHARD_CLASSES:
            self.reshards += 1

    def _on_op(self, func, args, kwargs) -> None:
        if func.namespace == "c10d":
            name = func.overloadpacket.__name__
            self._tally(_COLLECTIVES.get(name, name))
            return
        found = classify(func, args, kwargs)
        if found is not None and found[0] == DEVICE_COPY:
            self._tally(DEVICE_COPY)

    def __enter__(self) -> "ReshardSentinel":
        self._at_enter = self.reshards
        self._mode = _Mode(self._on_op)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        mode, self._mode = self._mode, None
        mode.__exit__(*exc)
        REGISTRY.counter("profiling.reshards").inc(
            self.reshards - self._at_enter)

    def inspect(self, fn, *args, **kwargs) -> int:
        """Run ``fn(*args, **kwargs)`` ONCE under the mode and return the
        reshards it made. Eager PyTorch has no lowering step to read
        without running, unlike the reference's ``lower()``: ``fn``
        executes, so pass arguments it may consume (its state updates in
        place)."""
        before = self.reshards
        with self:
            fn(*args, **kwargs)
        return self.reshards - before

    def inspect_text(self, text: str) -> int:
        found = 0
        for m in _RESHARD_TEXT.finditer(text):
            name = m.group(1)
            self._tally(DEVICE_COPY if name is None else _COLLECTIVES[name])
            found += 1
        REGISTRY.counter("profiling.reshards").inc(found)
        return found

    def assert_clean(self, what: str = "steady-state path") -> None:
        if self.reshards:
            detail = ", ".join(f"{op} x{n}"
                               for op, n in sorted(self.ops.items())
                               if op in RESHARD_CLASSES)
            raise ReshardError(
                f"{what} made {self.reshards} resharding operator(s) "
                f"({detail}): a tensor produced under one placement is "
                "consumed under another; route both through the same "
                "parallel/partition.py rule")


# -- spans: where the learner's hot path runs (``span``, ``spans``) ----------

# every span name of the port, from the loop down to the kernel wrappers
SPAN_NAMES = (
    "learner.chunk", "learner.step", "sampler.draw", "sampler.weights",
    "replay.gather", "update", "update.augment", "update.target",
    "update.critic", "update.actor", "update.soft_targets",
    "update.contrastive", "sampler.writeback", "model.encoder", "kernel.descent",
    "kernel.projection_ce.fwd", "kernel.projection_ce.bwd",
    "kernel.projection", "collective.grad_reduce", "collective.is_min")
# the span whose starts calibrate the device's clock (``SpanTable.markers``)
MARKER = "learner.step"
# the profiler range an active span opens, and whether spans take CUDA
# events (module names, so tests can stand in for both)
_Range = torch._C._profiler._RecordFunctionFast
_on_card = torch.cuda.is_initialized


class _Record:
    __slots__ = ("id", "site", "parent", "step", "thread", "t0", "t1",
                 "child_ns", "ev0", "ev1", "device_ms", "dev_ns", "range",
                 "launches0")


class SpanTable:
    """The spans of one process: a ring of the newest ``capacity`` closed
    spans (``overflow`` counts those it dropped) and the launch counters of
    the kernel wrappers (``count_launches``), read around each
    ``learner.step`` span.

    A span takes device events when its name does not start with
    ``kernel.`` (an event pair cannot resolve a kernel of a few µs) and
    CUDA is initialised in the process; they go on the current stream.
    Device times are the time the stream spent between a span's two
    events, idle included where the host lagged behind it. Events come
    from a pool: at each ``learner.step`` end the spans whose end event
    the device has passed (``query``, which does not wait) are read and
    their events go back, so the events in use are those the device has
    not reached yet, however long the profile."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self.forced = False  # ``enable()``: active without the profiler
        self.open = 0  # active spans open on any thread
        self.overflow = 0
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count()
        self._ring: collections.deque = collections.deque()
        self._pending: collections.deque = collections.deque()  # unread
        self._pool: list = []
        self._anchor = None  # the first marker's start event
        self._sources: dict[str, object] = {}
        self._launches: dict[str, int] = {}
        self._steps = 0  # markers closed, for the launches per step

    def enable(self) -> None:
        """Spans active whether or not the profiler is on."""
        self.forced = True

    def disable(self) -> None:
        self.forced = False

    def reset(self) -> None:
        """Forget every span, the anchor and the launch counts."""
        with self._mu:
            for r in self._pending:
                self._pool += [r.ev0, r.ev1]
            self._pending.clear()
            self._ring.clear()
            self.overflow = 0
            self._anchor = None
            self._launches = {}
            self._steps = 0

    def count_launches(self, name: str, read) -> None:
        """Report ``read()`` (a kernel wrapper's launch counter, or another
        host counter of the step such as ``update_step.encoder_reused``)
        per grad step in ``summary()`` under ``name``."""
        self._sources[name] = read

    # -- the span sites' two halves (active spans only) ----------------------

    def _event(self):
        with self._mu:
            if self._pool:
                return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def _enter(self, site: "Span") -> None:
        tls = self._tls
        stack = tls.__dict__.setdefault("stack", [])
        r = _Record()
        r.id = next(self._ids)
        r.site = site
        r.parent = stack[-1].id if stack else None
        r.step = tls.__dict__.get("step")
        r.thread = threading.get_ident()
        r.child_ns = 0
        r.ev0 = r.ev1 = r.device_ms = r.dev_ns = None
        r.range = _Range(site.name)
        r.range.__enter__()
        r.t0 = time.time_ns()
        if site.events and _on_card():
            r.ev0 = self._event()
            r.ev0.record()
            if site.name == MARKER and self._anchor is None:
                self._anchor = r.ev0
        if site.name == MARKER:
            r.launches0 = {k: read() for k, read in self._sources.items()}
        stack.append(r)
        with self._mu:
            self.open += 1

    def _exit(self, site: "Span") -> None:
        stack = self._tls.__dict__.get("stack")
        if not stack or stack[-1].site is not site:
            return  # this site's enter found the spans inactive
        r = stack.pop()
        if r.ev0 is not None:
            r.ev1 = self._event()
            r.ev1.record()
        r.t1 = time.time_ns()
        r.range.__exit__(None, None, None)
        r.range = None
        if stack:
            stack[-1].child_ns += r.t1 - r.t0
        with self._mu:
            self.open -= 1
            if site.name == MARKER:
                self._steps += 1
                for k, read in self._sources.items():
                    self._launches[k] = (self._launches.get(k, 0) + read()
                                         - r.launches0[k])
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.overflow += 1
            self._ring.append(r)
            if r.ev0 is not None:
                self._pending.append(r)
            if site.name == MARKER:
                self._read_events(wait=False)

    def _read_events(self, wait: bool) -> None:
        """Read the pending spans' event pairs in the order they closed
        (the order the stream reaches their ends), up to the first the
        device has not passed, or all of them with ``wait``; their events
        go back to the pool (the anchor's stays). Holds ``_mu``."""
        anchor = self._anchor
        while self._pending:
            r = self._pending[0]
            if wait:
                r.ev1.synchronize()
            elif not r.ev1.query():
                return
            self._pending.popleft()
            r.device_ms = r.ev0.elapsed_time(r.ev1)
            if r.site.name == MARKER:
                r.dev_ns = round(anchor.elapsed_time(r.ev0) * 1e6)
            self._pool += [ev for ev in (r.ev0, r.ev1) if ev is not anchor]
            r.ev0 = r.ev1 = None

    # -- reading the table (never on the hot path) ---------------------------

    def _closed(self) -> list[_Record]:
        with self._mu:
            self._read_events(wait=True)
            return sorted(self._ring, key=lambda r: r.t0)

    def records(self) -> list[dict]:
        """Every span in the table, in order of start: ``id``, ``name``,
        ``parent`` (the id of the span it opened in on its thread, or
        ``None``), ``step``, ``thread``, host ``start_ns`` and ``end_ns``
        and ``device_ms`` (``None`` without events)."""
        return [{"id": r.id, "name": r.site.name, "parent": r.parent,
                 "step": r.step, "thread": r.thread, "start_ns": r.t0,
                 "end_ns": r.t1, "device_ms": r.device_ms}
                for r in self._closed()]

    def markers(self, recs: list[_Record] | None = None
                ) -> list[tuple[int, int, int]]:
        """``(id, host ns, device ns)`` of each ``learner.step`` start that
        took an event, the device's time put on the host clock: each
        event's time from the first marker's event, plus the least offset
        under which no marker is reached on the device before the host
        recorded it (so the tightest marker reads a lead of 0)."""
        recs = self._closed() if recs is None else recs
        raw = [(r.id, r.t0, r.dev_ns) for r in recs
               if r.site.name == MARKER and r.dev_ns is not None]
        if not raw:
            return []
        offset = max(h - e for _, h, e in raw)
        return [(i, h, e + offset) for i, h, e in raw]

    def summary(self) -> dict:
        """Per span name (``spans``): ``count``, ``host_ns`` and
        ``self_ns`` (less the spans opened inside it on its thread) and
        ``device_ms`` (the event pairs' sum, ``None`` without events);
        ``steps`` (the ``learner.step`` spans held), ``lead_ms`` (per
        marker, how far the host ran ahead of the device: ``markers()``'
        device time less its host time), ``launches_per_step`` (the kernel
        wrappers' counters and ``encoder.reused``, the encoder forwards the
        update step saved, over the ``learner.step`` spans) and
        ``overflow``. Waits for the events it reads."""
        recs = self._closed()
        with self._mu:
            steps, launches = self._steps, dict(self._launches)
            overflow = self.overflow
        names: dict[str, dict] = {}
        for r in recs:
            d = names.setdefault(r.site.name, {
                "count": 0, "host_ns": 0, "self_ns": 0, "device_ms": None})
            d["count"] += 1
            d["host_ns"] += r.t1 - r.t0
            d["self_ns"] += r.t1 - r.t0 - r.child_ns
            if r.device_ms is not None:
                d["device_ms"] = (d["device_ms"] or 0.0) + r.device_ms
        return {
            "steps": names.get(MARKER, {}).get("count", 0),
            "spans": names,
            "lead_ms": [(d - h) / 1e6 for _, h, d in self.markers(recs)],
            "launches_per_step": ({k: v / steps for k, v in launches.items()}
                                  if steps else {}),
            "overflow": overflow,
        }


spans = SpanTable()
REGISTRY.register_provider("spans", spans.summary)


class Span:
    """One span site (``span(name)``): ``with span(name):`` or, as a
    decorator, ``@span(name)``. Inactive, entering reads one flag and
    leaving reads ``spans.open``."""

    __slots__ = ("name", "events")

    def __init__(self, name: str):
        self.name = name
        self.events = not name.startswith("kernel.")

    def at(self, step: int) -> "Span":
        """This span, and the spans opened after it on its thread until
        the next ``at``, carry ``step`` (when the spans are active)."""
        if _autograd_profiler._is_profiler_enabled or spans.forced:
            spans._tls.step = step
        return self

    def __enter__(self) -> "Span":
        if _autograd_profiler._is_profiler_enabled or spans.forced:
            spans._enter(self)
        return self

    def __exit__(self, *exc) -> None:
        if spans.open:
            spans._exit(self)

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not (_autograd_profiler._is_profiler_enabled
                    or spans.forced):
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)

        return spanned


_SITES = {name: Span(name) for name in SPAN_NAMES}


def span(name: str) -> Span:
    """The span site ``name``, one of ``SPAN_NAMES``."""
    site = _SITES.get(name)
    if site is None:
        raise KeyError(f"unknown span {name!r}; the spans are {SPAN_NAMES}")
    return site
