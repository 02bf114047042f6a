"""The readers of the program's spans (``metrics/sampler_ms_per_step.py``,
``update_ms_per_step.py``, ``host_lead_ms.py``, through
``harness/spans.py``) and the trace reader's gap labels inside a span.

On the CPU a traced slice records spans but no CUDA events, so every
reader returns ``None`` there; stand-in events with a scripted device
clock give them known times to compute from.
"""

from __future__ import annotations

import statistics
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench_tiny import tiny
from harness import spec, trace
from d4pg_tpu_torch.io import profiling
from d4pg_tpu_torch.io.profiling import span, spans

PER, UNIFORM = "cheetah-pixels.per.b512", "cheetah-pixels.uniform.b512"
READERS = ("sampler_ms_per_step", "update_ms_per_step", "host_lead_ms")


@pytest.fixture(autouse=True)
def clean_table():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _read(name, ctx=None):
    return spec.plugin("metrics", name).read(ctx)


def _traced_run(name):
    cell = tiny(name)
    runner = spec.plugin("runners", cell.traffic["runner"])
    out = runner.run(cell, 2**31 + 11, 0.0, True, time.time(),
                     device=torch.device("cpu"))
    return cell, out


@pytest.mark.parametrize("name", [PER, UNIFORM])
def test_readers_after_a_cpu_traced_slice_return_none(name):
    cell, out = _traced_run(name)
    s = spans.summary()
    k = int(cell.traffic["k"]) * int(cell.traffic["trace_chunks"])
    # the profiler turned the spans on for the traced slice alone
    assert s["steps"] == out["trace_steps"] == k
    assert s["spans"]["update"]["device_ms"] is None
    for reader in READERS:
        assert _read(reader) is None, reader


def test_only_the_per_cell_lists_the_sampler():
    listed = {name: [m["name"] for m in spec.cell(name).per_layer]
              for name in (PER, UNIFORM)}
    assert "sampler_ms_per_step" in listed[PER]
    assert "sampler_ms_per_step" not in listed[UNIFORM]
    for name in (PER, UNIFORM):
        assert {"update_ms_per_step", "host_lead_ms"} <= set(listed[name])


class _Event:
    def __init__(self, clock):
        self.clock, self.t = clock, None

    def record(self):
        self.t = self.clock()

    def query(self):
        return self.t <= time.time_ns()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_readers_compute_from_known_event_times(monkeypatch):
    """Each span's device time is scripted: the stream sits ``lag`` ns
    behind the host at a step's start and each span takes ``extra`` ns of
    device time more than of host time."""
    lag = {"v": 0}
    monkeypatch.setattr(profiling, "_on_card", lambda: True)
    monkeypatch.setattr(profiling.SpanTable, "_event",
                        lambda self: _Event(lambda: time.time_ns()
                                            + lag["v"]))
    lags = [0, 6_000_000, 6_000_000, 1_000_000, 20_000_000]
    spans.enable()
    for v in lags:
        lag["v"] = v
        with span("learner.step").at(0):
            for name, extra in (("sampler.draw", 1_000_000),
                                ("sampler.weights", 2_000_000),
                                ("update", 5_000_000),
                                ("sampler.writeback", 3_000_000)):
                with span(name):
                    time.sleep(0.0005)
                    lag["v"] += extra
    s = spans.summary()
    host = {n: s["spans"][n]["host_ns"] / 1e6 for n in s["spans"]}
    sampler = (s["spans"]["sampler.draw"]["device_ms"]
               + s["spans"]["sampler.weights"]["device_ms"]
               + s["spans"]["sampler.writeback"]["device_ms"])
    # (1 ms of room: a preempted thread records its events late)
    assert sampler == pytest.approx(
        host["sampler.draw"] + host["sampler.weights"]
        + host["sampler.writeback"] + 5 * 6.0, abs=1.0)
    assert _read("sampler_ms_per_step") == pytest.approx(sampler / 5)
    assert _read("update_ms_per_step") == pytest.approx(
        host["update"] / 5 + 5.0, abs=0.5)
    # the tightest marker (lag 0) is the zero; the others lead by their lag
    assert s["lead_ms"] == pytest.approx([v / 1e6 for v in lags], abs=1.0)
    assert _read("host_lead_ms") == pytest.approx(
        statistics.median(v / 1e6 for v in lags), abs=1.0)


def test_readers_read_a_given_summary(monkeypatch):
    summary = {"steps": 4, "overflow": 0, "launches_per_step": {},
               "lead_ms": [0.0, 30.0, 31.0, 2.0, 40.0],
               "spans": {"sampler.draw": {"device_ms": 0.8},
                         "sampler.weights": {"device_ms": 0.2},
                         "sampler.writeback": {"device_ms": 1.0},
                         "update": {"device_ms": 128.0}}}
    monkeypatch.setattr(spans, "summary", lambda: summary)
    assert _read("sampler_ms_per_step") == pytest.approx(0.5)
    assert _read("update_ms_per_step") == pytest.approx(32.0)
    assert _read("host_lead_ms") == pytest.approx(30.0)
    del summary["spans"]["sampler.writeback"]  # uniform replay
    assert _read("sampler_ms_per_step") is None
    summary["steps"] = 0
    for reader in READERS:
        assert _read(reader) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    for reader in READERS:
        assert _read(reader) is None


class _Busy:
    """A device interval on the CUDA timeline, in kineto's terms."""

    def __init__(self, start, end):
        self.s, self.e = start, end

    def name(self):
        return "kernel"

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_thread_id(self):
        return 0


@pytest.mark.parametrize("kind", ["span", "record_function"])
def test_gap_reader_labels_idle_inside_a_span_by_its_name(kind):
    """The device runs until just inside the range and idles after it: the
    gap begins while only the range is open on the window's thread. A
    program span names it; a user annotation is skipped (``python``)."""
    outer = (span("update") if kind == "span"
             else record_function("update"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with outer:
                time.sleep(0.002)
    events = list(prof.profiler.kineto_results.events())
    rng = [e for e in events if e.name() == "update"
           and e.device_type() != torch.autograd.DeviceType.CUDA][0]
    win = [e for e in events if e.name() == trace.WINDOW][0]
    busy_end = rng.start_ns() + 500_000
    tr = trace.read(events + [_Busy(win.start_ns(), busy_end)])
    assert tr.busy_s == pytest.approx((busy_end - win.start_ns()) * 1e-9)
    label = "update" if kind == "span" else "python"
    assert list(tr.gaps) == [label]
    assert tr.launches == 0
