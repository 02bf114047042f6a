"""Port vs reference: the observability plane (``d4pg_tpu_torch/obs``).

The portable cases of ``tests/test_obs.py`` re-asserted on the port, each
scenario also run through the reference's ``d4pg_tpu/obs`` and held to
the same outcome: the registry (metrics, providers and their weak
references, the guarded unregister, a crashing provider), the metrics
bus's poisoned sink, trace ids, the trace recorder (spans, latency
block, bound, disabled), thread-crash containment and the flight
recorder (bounded ring, dump). Then the hooks the port's landed modules
carry: a crash of the background evaluator's loop is counted, a
``FusedLoop`` and a ``ChunkPipeline`` mark grad once per chunk, a clean
driver run records no crash and writes no dump, and the driver accepts
``--trace_sample`` and ``--profile_dir`` on the CPU.
"""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from d4pg_tpu.obs import containment as jcontainment
from d4pg_tpu.obs import flight as jflight
from d4pg_tpu.obs import registry as jregistry
from d4pg_tpu.obs import trace as jtrace
from d4pg_tpu_torch.obs import containment as tcontainment
from d4pg_tpu_torch.obs import flight as tflight
from d4pg_tpu_torch.obs import registry as tregistry
from d4pg_tpu_torch.obs import trace as ttrace
from torch_lock_modes import debug_mode  # noqa: F401  (a fixture)

pytestmark = pytest.mark.torchport

PAIRS = {"port": (tregistry, tflight, ttrace, tcontainment),
         "reference": (jregistry, jflight, jtrace, jcontainment)}


def _both(scenario):
    """The scenario's result on the port and on the reference."""
    return {name: scenario(*mods) for name, mods in PAIRS.items()}


def test_registry_counter_gauge_histogram():
    def scenario(registry, *_):
        reg = registry.MetricsRegistry()
        c = reg.counter("a.rows")
        assert reg.counter("a.rows") is c  # get-or-create is idempotent
        c.inc()
        c.inc(41)
        reg.gauge("a.rate").set(3.5)
        h = reg.histogram("a.lat")
        for v in (1.0, 2.0, 3.0, 100.0):
            h.observe(v)
        out = reg.export()
        reg.reset_metrics()
        return out, reg.export()["counters"]["a.rows"]

    got = _both(scenario)
    assert got["port"] == got["reference"]
    out, after_reset = got["port"]
    assert out["counters"]["a.rows"] == 42 and after_reset == 0
    assert out["gauges"]["a.rate"] == 3.5
    lat = out["histograms"]["a.lat"]
    assert lat["n"] == 4 and lat["p50"] == 2.5 and lat["p99"] > 90.0


def test_registry_provider_consistent_snapshot_and_weakref():
    def scenario(registry, *_):
        reg = registry.MetricsRegistry()

        class Owner:
            def __init__(self):
                self._mu = threading.Lock()
                self.n = 7

            def stats(self):
                with self._mu:  # the provider reads under its owning lock
                    return {"n": self.n}

        o = Owner()
        reg.register_provider("owner", o.stats)
        live = reg.export()["owner"]
        del o  # a dying owner drops out instead of leaking or raising
        return live, "owner" in reg.export()

    got = _both(scenario)
    assert got["port"] == got["reference"] == ({"n": 7}, False)


def test_registry_unregister_only_evicts_own_slot():
    def scenario(registry, *_):
        reg = registry.MetricsRegistry()

        class Owner:
            def __init__(self, n):
                self.n = n

            def stats(self):
                return {"n": self.n}

        old, new = Owner(1), Owner(2)
        reg.register_provider("svc", old.stats)
        reg.register_provider("svc", new.stats)  # last registered wins
        reg.unregister_provider("svc", old.stats)  # a stale close
        kept = reg.export()["svc"]
        reg.unregister_provider("svc", new.stats)
        return kept, "svc" in reg.export()

    got = _both(scenario)
    assert got["port"] == got["reference"] == ({"n": 2}, False)


def test_registry_crashing_provider_contained():
    def scenario(registry, *_):
        reg = registry.MetricsRegistry()

        def bad():
            raise RuntimeError("boom")

        reg.register_provider("bad", bad)
        return reg.export()["bad"]

    got = _both(scenario)
    assert got["port"] == got["reference"]
    assert "boom" in got["port"]["provider_error"]


def test_metrics_bus_poisoned_sink_disabled_not_fatal(capsys):
    from d4pg_tpu.io.metrics import MetricsBus as JaxBus
    from d4pg_tpu_torch.io.metrics import MetricsBus

    def scenario(bus_cls, registry):
        class Poisoned:
            writes = 0

            def write(self, step, metrics):
                Poisoned.writes += 1
                raise IOError("disk full")

            def close(self):
                raise IOError("still broken")

        class Good:
            def __init__(self):
                self.rows = []
                self.closed = False

            def write(self, step, metrics):
                self.rows.append((step, dict(metrics)))

            def close(self):
                self.closed = True

        counter = registry.REGISTRY.counter("metrics_bus.sink_failures")
        fails0 = counter.value
        good = Good()
        bus = bus_cls(sinks=[Poisoned(), good])
        for step in range(3):
            bus.log(step, {"x": 1.0})  # must not raise
        bus.close()  # the poisoned close is contained too
        return (Poisoned.writes, [s for s, _ in good.rows], good.closed,
                counter.value - fails0)

    port = scenario(MetricsBus, tregistry)
    assert port == scenario(JaxBus, jregistry)
    # one write, then disabled; the good sink logs on; write + close
    # failures both counted in the registry
    assert port == (1, [0, 1, 2], True, 2)
    assert "disabled" in capsys.readouterr().out


def test_trace_ids_unique_across_salts():
    a = {ttrace.new_trace_id(1) for _ in range(100)}
    b = {ttrace.new_trace_id(2) for _ in range(100)}
    assert len(a) == len(b) == 100 and not (a & b)
    # the reference's layout: the salt in the top 16 bits
    assert {t >> 48 for t in a} == {1} and {t >> 48 for t in b} == {2}
    assert {jtrace.new_trace_id(1) >> 48} == {ttrace.new_trace_id(1) >> 48}


def test_trace_recorder_spans_and_latency_block():
    def scenario(_registry, _flight, trace, _containment):
        rec = trace.TraceRecorder()
        rec.enable(0.5)
        t0 = 100.0
        rec.begin(1, t0)
        for i, stage in enumerate(("admission", "decode", "stage",
                                   "merge")):
            rec.record_span(1, stage, ts=t0 + 0.001 * (i + 1))
        rec.mark_committed([1])
        orphans_after_commit = rec.orphans()
        rec.mark_grad(ts=time.monotonic() + 1.0)
        rec.begin(2, t0)
        rec.record_span(2, "admission", ts=t0 + 0.001)
        orphans_open = rec.orphans()
        rec.terminal_shed(2)
        block = rec.latency_block()
        return (orphans_after_commit, orphans_open, rec.orphans(),
                {k: block[k] for k in ("sample_rate", "completed", "shed",
                                       "n_traces", "orphans", "overflow")},
                {k: v["n"] for k, v in block["stages"].items()},
                rec.span_table()[1])

    got = _both(scenario)
    port, ref = got["port"], got["reference"]
    assert port[:5] == ref[:5]
    after_commit, open_, closed, counts, stage_n, spans = port
    assert after_commit == [] and open_ == [2] and closed == []
    assert counts["sample_rate"] == 0.5
    assert counts["completed"] == 1 and counts["shed"] == 1
    assert stage_n["wire_to_grad"] == 1 and stage_n["commit_to_grad"] == 1
    order = [spans[s] for s in ("send", "admission", "decode", "stage",
                                "merge", "commit", "grad")]
    assert order == sorted(order)


def test_trace_recorder_bounded_and_disabled_noop():
    def scenario(_registry, _flight, trace, _containment):
        rec = trace.TraceRecorder(max_traces=4)
        rec.enable(1.0)
        for tid in range(4):
            rec.begin(tid, 0.0)  # all live: the table is full
        rec.begin(99, 0.0)
        full = (rec.overflow, 99 in rec.span_table())
        rec.terminal_shed(0)  # now one record is evictable
        rec.begin(100, 0.0)
        evicted = (100 in rec.span_table(), 0 in rec.span_table())
        rec.disable()
        rec.begin(101, 0.0)
        return full, evicted, 101 in rec.span_table(), rec.mark_grad()

    got = _both(scenario)
    assert got["port"] == got["reference"]
    assert got["port"] == ((1, False), (True, False), False, 0)


def test_contained_crash_counts_and_flight_records():
    def scenario(registry, flight, _trace, containment):
        ctr = registry.REGISTRY.counter("threads.contained_crashes")
        before = ctr.value
        flight.RECORDER.reset()
        containment.contained_crash("test.lane", ValueError("boom"))
        events = [e for e in flight.RECORDER.events()
                  if e["kind"] == "thread_crash_contained"]
        return ctr.value - before, [(e["role"], e["error"]) for e in events]

    got = _both(scenario)
    assert got["port"] == got["reference"]
    assert got["port"] == (1, [("test.lane", "ValueError: boom")])


def test_flight_recorder_ring_bounded_and_dump(tmp_path):
    def scenario(_registry, flight, _trace, _containment, where):
        rec = flight.FlightRecorder(maxlen=8)
        for i in range(20):
            rec.record("tick", i=i)
        events = rec.events()
        assert all(e["kind"] == "tick" and "t" in e and "seq" in e
                   for e in events)
        path = rec.dump(str(where), "unit test!", extra={"n": 1})
        with open(path) as f:
            d = json.load(f)
        return (len(rec), [e["i"] for e in events], d["reason"],
                d["n_events"], d["context"], [e["i"] for e in d["events"]],
                Path(path).name.endswith("_unit_test_.json"))

    port = scenario(*PAIRS["port"], tmp_path / "port")
    assert port == scenario(*PAIRS["reference"], tmp_path / "reference")
    assert port[:6] == (8, list(range(12, 20)), "unit test!", 8, {"n": 1},
                        list(range(12, 20)))
    assert port[6]  # the reason, made safe, ends the name
    # retention: the directory keeps the newest ``keep`` dumps
    rec = tflight.FlightRecorder(maxlen=4)
    for i in range(5):
        rec.dump(str(tmp_path / "kept"), f"r{i}", keep=3)
    kept = sorted(p.name for p in (tmp_path / "kept").iterdir())
    assert len(kept) == 3 and kept[-1].endswith("r4.json")


def test_lock_violation_is_flight_recorded(debug_mode):
    from d4pg_tpu_torch.core import locking

    tflight.RECORDER.reset()
    with pytest.raises(locking.LockHierarchyError):
        with locking.TieredLock("shard"):
            with locking.TieredLock("service"):
                pass
    events = [e for e in tflight.RECORDER.events()
              if e["kind"] == "lock_violation"]
    assert len(events) == 1 and "acquiring 'service'" in events[0]["msg"]


def test_evaluator_crash_is_counted():
    """A crash in the background evaluator's own loop (not in an eval,
    which is printed and survived) ends the thread and is counted in
    ``threads.contained_crashes`` with an ``evaluator.loop`` event."""
    from d4pg_tpu_torch.distributed.evaluator import AsyncEvaluator

    class Broken:
        def get(self, timeout=None):
            raise RuntimeError("request queue broke")

    ctr = tregistry.REGISTRY.counter("threads.contained_crashes")
    before = ctr.value
    tflight.RECORDER.reset()
    ev = AsyncEvaluator.__new__(AsyncEvaluator)
    ev._ev, ev._requests, ev._latest = None, Broken(), None
    ev._lock, ev._outstanding = threading.Lock(), 0
    ev._stop = threading.Event()
    ev._thread = threading.Thread(target=ev._loop, daemon=True)
    ev._thread.start()
    ev._thread.join(timeout=10.0)
    assert not ev._thread.is_alive()
    assert ctr.value == before + 1
    events = [e for e in tflight.RECORDER.events()
              if e["kind"] == "thread_crash_contained"]
    assert [(e["role"], e["error"]) for e in events] == [
        ("evaluator.loop", "RuntimeError: request queue broke")]


def _rows(rng, n, obs=4, act=2):
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    return TransitionBatch(
        obs=rng.standard_normal((n, obs)).astype(np.float32),
        action=rng.uniform(-1, 1, (n, act)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, obs)).astype(np.float32),
        done=np.zeros(n, np.float32),
        discount=np.full(n, 0.99, np.float32))


def test_fused_loop_marks_grad_once_per_chunk(rng, monkeypatch):
    """``FusedLoop.run`` stamps the committed traces after each chunk
    (7 steps at K = 3: three chunks, three marks); a trace committed
    before the run gets its grad span from the first one."""
    from d4pg_tpu_torch.learner import loop as tloop
    from d4pg_tpu_torch.learner.state import D4PGConfig, init_state
    from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

    rec = ttrace.TraceRecorder()
    rec.enable(1.0)
    marks = []
    mark_grad = rec.mark_grad
    rec.mark_grad = lambda ts=None: marks.append(mark_grad(ts))
    monkeypatch.setattr(tloop, "trace_recorder", rec)
    rec.begin(7, time.monotonic())
    rec.mark_committed([7])

    cfg = D4PGConfig(obs_dim=4, act_dim=2, hidden=(16, 16), n_atoms=11,
                     v_min=-5.0, v_max=0.0)
    buf = FusedDeviceReplay(64, 4, 2, device="cpu", block_rows=16)
    buf.add(_rows(rng, 40))
    buf.drain()
    loop = tloop.FusedLoop(cfg, buf, k=3, batch_size=8,
                           generator=torch.Generator().manual_seed(0))
    loop.run(init_state(cfg, 0, "cpu"), 7)
    assert marks == [1, 0, 0]
    assert "grad" in rec.span_table()[7]


def test_chunk_pipeline_marks_grad_once_per_chunk(monkeypatch):
    from d4pg_tpu_torch.learner import pipeline as tpipe

    marks = []
    rec = ttrace.TraceRecorder()
    rec.mark_grad = lambda ts=None: marks.append(1) or 0
    monkeypatch.setattr(tpipe, "trace_recorder", rec)
    pipe = tpipe.ChunkPipeline(
        lambda s, b: (s + 1, {"td_error": torch.zeros(2)}),
        lambda: ((np.zeros(2, np.float32), None), None),
        device="cpu", use_weights=False)
    state, _ = pipe.run(0, 4)
    assert state == 4 and len(marks) == 4


TINY = ["--env", "point", "--max_steps", "20", "--num_envs", "2",
        "--warmup", "100", "--n_eps", "1", "--n_cycles", "2",
        "--episodes_per_cycle", "1", "--train_steps_per_cycle", "8",
        "--updates_per_dispatch", "4", "--eval_trials", "1", "--bsize", "16",
        "--rmsize", "2000", "--n_atoms", "11", "--v_min", "-5", "--v_max",
        "0", "--platform", "cpu"]


def test_clean_driver_run_records_no_crash_and_writes_no_dump(tmp_path):
    """The driver on the CPU with default storage flags (the host path):
    no contained crash, no lock violation, no flight dump anywhere under
    its log directory, and the ``ingest`` provider unregistered at
    close."""
    from d4pg_tpu_torch import train as ttrain

    ctr = tregistry.REGISTRY.counter("threads.contained_crashes")
    before = ctr.value
    tflight.RECORDER.reset()
    ttrain.main(TINY + ["--log_dir", str(tmp_path)])
    assert ctr.value == before
    kinds = {e["kind"] for e in tflight.RECORDER.events()}
    assert not kinds & {"thread_crash_contained", "lock_violation"}
    assert not list(tmp_path.rglob("flight_*.json"))
    assert "ingest" not in tregistry.REGISTRY.export()


def test_trace_sample_and_profile_dir_are_accepted_on_cpu(tmp_path,
                                                           monkeypatch):
    """``--trace_sample`` enables the recorder (in-process adds open no
    trace, so ``wire_to_grad_p95_ms`` is absent, as in the reference's
    in-process run); ``--profile_dir`` writes one profiler trace of the
    first cycle; the run's committed rows are counted in the registry."""
    from d4pg_tpu_torch import train as ttrain

    rec = ttrace.TraceRecorder()
    monkeypatch.setattr(ttrain, "trace_recorder", rec)
    rows = tregistry.REGISTRY.counter("ingest.rows_committed")
    rows0 = rows.value
    prof = tmp_path / "prof"
    result = ttrain.main(TINY + ["--log_dir", str(tmp_path / "runs"),
                                 "--trace_sample", "1.0",
                                 "--profile_dir", str(prof)])
    assert rec.enabled and rec.sample_rate == 1.0
    assert rec.span_table() == {}
    assert "wire_to_grad_p95_ms" not in result
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    assert rows.value - rows0 == result["env_steps"]
