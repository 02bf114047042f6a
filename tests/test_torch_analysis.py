"""The port's analysis layer: the reference's ``tests/test_analysis.py``
cases on ``d4pg_tpu_torch.analysis`` (EWMA math, run logger persistence,
the plots), then each piece against the reference's on the same inputs:
``ewma`` bitwise, the logger's JSONL lines, ``fleet_table``'s and
``shard_table``'s text."""

import json
import os

import numpy as np
import pytest

from d4pg_tpu import analysis as janalysis
from d4pg_tpu_torch.analysis import (
    RunLogger,
    ewma,
    load_returns_csv,
    plot_runs,
)

pytestmark = pytest.mark.torchport


def test_ewma_constant_series():
    x = np.full(10, 3.0)
    np.testing.assert_allclose(ewma(x), x, rtol=1e-12)


def test_ewma_matches_reference_formulation():
    """Bias-corrected EWMA equals the reference's scaling-matrix form
    (plots/plots.py:8-21): y_t = sum_k a^(t-k) (1-a) x_k / (1 - a^(t+1))."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(50)
    a = 0.95
    t = np.arange(50)
    ref = np.array([
        np.sum(a ** (ti - t[: ti + 1]) * (1 - a) * x[: ti + 1]) / (1 - a ** (ti + 1))
        for ti in t
    ])
    np.testing.assert_allclose(ewma(x, a), ref, rtol=1e-10)


def test_ewma_empty():
    assert ewma(np.array([])).shape == (0,)


def test_run_logger_roundtrip(tmp_path):
    path = str(tmp_path / "log.jsonl")
    log = RunLogger(path, "runA")
    log.log("return", 1, -10.0)
    log.log("return", 2, -5.0)
    log.log("loss", 1, 3.0)
    log.close()
    log2 = RunLogger(path, "runB")  # append-only: same file, second run
    log2.log("return", 1, -20.0)
    log2.close()
    runs = RunLogger.load(path)
    assert runs["runA"]["return"] == [(1, -10.0), (2, -5.0)]
    assert runs["runA"]["loss"] == [(1, 3.0)]
    assert runs["runB"]["return"] == [(1, -20.0)]


def test_run_logger_is_a_metrics_bus_sink(tmp_path):
    from d4pg_tpu_torch.io.metrics import MetricsBus

    path = str(tmp_path / "bus.jsonl")
    bus = MetricsBus([RunLogger(path, "runA")])
    bus.log(0, {"avg_test_reward": -120.0, "critic_loss": 1.5})
    bus.log(5, {"avg_test_reward": -80.0})
    bus.close()
    assert bus.sink_failures == 0
    assert RunLogger.load(path) == {"runA": {
        "avg_test_reward": [(0, -120.0), (5, -80.0)],
        "critic_loss": [(0, 1.5)]}}


def test_load_returns_csv_skips_malformed(tmp_path):
    p = tmp_path / "returns.csv"
    p.write_text("step,avg\n1,-10.5\nbad,row\n2,-9.0\n")
    steps, rets = load_returns_csv(str(p))
    np.testing.assert_array_equal(steps, [1, 2])
    np.testing.assert_array_equal(rets, [-10.5, -9.0])


def test_plot_runs_writes_png(tmp_path):
    out = str(tmp_path / "out.png")
    steps = np.arange(20)
    path = plot_runs(
        {"a": (steps, -100 + steps.astype(float)),
         "b": (steps, -120 + 2 * steps.astype(float))},
        out_path=out,
    )
    assert os.path.exists(path) and os.path.getsize(path) > 1000


# ------------------------------------------------ against the reference --

def test_ewma_is_the_reference_ewma():
    rng = np.random.default_rng(3)
    for n, a in ((0, 0.95), (1, 0.5), (200, 0.95), (1000, 0.99)):
        x = rng.standard_normal(n)
        assert ewma(x, a).tobytes() == janalysis.ewma(x, a).tobytes()


def test_logger_lines_are_the_reference_lines(tmp_path, monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1234.5)
    paths = {}
    for name, cls in (("port", RunLogger), ("ref", janalysis.RunLogger)):
        paths[name] = str(tmp_path / name / "log.jsonl")
        log = cls(paths[name], "runA")
        log.log("return", 1, -10.0)
        log.log("loss", 2, np.float32(3.25))
        log.close()
    with open(paths["port"]) as f, open(paths["ref"]) as g:
        assert f.read() == g.read()
    assert RunLogger.load(paths["port"]) == janalysis.RunLogger.load(
        paths["ref"])


def _artifact():
    """A sweep artifact as ``fleet.sweep`` writes one (two N rows and a
    shard block, a missing latency percentile and a missing recovery)."""
    def row(n, rate, p50, p99, rec):
        return {"n_actors": n, "rows_per_sec": rate,
                "demand_rows_per_sec": 20.0 * n,
                "send_latency_ms": {"p50": p50, "p99": p99},
                "drops": {"chaos_rows": 3 * n, "backpressure_rows": n,
                          "shed_rows": n // 2},
                "retries": n + 1, "crashes": n // 4, "readmissions": 1,
                "recovery": {"mean_s": rec}, "ingest_shards": 1 + n // 64,
                "codec": "npz" if n < 64 else "raw", "deadlocks": 0}

    sweep = [row(8, 160.4, 0.51, 2.25, None), row(64, 1270.9, 0.7, None,
                                                   4.21)]
    return {"sweep": sweep, "shard_sweep": {
        "n_actors": 64, "offered_rows_per_sec": 1280.0,
        "single_core_ceiling_rows_per_sec": 5200.0, "sweep": sweep,
        "scaling": [
            {"rows_per_sec_per_shard": 160.4, "speedup_vs_k1": 1.0,
             "efficiency": 1.0, "vs_ceiling": 0.03},
            {"rows_per_sec_per_shard": 635.5, "speedup_vs_k1": None,
             "efficiency": None, "vs_ceiling": 0.24}]}}


def test_fleet_table_text_is_the_reference_text():
    from d4pg_tpu.analysis.actor_scaling import fleet_table as jtable
    from d4pg_tpu.analysis.actor_scaling import shard_table as jshard
    from d4pg_tpu_torch.analysis.actor_scaling import (
        fleet_table,
        shard_table,
    )

    art = _artifact()
    assert fleet_table(art) == jtable(art)
    assert shard_table(art["shard_sweep"]) == jshard(art["shard_sweep"])
    assert "rows/s" in fleet_table(art)
