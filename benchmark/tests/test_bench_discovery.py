"""A cell, a traffic mix and a metric dropped into a folder as files are
found by their names, with no edit to the harness."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from bench_tiny import BENCH
from harness import check, spec


def test_a_new_cell_is_found_and_runs(tmp_path):
    root = tmp_path / "checkout"
    (root / "benchmark").mkdir(parents=True)
    for sub in ("configs", "limits"):
        shutil.copytree(BENCH / sub, root / "benchmark" / sub)
    (root / "benchmark" / "traffic").mkdir()
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "humanoid-d4pg", "source": "a paper",
        "file": "benchmark/configs/humanoid-d4pg.json", "reduced": [],
        "why": "a configuration added as a file"})
    bench["workloads"].append({
        "name": "humanoid.tmp.b32", "config": "humanoid-d4pg",
        "traffic": "tmp.b32", "chips": 1, "why": "a cell added as files"})
    bench["per_layer"].append({
        "name": "tmp_metric", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "device",
        "moves": "grad_steps_per_s", "workloads": ["humanoid.tmp.b32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "traffic" / "tmp.b32.json").write_text(json.dumps({
        "runner": "fused_learner", "batch_size": 32, "k": 4,
        "prioritized": True, "ranks": 1, "fill_rows": 1000,
        "fill_block": 256, "reward": [0.0, 15.0], "done_share": 0.01,
        "trace_chunks": 1}))
    (root / "benchmark" / "limits" / "humanoid.tmp.b32.json").write_text(
        json.dumps({"loss_gap": 1e-3}))
    (root / "benchmark" / "metrics").mkdir()
    (root / "benchmark" / "metrics" / "tmp_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")

    cell = spec.cell("humanoid.tmp.b32", root=root)
    assert cell.traffic["batch_size"] == 32
    assert cell.limits == {"loss_gap": 1e-3}
    assert [m["name"] for m in cell.per_layer].count("tmp_metric") == 1
    reader = spec.plugin("metrics", "tmp_metric", root=root / "benchmark")
    assert reader.read(None) == 42.0

    cell.config = dict(cell.config, obs_dim=12, act_dim=3,
                       hidden=[16, 16, 16])
    runner = spec.plugin("runners", cell.traffic["runner"])
    out = runner.run(cell, 3, 0.0, False, time.time(),
                     device=torch.device("cpu"))
    assert out["steps"] == 4 and out["numbers"]["loss_gap"] < 1e-3


def test_a_cell_without_limits_is_refused(tmp_path):
    root = tmp_path / "checkout"
    (root / "benchmark").mkdir(parents=True)
    for sub in ("configs", "traffic"):
        shutil.copytree(BENCH / sub, root / "benchmark" / sub)
    (root / "benchmark" / "limits").mkdir()
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    name = json.loads((root / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]
    with pytest.raises(SystemExit, match="no limits file"):
        spec.cell(name, root=root)


@pytest.mark.parametrize("values, limits", [
    ({"loss_gap": 0.0, "td_gap": 0.0}, {"loss_gap": 1e-3}),
    ({"loss_gap": 0.0}, {"loss_gap": 1e-3, "td_gap": 1e-3}),
])
def test_a_number_without_a_limit_is_an_error(values, limits):
    with pytest.raises(ValueError, match="without a limit"):
        check.verdict(values, limits)
