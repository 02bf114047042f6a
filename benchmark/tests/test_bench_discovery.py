"""A cell, a traffic mix, a metric and a model family dropped into a
folder as files are found by their names, with no edit to the harness."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_tiny import BENCH
from harness import check, spec


def test_a_new_cell_is_found_and_runs(tmp_path):
    root = tmp_path / "checkout"
    (root / "benchmark").mkdir(parents=True)
    for sub in ("configs", "limits", "families"):
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


NEW_FAMILY = """
import json, sys, time
sys.path[:0] = [{tests!r}]
import torch
from bench_tiny import tiny
from harness import check, spec
cell = tiny("cheetah-copy.tmp.b512")
family = spec.family(cell.config)
runner = spec.plugin("runners", cell.traffic["runner"])
out = runner.run(cell, 2**31 + 5, 0.0, False, time.time(),
                 device=torch.device("cpu"))
ok, shown = check.verdict(out["numbers"], cell.limits)
flops = spec.plugin("flops", cell.config["family"]).flops_per_step(
    cell.config, int(cell.traffic["batch_size"]))
print("RESULT", json.dumps({{
    "family": family.__file__, "harness": spec.__file__, "correct": ok,
    "nonfinite": out["nonfinite"], "steps": out["steps"], "flops": flops,
    "checks": shown}}))
"""


def test_a_new_family_is_new_files_only(tmp_path):
    """A family that exists only as files dropped into a checkout (a copy
    of the pixel family's file and FLOP count under a new name), with a
    configuration, traffic, limits and ``BENCHMARK.json`` entries naming
    it, runs its tiny cell through the fused-learner runner on the CPU
    and comes out correct."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "out"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "d4pg_tpu_torch").symlink_to(BENCH.parent / "d4pg_tpu_torch")
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    for folder in ("families", "flops"):
        shutil.copy(bench / folder / "pixel_d4pg.py",
                    bench / folder / "pixel_d4pg_copy.py")
    cfg = json.loads((bench / "configs" / "cheetah-pixels-d4pg.json")
                     .read_text())
    (bench / "configs" / "cheetah-copy.json").write_text(
        json.dumps(dict(cfg, family="pixel_d4pg_copy")))
    shutil.copy(bench / "traffic" / "per.b512.json",
                bench / "traffic" / "tmp.b512.json")
    shutil.copy(bench / "limits" / "cheetah-pixels.per.b512.json",
                bench / "limits" / "cheetah-copy.tmp.b512.json")
    entries = json.loads((root / "BENCHMARK.json").read_text())
    entries["configs"].append({
        "name": "cheetah-copy", "source": "a paper",
        "file": "benchmark/configs/cheetah-copy.json", "reduced": [],
        "why": "a configuration of a family added as files"})
    entries["workloads"].append({
        "name": "cheetah-copy.tmp.b512", "config": "cheetah-copy",
        "traffic": "tmp.b512", "chips": 1, "why": "a cell added as files"})
    (root / "BENCHMARK.json").write_text(json.dumps(entries))
    # nothing the checkout held was edited
    assert all(p.read_bytes() == b for p, b in before.items())

    code = NEW_FAMILY.format(tests=str(bench / "tests"))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT")]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["family"] == str(bench / "families" / "pixel_d4pg_copy.py")
    assert res["harness"].startswith(str(bench))
    assert res["steps"] == 4 and res["nonfinite"] == 0 and res["flops"] > 0
    assert res["correct"], res["checks"]


def test_a_config_whose_family_has_no_file_is_refused(tmp_path):
    root = tmp_path / "checkout"
    (root / "benchmark").mkdir(parents=True)
    for sub in ("configs", "traffic", "limits", "families"):
        shutil.copytree(BENCH / sub, root / "benchmark" / sub)
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    conf = bench["configs"][0]
    cfg = json.loads((BENCH.parent / conf["file"]).read_text())
    (root / conf["file"]).write_text(json.dumps(dict(cfg,
                                                     family="no_such")))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    name = [w["name"] for w in bench["workloads"]
            if w["config"] == conf["name"]][0]
    with pytest.raises(SystemExit, match="family 'no_such', which has no"):
        spec.cell(name, root=root)


@pytest.mark.parametrize("values, limits", [
    ({"loss_gap": 0.0, "td_gap": 0.0}, {"loss_gap": 1e-3}),
    ({"loss_gap": 0.0}, {"loss_gap": 1e-3, "td_gap": 1e-3}),
])
def test_a_number_without_a_limit_is_an_error(values, limits):
    with pytest.raises(ValueError, match="without a limit"):
        check.verdict(values, limits)
