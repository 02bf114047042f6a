"""``BENCHMARK.json`` against the rules a benchmark file keeps, and every
name it holds against the files the harness finds by it."""

from __future__ import annotations

import json
import re

import pytest

from bench_tiny import BENCH
from harness import spec

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_token|channels)")


@pytest.fixture(scope="module")
def bench() -> dict:
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def test_keys_command_and_paths(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["command"]) <= 32
    assert bench["command"][1].startswith("benchmark/")
    assert all(TEXT.match(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_texts(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert TEXT.match(entry[key]), (entry["name"], key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            if "better" in entry:
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        seen = [n for g, n in names if g == group]
        assert len(seen) == len(set(seen))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_metrics_moves_and_cells_agree(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer, w["name"]
    layers: dict[str, str] = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], m["layer"])


def test_four_chip_share_and_check_budget(bench):
    cells = bench["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_name_has_its_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "flops" / f"{cfg['family']}.py").exists()
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert (BENCH / "runners" / f"{cell.traffic['runner']}.py").exists()
        assert cell.limits, f"{w['name']} has no limits"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or "out" in p.relative_to(BENCH).parts:
            continue
        assert PATH.match(str(p.relative_to(ROOT))), p
