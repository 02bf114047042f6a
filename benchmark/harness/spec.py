"""Find a cell, its configuration, its traffic and its metrics by name.

Everything that belongs to one configuration, traffic mix, metric or
runner is a file of its own, found by the name ``BENCHMARK.json`` gives
it, so a new cell or metric is new files and entries, never an edit:

  - ``BENCHMARK.json`` at the checkout's root: the cells, configurations
    (``file`` is the configuration's JSON) and metrics;
  - ``traffic/<traffic>.json``: a cell's traffic (batch, chunk length,
    replay, ranks, ring fill, the row distribution) and its ``runner``;
  - ``runners/<runner>.py``: ``run(cell) -> result`` drives the program;
  - ``metrics/<metric>.py``: ``read(ctx) -> float | None`` reads one
    metric from what a run measured (``None``: nothing to read);
  - ``families/<family>.py``: all that depends on a configuration's
    model family (its ``family`` key): the program's config and networks,
    the losses both sides report, the initial weights' layout and ties,
    the ring's observations, the update's own draws and how the reference
    applies them, the reference's grad step, and the tiny shrink of the
    CPU tests (the interface: ``families/mlp_d4pg.py``); a configuration
    whose family has no file is refused;
  - ``flops/<family or kernel>.py``: the operations and bytes of a model
    family's grad step and of a kernel;
  - ``limits/<cell>.json``: the limit of each number the cell compares;
    a cell without one is refused.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / bench["paths"][0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    limits_path = here / "limits" / f"{name}.json"
    if not limits_path.exists():
        raise SystemExit(f"no limits file {limits_path}: a cell compares "
                         f"every number it reads against its limit")
    config = load_json(root / conf["file"])
    family_path = here / "families" / f"{config.get('family')}.py"
    if not family_path.exists():
        raise SystemExit(f"configuration {conf['name']!r} is of family "
                         f"{config.get('family')!r}, which has no file "
                         f"{family_path}: the harness takes all that "
                         f"depends on a model family from its file")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=load_json(limits_path))


def plugin(folder: str, name: str, root: Path = BENCH):
    """The module ``root/folder/name.py`` (names may hold dots)."""
    path = root / folder / f"{name}.py"
    key = f"_bench_{folder}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise SystemExit(f"no {folder} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict):
    """The module of the configuration's family,
    ``families/<family>.py``."""
    return plugin("families", cfg["family"])
