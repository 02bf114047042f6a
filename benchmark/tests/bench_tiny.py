"""Tiny cells for the CPU tests: a cell of ``BENCHMARK.json``, or one
staged from a configuration's and a traffic mix's files alone, with its
widths, ring and batch shrunk so that a run takes a second on the CPU."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402


def staged(config: str, traffic: str, name: str = "staged"):
    """A cell of ``configs/<config>.json`` under ``traffic/<traffic>.json``
    that ``BENCHMARK.json`` does not hold (yet), with no limits."""
    tr = spec.load_json(BENCH / "traffic" / f"{traffic}.json")
    return spec.Cell(name=name, chips=int(tr.get("ranks", 1)),
                     config=spec.load_json(BENCH / "configs" / f"{config}.json"),
                     traffic=tr, end_to_end=[], per_layer=[], limits={})


def tiny(name_or_cell):
    """The cell with its family's tiny shrink (``tiny`` of
    ``families/<family>.py``) and at most two ranks."""
    cell = (spec.cell(name_or_cell) if isinstance(name_or_cell, str)
            else name_or_cell)
    cfg, tr = dict(cell.config), dict(cell.traffic)
    spec.family(cfg).tiny(cfg, tr)
    if int(tr.get("ranks", 1)) > 1:
        tr["ranks"] = 2
    cell.config, cell.traffic = cfg, tr
    return cell
