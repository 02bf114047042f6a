"""The numbers that decide ``correct`` stay the same to the last bit: the
check's numbers of the tiny CPU cells of both families, for seeds 0-2,
against ``golden_numbers.json``. There the program's and the reference's
outputs came from the harness with its family code still inline in the
generic modules, and ``harness/check.py`` made the numbers of them (one
intra-op thread, PyTorch 2.13 on an x86-64 CPU)."""

from __future__ import annotations

import json
import time

import pytest
import torch

from bench_tiny import BENCH, staged, tiny
from harness import spec

GOLDEN = json.loads((BENCH / "tests" / "golden_numbers.json").read_text())
CELLS = {
    "cheetah-pixels.per.b512": lambda: tiny("cheetah-pixels.per.b512"),
    "cheetah-pixels.uniform.b512": lambda: tiny("cheetah-pixels.uniform.b512"),
    "humanoid-d4pg.per.b32768":
        lambda: tiny(staged("humanoid-d4pg", "per.b32768")),
}


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name,seed", [(n, s) for n in sorted(GOLDEN)
                                       for s in sorted(GOLDEN[n])])
def test_numbers_are_the_recorded_ones(name, seed, one_thread):
    cell = CELLS[name]()
    runner = spec.plugin("runners", cell.traffic["runner"])
    out = runner.run(cell, int(seed), 0.0, False, time.time(),
                     device=torch.device("cpu"))
    assert out["numbers"] == GOLDEN[name][seed]
