"""On the card: the control comes out not correct, and a sound run
correct, under each one-card cell's limits, at a batch a test can hold.

    python3 -m pytest benchmark/tests -m card

Each test looks for a card itself and skips without one. The readings at
each cell's own size come from ``calibrate.py`` (``PERF.md``)."""

from __future__ import annotations

import time

import pytest
import torch

import bench_tiny  # noqa: F401  (puts the harness on the path)
from harness import check, spec

SMALL = {"cheetah-pixels.per.b512": 128, "cheetah-pixels.uniform.b512": 128}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small(name):
    cell = spec.cell(name)
    cell.traffic = dict(cell.traffic, batch_size=SMALL[name])
    return cell


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_card_control_is_not_correct(card, name):
    cell = small(name)
    runner = spec.plugin("runners", cell.traffic["runner"])
    per = bool(cell.traffic["prioritized"])
    for seed in (9001, 9002, 9003):
        fake = runner.reference(cell, seed, card, lower=True)
        ref = runner.reference(cell, seed, card, fake["idx"])
        ok, shown = check.verdict(check.numbers(fake, ref, per), cell.limits)
        assert not ok, shown


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_card_sound_run_is_correct(card, name):
    cell = small(name)
    runner = spec.plugin("runners", cell.traffic["runner"])
    out = runner.run(cell, 9004, 1.0, True, time.time(), device=card)
    ok, shown = check.verdict(out["numbers"], cell.limits)
    assert ok and out["nonfinite"] == 0, shown
    assert out["trace"].busy_s > 0 and out["trace"].launches > 0
