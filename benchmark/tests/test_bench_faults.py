"""A run with the timed path broken underneath comes out not correct.

Each cell runs at a tiny size on the CPU through the harness's own
runner (everything but the look for a card) and is judged by the cell's
own limits: a sound program passes, and each fault the cell can have
fails it: a step that returns the state unchanged, half of the batch
left out of the loss, a slot moved where the sampler produces it, and
(several ranks) the gradient exchange between ranks left out. The
two-rank path, which no cell of ``BENCHMARK.json`` holds yet, is staged
from its configuration and traffic files."""

from __future__ import annotations

import json
import time

import pytest
import torch

from bench_tiny import BENCH, staged, tiny
from harness import check, spec

CELLS = [w["name"] for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


def outcome(cell, prepare: str | None = None) -> dict:
    runner = spec.plugin("runners", cell.traffic["runner"])
    return runner.run(cell, 17, 0.0, False, time.time(),
                      device=torch.device("cpu"), prepare=prepare)


def run(name: str, prepare: str | None = None) -> bool:
    cell = tiny(name)
    out = outcome(cell, prepare)
    ok, _ = check.verdict(out["numbers"], cell.limits)
    return ok and out["nonfinite"] == 0


def unchanged() -> None:
    """Every update leaves the state as it found it: every network and
    optimizer of the state restored after the step."""
    import copy

    from d4pg_tpu_torch.learner import fused

    real = fused.update_step

    def step(config, state, batch, w=None, draws=None, grad_reduce=None):
        nets = {n: v for n, v in vars(state).items()
                if isinstance(v, torch.nn.Module)}
        opts = {n: v for n, v in vars(state).items()
                if isinstance(v, torch.optim.Optimizer)}
        saved = {n: copy.deepcopy(v.state_dict()) for n, v in nets.items()}
        saved_opts = {n: copy.deepcopy(v.state_dict())
                      for n, v in opts.items()}
        metrics = real(config, state, batch, w, draws, grad_reduce)
        for n, module in nets.items():
            module.load_state_dict(saved[n])
        for n, opt in opts.items():
            opt.load_state_dict(saved_opts[n])
            opt.state.clear()
        state.step -= 1
        return metrics

    fused.update_step = step


def half_batch() -> None:
    """The critic loss is the mean over the first half of the rows."""
    from d4pg_tpu_torch.learner import fused

    real = fused.update_step

    def step(config, state, batch, w=None, draws=None, grad_reduce=None):
        n = batch.obs.shape[0]
        mask = torch.zeros(n, device=batch.obs.device)
        mask[:n // 2] = 2.0
        return real(config, state, batch, mask if w is None else w * mask,
                    draws, grad_reduce)

    fused.update_step = step


def slot_shift() -> None:
    """The sampler's every slot moved to the next leaf."""
    from d4pg_tpu_torch.replay import device_per

    real = device_per.descend

    def descend(tree, mass):
        cap = tree.shape[0] // 2
        return torch.clamp(real(tree, mass) + 1, max=cap - 1)

    device_per.descend = descend


def no_exchange() -> None:
    """Each rank steps on its own gradients."""
    from d4pg_tpu_torch.learner import fused

    fused.grad_reducer = lambda mesh: None


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "slot_shift": slot_shift, "no_exchange": no_exchange}


def _cases():
    out = []
    for name in CELLS:
        traffic = spec.cell(name).traffic
        for fault in FAULTS:
            if (fault == "slot_shift" and not traffic["prioritized"]) or \
                    (fault == "no_exchange" and traffic["ranks"] == 1):
                continue
            out.append((name, fault))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_program_is_correct(name):
    assert run(name)


@pytest.mark.parametrize("name,fault", _cases())
def test_a_broken_program_is_not_correct(name, fault, monkeypatch):
    if spec.cell(name).traffic["ranks"] > 1:
        # the ranks are processes of their own: they break themselves
        assert not run(name, prepare=f"test_bench_faults:{fault}")
        return
    from d4pg_tpu_torch.learner import fused
    from d4pg_tpu_torch.replay import device_per

    monkeypatch.setattr(fused, "update_step", fused.update_step)
    monkeypatch.setattr(fused, "grad_reducer", fused.grad_reducer)
    monkeypatch.setattr(device_per, "descend", device_per.descend)
    FAULTS[fault]()
    assert not run(name)


def test_the_two_rank_path_exchanges_gradients():
    cell = tiny(staged("humanoid-d4pg-dp4", "per.b32768x4"))
    sound = outcome(cell)
    broken = outcome(cell, prepare="test_bench_faults:no_exchange")
    assert sound["numbers"]["replica_gap"] == 0.0
    assert sound["numbers"]["loss_gap"] < 1e-4
    assert broken["numbers"]["replica_gap"] > 1e-4
