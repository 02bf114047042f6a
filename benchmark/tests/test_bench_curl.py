"""The CURL cell (``cheetah-curl.uniform.b512``, family ``curl_d4pg``): its
tiny run is correct on the CPU, its family gives the interface and its
reference matches the program's pieces, planted faults of the
contrastive step read not correct, its FLOPs are the ones counted by
hand, and, on the card, the TF32 control fails and a sound run passes at
a batch a test can hold.

    python3 -m pytest benchmark/tests/test_bench_curl.py
    python3 -m pytest benchmark/tests/test_bench_curl.py -m card   # card
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from bench_tiny import tiny
from harness import check, inputs, program, spec
from reference import curl

NAME = "cheetah-curl.uniform.b512"
SMALL_BATCH = 128  # the card tests' batch, as test_bench_card.py's cells


def run(cell) -> tuple[bool, dict]:
    runner = spec.plugin("runners", cell.traffic["runner"])
    out = runner.run(cell, 23, 0.0, False, time.time(),
                     device=torch.device("cpu"))
    ok, shown = check.verdict(out["numbers"], cell.limits)
    return ok and out["nonfinite"] == 0, shown


def test_the_tiny_cell_is_correct():
    ok, shown = run(tiny(NAME))
    assert ok, shown


def test_the_family_gives_the_interface_over_four_networks():
    from d4pg_tpu_torch.learner.state import init_state

    cell = tiny(NAME)
    cfg = cell.config
    family = spec.family(cfg)
    assert family.LOSSES == ("critic_loss", "actor_loss", "curl_loss")
    params = inputs.make_params(cfg, 3, torch.device("cpu"))
    state = init_state(family.program_config(cfg), 0, "cpu")
    nets = family.program_nets(state)
    assert list(nets) == ["actor", "critic", "encoder", "curl"]
    assert [t is None for _, t, _ in nets.values()] == [False, False, True,
                                                         True]
    opts = [o for _, _, o in nets.values()]
    assert len({id(o) for o in opts}) == 4  # every Adam compared
    program.load_params(nets, params)
    # the shared leaves are one set of tensors in the program
    assert nets["curl"][0].encoder is state.critic.encoder
    for k, v in state.critic.encoder.state_dict().items():
        assert torch.equal(v, params["critic"]["encoder." + k])
        assert torch.equal(v, params["curl"]["encoder." + k])
    ref = family.Learner(cfg, params)
    assert list(ref.p) == list(params)
    assert ref.p["encoder"]["conv1.weight"] is \
        ref.p["critic"]["encoder.conv1.weight"]


def test_the_reference_matches_the_programs_pieces():
    from d4pg_tpu_torch.learner.state import init_state
    from d4pg_tpu_torch.ops.augment import random_crop

    cell = tiny(NAME)
    cfg = cell.config
    family = spec.family(cfg)
    dev = torch.device("cpu")
    params = inputs.make_params(cfg, 11, dev)
    state = init_state(family.program_config(cfg), 0, "cpu")
    program.load_params(family.program_nets(state), params)
    rows = inputs.rows_block(cfg, cell.traffic, 11, 0, 0, 8, dev)
    drawn = family.draws(cfg, cell.traffic, inputs.generator(dev, 11,
                                                             "state"),
                         dev, 1)
    prepared = family.apply_draws(cfg, dict(rows), drawn, 0, slice(0, 8))
    # the program's generator draws the same crops in the same order
    gen = inputs.generator(dev, 11, "state")
    size = int(cfg["crop_size"])
    for field, src in (("obs", "obs"), ("next_obs", "next_obs"),
                       ("pos", "obs")):
        assert torch.equal(random_crop(rows[src], size, gen),
                           prepared[field]), field
    ref = family.Learner(cfg, params)
    obs = prepared["obs"]
    with torch.no_grad():
        # the program's actor takes the stored frames and center-crops
        torch.testing.assert_close(
            ref.actor(params["actor"], rows["obs"][:, 2:2 + size,
                                                   2:2 + size]),
            state.actor(rows["obs"]))
        torch.testing.assert_close(
            ref.critic(params["critic"], obs, rows["action"]),
            state.critic(obs, rows["action"]))
        z = curl.trunk(params["critic"], ref._convs(params["critic"], obs))
        torch.testing.assert_close(z, state.critic.encoder(obs))
    res = ref.step([prepared])
    assert sorted(res["losses"]) == sorted(family.LOSSES)


def _skip_curl_adam(monkeypatch):
    """The contrastive step without ``curl_opt``'s step: ``W`` never
    moves and the encoder takes one Adam step of the two."""
    from d4pg_tpu_torch.learner import update

    real = update._contrastive_step

    def step(state, anchor, pos):
        monkeypatch.setattr(state.curl_opt, "step", lambda: None)
        return real(state, anchor, pos)

    monkeypatch.setattr(update, "_contrastive_step", step)


def _key_at_heads_tau(monkeypatch):
    """The momentum key encoder soft-updated at the heads' tau, 0.01."""
    family = spec.family(tiny(NAME).config)
    real = family.program_config

    def config(cfg):
        out = real(cfg)
        return dataclasses.replace(out, encoder_tau=out.tau)

    monkeypatch.setattr(family, "program_config", config)


@pytest.mark.parametrize("fault", [_skip_curl_adam, _key_at_heads_tau])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    ok, shown = run(tiny(NAME))
    assert not ok, shown


def test_step_flops_by_hand():
    cfg = spec.cell(NAME).config
    conv1 = 2 * 41 * 41 * 32 * 9 * 9
    convs = 2 * 32 * 9 * 32 * (39 * 39 + 37 * 37 + 35 * 35)
    proj = 2 * 35 * 35 * 32 * 50
    enc = conv1 + convs + proj
    assert enc == 88_481_984
    h = 1024
    f_a = 2 * (50 * h + h * h + h * 6)
    f_c = 2 * (50 * h + (h + 6) * h + h * 51)
    mlp = (3 * f_a + 4 * f_c + 2 * (h * h + h * 51)
           + 2 * (6 * h + h * 51) + 2 * (h * h + h * 6))
    b, latent = 512, 50
    logits = (2 * latent * latent * b + 2 * b * b * latent  # forward
              + 2 * latent * latent * b + 4 * b * b * latent)  # backward
    want = b * (11 * enc - 2 * conv1 + proj + mlp) + logits
    mod = spec.plugin("flops", cfg["family"])
    assert mod.flops_per_step(cfg, b) == want


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _small():
    cell = spec.cell(NAME)
    cell.traffic = dict(cell.traffic, batch_size=SMALL_BATCH)
    return cell


@pytest.mark.card
def test_card_control_is_not_correct(card):
    cell = _small()
    runner = spec.plugin("runners", cell.traffic["runner"])
    for seed in (9001, 9002, 9003):
        fake = runner.reference(cell, seed, card, lower=True)
        ref = runner.reference(cell, seed, card, fake["idx"])
        ok, shown = check.verdict(check.numbers(fake, ref, False),
                                  cell.limits)
        assert not ok, shown


@pytest.mark.card
def test_card_sound_run_is_correct(card):
    cell = _small()
    runner = spec.plugin("runners", cell.traffic["runner"])
    out = runner.run(cell, 9004, 1.0, True, time.time(), device=card)
    ok, shown = check.verdict(out["numbers"], cell.limits)
    assert ok and out["nonfinite"] == 0, shown
    assert out["trace"].busy_s > 0 and out["trace"].launches > 0
