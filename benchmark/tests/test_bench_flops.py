"""The operation and byte reckonings against counts made by hand."""

from __future__ import annotations

import torch

from bench_tiny import staged
from harness import spec


def test_humanoid_step_flops_by_hand():
    cfg = staged("humanoid-d4pg", "per.b32768").config
    f_a = 2 * (376 * 256 + 256 * 256 + 256 * 256 + 256 * 17)  # 463,360
    f_c = 2 * (376 * 256 + 273 * 256 + 256 * 256 + 256 * 51)  # 489,472
    critic_inputs = 2 * (256 * 256 + 256 * 256 + 256 * 51)
    to_action = 2 * (17 * 256 + 256 * 256 + 256 * 51)
    actor_inputs = 2 * (256 * 256 + 256 * 256 + 256 * 17)
    per_sample = 3 * f_a + 4 * f_c + critic_inputs + to_action + actor_inputs
    assert per_sample == 4_072_960
    mod = spec.plugin("flops", cfg["family"])
    assert mod.flops_per_step(cfg, 32_768) == 32_768 * 4_072_960


def test_pixel_step_flops_by_hand():
    cfg = spec.cell("cheetah-pixels.per.b512").config
    conv1 = 2 * 42 * 42 * 32 * 9 * 9
    conv = 2 * 42 * 42 * 32 * 9 * 32
    proj = 2 * 42 * 42 * 32 * 50
    enc = conv1 + 3 * conv + proj
    assert enc == 112_331_520
    h = 1024
    assert cfg["hidden"] == [h, h]
    f_a = 2 * (50 * h + h * h + h * 6)
    f_c = 2 * (50 * h + (h + 6) * h + h * 51)
    mlp = (3 * f_a + 4 * f_c + 2 * (h * h + h * 51)
           + 2 * (6 * h + h * 51) + 2 * (h * h + h * 6))
    assert mlp == 20_328_448
    mod = spec.plugin("flops", cfg["family"])
    assert mod.flops_per_step(cfg, 512) == 512 * (7 * enc - conv1 + mlp)


def test_kernel_bytes_by_hand():
    ce = spec.plugin("flops", "projection_ce")
    b, a = 32_768, 51
    # forward: p, q [B, A], r, d [B] in, td [B] out; backward: p, q, r, d,
    # the cotangent in, dq [B, A] out; four bytes each
    assert ce.bytes_per_step(b, a) == 4 * (2 * b * a + 3 * b) \
        + 4 * (3 * b * a + 3 * b)
    descent = spec.plugin("flops", "descent")
    # leaves 0 and 7 of 8: left children 2, 4, 8 and 2, 6, 14 on the way
    # down, five distinct; 8 bytes a query
    assert descent.bytes_per_query_set(torch.tensor([0, 7]), 8) == 4 * 5 + 16
