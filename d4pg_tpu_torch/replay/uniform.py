"""Transition batches.

Counterpart of ``d4pg_tpu/replay/uniform.py``'s ``TransitionBatch``; the
host ring buffer around it is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TransitionBatch(NamedTuple):
    """A batch of (possibly n-step-folded) transitions."""

    obs: torch.Tensor  # [B, obs_dim] float32
    action: torch.Tensor  # [B, act_dim] float32
    reward: torch.Tensor  # [B] float32 (n-step folded return)
    next_obs: torch.Tensor  # [B, obs_dim] float32 (s_{t+n})
    done: torch.Tensor  # [B] float32
    discount: torch.Tensor  # [B] float32 = gamma^m * (1 - done)
