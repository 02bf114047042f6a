"""The DrQ shift, in plain PyTorch."""

from __future__ import annotations

import torch


def shift(frames: torch.Tensor, pad: int, offsets: torch.Tensor):
    """[B, H, W, C] frames moved by ``offsets`` [B, 2] (row, column) in
    [0, 2 pad], with edge-replicated fill: the frame edge-padded by
    ``pad`` and cropped back at the offset."""
    b, h, w, _ = frames.shape
    dev = frames.device
    off = offsets.to(device=dev, dtype=torch.long)
    rows = (torch.arange(h, device=dev) + off[:, :1] - pad).clamp(0, h - 1)
    cols = (torch.arange(w, device=dev) + off[:, 1:] - pad).clamp(0, w - 1)
    return frames[torch.arange(b, device=dev)[:, None, None],
                  rows[:, :, None], cols[:, None, :]]
