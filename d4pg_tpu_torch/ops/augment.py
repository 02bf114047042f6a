"""DrQ random shift and CURL random crop of pixel batches.

Counterpart of ``d4pg_tpu/ops/augment.py::random_shift``: each sample of
a [B, H, W, C] batch is edge-padded by ``pad`` pixels on both spatial
axes and cropped back to [H, W] at an offset in ``[0, 2 * pad]^2``, a
shift of up to ``pad`` pixels with edge-replicated fill. The dtype is
kept (uint8 in, uint8 out), so the replay ring and the host-to-device
path carry raw frames.

The pad and crop are one gather: padded row ``o + h`` is source row
``clamp(o + h - pad, 0, H - 1)``, so output pixel (h, w) of a sample at
offsets (oy, ox) reads its row ``clamp(oy + h - pad)`` and column
``clamp(ox + w - pad)``. It runs as plain tensor ops on every device
(the reference computes it with ``lax`` pad and ``dynamic_slice``,
outside any Pallas kernel).

Offsets: the reference draws each sample's from ``fold_in(key, i)``, a
stream torch cannot reproduce; ``random_shift`` takes them injected
(``offsets`` [B, 2], row then column) or draws them from ``generator``.

``random_crop`` is CURL's (``curl_sac.py``'s ``utils.random_crop``): each
sample of a [B, H, W, C] batch is cut to [size, size] at its own offset
in ``[0, H - size] x [0, W - size]``, injected or drawn from
``generator`` as one [B, 2] ``randint``, and gathered as the shift is,
so uint8 frames come out bitwise. CURL's numpy draw takes the offset
from ``[0, H - size)``, one short of the last window; here every window
can be drawn. ``center_crop`` is CURL's ``center_crop_image``, the
crop its actor takes of the stored frame: ``(H - size) // 2`` from the
top and ``(W - size) // 2`` from the left, on [..., H, W, C].
"""

from __future__ import annotations

import torch


def random_shift(imgs: torch.Tensor, pad: int = 4,
                 generator: torch.Generator | None = None, *,
                 offsets: torch.Tensor | None = None) -> torch.Tensor:
    """The shifted [B, H, W, C] batch (see the module docstring)."""
    if imgs.dim() != 4:
        raise ValueError(f"random_shift expects [B, H, W, C], got "
                         f"{tuple(imgs.shape)}")
    if pad < 1:
        return imgs
    b, h, w, _ = imgs.shape
    dev = imgs.device
    if offsets is None:
        if generator is None:
            raise ValueError("random_shift needs a generator or injected "
                             "offsets")
        offsets = torch.randint(0, 2 * pad + 1, (b, 2), generator=generator,
                                device=dev)
    elif tuple(offsets.shape) != (b, 2):
        raise ValueError(f"offsets must be [{b}, 2], got "
                         f"{tuple(offsets.shape)}")
    offsets = offsets.to(device=dev, dtype=torch.long)
    rows = (torch.arange(h, device=dev) + offsets[:, :1] - pad).clamp_(0,
                                                                       h - 1)
    cols = (torch.arange(w, device=dev) + offsets[:, 1:] - pad).clamp_(0,
                                                                       w - 1)
    batch = torch.arange(b, device=dev)[:, None, None]
    return imgs[batch, rows[:, :, None], cols[:, None, :]]


def random_crop(imgs: torch.Tensor, size: int,
                generator: torch.Generator | None = None, *,
                offsets: torch.Tensor | None = None) -> torch.Tensor:
    """The [B, size, size, C] crops of the [B, H, W, C] batch (see the
    module docstring)."""
    if imgs.dim() != 4:
        raise ValueError(f"random_crop expects [B, H, W, C], got "
                         f"{tuple(imgs.shape)}")
    b, h, w, _ = imgs.shape
    if not 0 < size <= min(h, w):
        raise ValueError(f"crop size {size} does not fit {h}x{w} frames")
    dev = imgs.device
    if offsets is None:
        if generator is None:
            raise ValueError("random_crop needs a generator or injected "
                             "offsets")
        # one bound for both axes: CURL's frames are square
        offsets = torch.randint(0, min(h, w) - size + 1, (b, 2),
                                generator=generator, device=dev)
    elif tuple(offsets.shape) != (b, 2):
        raise ValueError(f"offsets must be [{b}, 2], got "
                         f"{tuple(offsets.shape)}")
    offsets = offsets.to(device=dev, dtype=torch.long)
    span = torch.arange(size, device=dev)
    rows = offsets[:, :1] + span
    cols = offsets[:, 1:] + span
    batch = torch.arange(b, device=dev)[:, None, None]
    return imgs[batch, rows[:, :, None], cols[:, None, :]]


def center_crop(imgs: torch.Tensor, size: int) -> torch.Tensor:
    """The centered [..., size, size, C] crop of [..., H, W, C] frames."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    if not 0 < size <= min(h, w):
        raise ValueError(f"crop size {size} does not fit {h}x{w} frames")
    top, left = (h - size) // 2, (w - size) // 2
    return imgs[..., top:top + size, left:left + size, :]
