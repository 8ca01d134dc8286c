"""Color transforms (BT.601 RGB <-> YCbCr) over NCHW tensors in [0, 1]."""

from __future__ import annotations

import functools

import torch


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """NCHW RGB in [0,1] -> YCbCr in [0,1] (Cb/Cr offset by 0.5)."""
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 * (b - y) / (1.0 - 0.114) + 0.5
    cr = 0.5 * (r - y) / (1.0 - 0.299) + 0.5
    return torch.stack([y, cb, cr], dim=1)


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """NCHW YCbCr in [0,1] -> RGB in [0,1]."""
    y, cb, cr = x[:, 0], x[:, 1], x[:, 2]
    r = y + 2.0 * (1.0 - 0.299) * (cr - 0.5)
    b = y + 2.0 * (1.0 - 0.114) * (cb - 0.5)
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return torch.stack([r, g, b], dim=1)


# Per-channel mean shift applied before the codec: subtract 0.5 from Y only;
# Cb/Cr are already centred by the 0.5 offset above.
YCBCR_SHIFT = (0.5, 0.0, 0.0)


@functools.lru_cache(maxsize=16)
def _shift_constant(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(YCBCR_SHIFT, dtype=dtype, device=device).view(
        1, 3, 1, 1)


def _shift(like: torch.Tensor) -> torch.Tensor:
    """The shift as a (1, 3, 1, 1) constant on ``like``'s device, made once
    per dtype and device: a step captured in a CUDA graph may copy nothing
    from the host."""
    return _shift_constant(like.dtype, like.device)


def shift_ycbcr(y: torch.Tensor) -> torch.Tensor:
    return y - _shift(y)


def unshift_ycbcr(y: torch.Tensor) -> torch.Tensor:
    return y + _shift(y)
