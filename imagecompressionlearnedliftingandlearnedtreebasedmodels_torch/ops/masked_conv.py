"""PixelCNN-style causally masked convolutions (types A and B), NCHW.

The mask multiplies the weight at call time, so the stored weight keeps
the flax kernel's values (masked taps included) and carries across raw.
With a compute dtype a grouped masked conv takes the JAX package's rule:
on planes of 4096 pixels or more (outside ``fast_conv.disable_pallas``)
the T-tap batched product ``fast_conv.grouped_conv_taps`` (fp32 sums and
output), otherwise ``nn.Conv``'s bf16 rounding.
Position (i, j) of a (kh, kw) kernel is visible when ``i < kh//2`` or
(``i == kh//2`` and ``j < kw//2``); type B also sees the centre.

:class:`ChannelIncrementalConv2d` masks channels instead of positions:
output channel block i sees input channel blocks before i (type A), and
block i itself too (type B).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .fast_conv import Conv2d, grouped_conv_taps, large_plane


def causal_mask(kernel_size: Tuple[int, int], mask_type: str) -> np.ndarray:
    """(kh, kw) 0/1 mask; type 'A' excludes the center, 'B' includes it."""
    if mask_type not in ("A", "B"):
        raise ValueError(f"mask_type must be 'A' or 'B', got {mask_type!r}")
    kh, kw = kernel_size
    mask = np.zeros((kh, kw), dtype=np.float32)
    ch, cw = kh // 2, kw // 2
    mask[:ch, :] = 1.0
    mask[ch, :cw] = 1.0
    if mask_type == "B":
        mask[ch, cw] = 1.0
    return mask


class MaskedConv2d(Conv2d):
    """Causal grouped SAME conv. ``groups`` keeps the subband channels'
    contexts apart, as the JAX package's ``feature_group_count``."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 mask_type: str = "A", groups: int = 1, dtype=None):
        super().__init__(cin, cout, kernel_size, groups=groups, dtype=dtype)
        mask = causal_mask((kernel_size, kernel_size), mask_type)
        self.register_buffer("mask", torch.from_numpy(mask)[None, None],
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight * self.mask
        if self.dtype is not None and self.groups > 1 and large_plane(x):
            return grouped_conv_taps(x, weight, self.bias, self.groups,
                                     self.dtype)
        return self.conv(x, weight)


def channel_mask(in_ch: int, out_ch: int, blocks: int,
                 mask_type: str) -> np.ndarray:
    """(out_ch, in_ch) 0/1 mask of a channel-incremental conv."""
    if mask_type not in ("A", "B"):
        raise ValueError(f"mask_type must be 'A' or 'B', got {mask_type!r}")
    if in_ch % blocks or out_ch % blocks:
        raise ValueError(f"channel-incremental conv: {in_ch} -> {out_ch} "
                         f"channels do not split into {blocks} blocks")
    in_blk = np.repeat(np.arange(blocks), in_ch // blocks)
    out_blk = np.repeat(np.arange(blocks), out_ch // blocks)
    if mask_type == "A":
        return (out_blk[:, None] > in_blk[None, :]).astype(np.float32)
    return (out_blk[:, None] >= in_blk[None, :]).astype(np.float32)


class ChannelIncrementalConv2d(nn.Module):
    """Channel-causal SAME conv: output channel block i only sees input
    channel blocks < i (and itself for type B). The parameters are flax's
    ``kernel`` (carried as ``weight``) and, with ``use_bias``, ``bias``."""

    def __init__(self, in_ch: int, features: int, kernel_size: Tuple[int, int],
                 blocks: int, mask_type: str = "A", use_bias: bool = True):
        super().__init__()
        mask = channel_mask(in_ch, features, blocks, mask_type)
        self.register_buffer("mask", torch.from_numpy(mask)[:, :, None, None],
                             persistent=False)
        self.weight = nn.Parameter(torch.zeros(features, in_ch, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.mask, self.bias, padding="same")
