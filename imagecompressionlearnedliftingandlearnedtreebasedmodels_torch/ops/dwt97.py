"""The fixed CDF 9/7 DWT through the lifting ladder, and the detail-subband
packing shared by the transforms (NCHW).

Counterpart of the JAX package's ``ops/dwt97.py``. Each 2-D level lifts the
rows (H, dim 2) first, then the columns (W, dim 3) of each row band:
(LL, HL) from the row-low band, (LH, HH) from the row-high one. Ends are
periodic, so every level halves both sides exactly and the inverse is
exact. The 1-D passes are :func:`..lift97.lift97_1d`/``ilift97_1d``: the
hand-written kernels on a CUDA tensor (three launches a level each way),
the plain ladder on a CPU tensor.

Per level the three detail subbands are packed into ``3*C`` channels with
per-color-channel (LH, HL, HH) order, as the JAX package's
``pack_details`` does along its last axis.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .lift97 import ilift97_1d, lift97_1d


def dwt97_level(x: torch.Tensor):
    """One 2-D level, (B,C,H,W) -> (LL, LH, HL, HH), each (B,C,H/2,W/2)."""
    low, high = lift97_1d(x, 2)
    ll, hl = lift97_1d(low, 3)
    lh, hh = lift97_1d(high, 3)
    return ll, lh, hl, hh


def idwt97_level(ll, lh, hl, hh) -> torch.Tensor:
    """Exact inverse of :func:`dwt97_level`."""
    low = ilift97_1d(ll, hl, 3)
    high = ilift97_1d(lh, hh, 3)
    return ilift97_1d(low, high, 2)


def pack_details(lh: torch.Tensor, hl: torch.Tensor,
                 hh: torch.Tensor) -> torch.Tensor:
    """(B,C,h,w) x3 -> (B,3C,h,w) with channel index ``3*c + s``."""
    stacked = torch.stack([lh, hl, hh], dim=2)  # (B,C,3,h,w)
    b, c, _, h, w = stacked.shape
    return stacked.reshape(b, c * 3, h, w)


def unpack_details(xo: torch.Tensor):
    """Inverse of :func:`pack_details`."""
    b, c3, h, w = xo.shape
    stacked = xo.reshape(b, c3 // 3, 3, h, w)
    return stacked[:, :, 0], stacked[:, :, 1], stacked[:, :, 2]


def dwt97_forward(x: torch.Tensor, levels: int
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Multi-level 9/7 DWT -> ``(ll, highs)``; ``highs[i]`` is the level-i
    detail pack ``(B, 3C, H/2^{i+1}, W/2^{i+1})``, finest first."""
    highs = []
    ll = x
    for _ in range(levels):
        ll, lh, hl, hh = dwt97_level(ll)
        highs.append(pack_details(lh, hl, hh))
    return ll, highs


def dwt97_inverse(ll: torch.Tensor, highs: List[torch.Tensor]) -> torch.Tensor:
    """Exact inverse of :func:`dwt97_forward`."""
    for xo in reversed(highs):
        ll = idwt97_level(ll, *unpack_details(xo))
    return ll
