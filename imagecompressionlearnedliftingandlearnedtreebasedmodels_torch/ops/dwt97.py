"""The fixed CDF 9/7 DWT through the lifting ladder, and the detail-subband
packing shared by the transforms (NCHW).

Counterpart of the JAX package's ``ops/dwt97.py``. Each 2-D level lifts the
rows (H, dim 2) first, then the columns (W, dim 3) of each row band:
(LL, HL) from the row-low band, (LH, HH) from the row-high one. Ends are
periodic, so every level halves both sides exactly and the inverse is
exact. Per level the three detail subbands are packed into ``3*C``
channels with per-color-channel (LH, HL, HH) order, as the JAX package's
``pack_details`` does along its last axis.

:func:`dwt97_level` and :func:`idwt97_level` are ``torch.autograd.Function``s
over a whole level, (B,C,H,W) <-> (LL, detail pack). On a CUDA tensor each
is one launch of ``csrc/lift97.cu``'s level kernel
(:func:`..lift97.launch_level_analysis` / ``launch_level_synthesis``,
the pack written and read in place), and so is each backward: the adjoint
of the analysis level (H then W with ``FORWARD``) is the synthesis level
with ``FORWARD_T`` (W then H), the adjoint of the synthesis level the
analysis level with ``INVERSE_T``. On a CPU tensor they run
:func:`level_analysis_plain` / :func:`level_synthesis_plain`, the plain
ladder of :mod:`.lift97` along each axis.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import lift97
from .lift97 import FORWARD, FORWARD_T, INVERSE, INVERSE_T, Ladder
from .lift97 import ilift97_1d, lift97_1d  # noqa: F401  (the 1-D passes)


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


def level_analysis_plain(x: torch.Tensor, ladder: Ladder = FORWARD):
    """The level kernel's analysis in plain PyTorch: H, then W of each row
    band -> (LL, detail pack)."""
    low, high = lift97.analysis_plain(x, 2, ladder)
    ll, hl = lift97.analysis_plain(low, 3, ladder)
    lh, hh = lift97.analysis_plain(high, 3, ladder)
    return ll, pack_details(lh, hl, hh)


def level_synthesis_plain(ll: torch.Tensor, pack: torch.Tensor,
                          ladder: Ladder = INVERSE) -> torch.Tensor:
    """The level kernel's synthesis in plain PyTorch: W of each row band,
    then H."""
    lh, hl, hh = unpack_details(pack)
    low = lift97.synthesis_plain(ll, hl, 3, ladder)
    high = lift97.synthesis_plain(lh, hh, 3, ladder)
    return lift97.synthesis_plain(low, high, 2, ladder)


def level_analysis(x: torch.Tensor, ladder: Ladder):
    if x.is_cuda:
        return lift97.launch_level_analysis(x.contiguous(), ladder)
    return level_analysis_plain(x, ladder)


def level_synthesis(ll: torch.Tensor, pack: torch.Tensor,
                    ladder: Ladder) -> torch.Tensor:
    if ll.is_cuda:
        return lift97.launch_level_synthesis(ll.contiguous(),
                                             pack.contiguous(), ladder)
    return level_synthesis_plain(ll, pack, ladder)


class _Level(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ll, pack = level_analysis(x, FORWARD)
        ctx.shapes = (ll.shape, pack.shape, x.device)
        return ll, pack

    @staticmethod
    def backward(ctx, g_ll, g_pack):
        ll_shape, pack_shape, dev = ctx.shapes
        if g_ll is None:
            g_ll = torch.zeros(ll_shape, device=dev)
        if g_pack is None:
            g_pack = torch.zeros(pack_shape, device=dev)
        return level_synthesis(g_ll, g_pack, FORWARD_T)


class _ILevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ll, pack):
        return level_synthesis(ll, pack, INVERSE)

    @staticmethod
    def backward(ctx, g):
        return level_analysis(g, INVERSE_T)


def _check_level(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dwt97: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"dwt97: {what} {tuple(x.shape)} is not NCHW")


def dwt97_level(x: torch.Tensor):
    """One 2-D level, (B,C,H,W) -> (LL (B,C,H/2,W/2), the detail pack
    (B,3C,H/2,W/2)); H and W must be even. Differentiable."""
    _check_level(x, "x")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"dwt97: a level of {tuple(x.shape)} needs even H "
                         "and W")
    return _Level.apply(x)


def idwt97_level(ll: torch.Tensor, pack: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`dwt97_level`. Differentiable."""
    _check_level(ll, "LL")
    if pack.shape != (ll.shape[0], 3 * ll.shape[1], *ll.shape[2:]):
        raise ValueError(f"idwt97: LL {tuple(ll.shape)} and pack "
                         f"{tuple(pack.shape)} differ")
    return _ILevel.apply(ll, pack)


def dwt97_forward(x: torch.Tensor, levels: int
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Multi-level 9/7 DWT -> ``(ll, highs)``; ``highs[i]`` is the level-i
    detail pack ``(B, 3C, H/2^{i+1}, W/2^{i+1})``, finest first."""
    highs = []
    ll = x
    for _ in range(levels):
        ll, pack = dwt97_level(ll)
        highs.append(pack)
    return ll, highs


def dwt97_inverse(ll: torch.Tensor, highs: List[torch.Tensor]) -> torch.Tensor:
    """Exact inverse of :func:`dwt97_forward`."""
    for xo in reversed(highs):
        ll = idwt97_level(ll, xo)
    return ll

