"""Learned lifting-scheme DWT (the paper's main transform), NCHW.

Per level, rows are split even/odd and lifted (predict/update pairs), then
each row-band is split along columns and lifted again, giving LL/LH/HL/HH.
Each lifting step is::

    skip = S(src)                           # learnable 3-tap, init CDF 9/7
    dst  = dst + skip + P(skip) * res_weight   # P/U: small residual CNN

Forward and inverse share the same modules, so the inverse is exact.
Follows the JAX package's ``ops/lifting.py`` including its deliberate
departures from the original PyTorch code (depthwise skip convs, an
exactly invertible ``block_property='different'``).
"""

from __future__ import annotations

import torch
from torch import nn

from . import register_list
from .fast_conv import Conv2d, FastConv5x5
from .math_utils import LIFTING_COEFF

ALPHA, BETA, GAMMA, DELTA, NH_COEFF, NL_COEFF = LIFTING_COEFF


class PBlock(nn.Module):
    """4-conv residual block: conv1 -> (tanh) -> conv2 -> (tanh) -> conv3,
    + conv1 output, -> conv4 (fp32 output). With a compute dtype the 5x5
    convs are ``FastConv5x5`` (the JAX package's bf16 rounding)."""

    def __init__(self, channels: int, hidden: int, filtersize: int = 5,
                 nonlinear: bool = True, dtype=None):
        super().__init__()
        self.nonlinear = nonlinear
        widths = [(channels, hidden), (hidden, hidden), (hidden, hidden),
                  (hidden, channels)]
        if dtype is not None and filtersize == 5:
            convs = [FastConv5x5(i, o, dtype) for i, o in widths]
        else:
            convs = [Conv2d(i, o, filtersize, dtype=dtype) for i, o in widths]
        self.convs = register_list(self, "Conv", convs)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """``mask`` (halo-sharded eval only): a broadcastable 0/1 tensor
        multiplied onto every conv input. On a halo-extended block whose
        rows outside the image are zero, re-zeroing each intermediate
        before the next conv reproduces the unsharded SAME zero padding
        exactly (the conv biases would otherwise bleed into those rows)."""
        m = (lambda t: t) if mask is None else (lambda t: t * mask)
        c0, c1, c2, c3 = self.convs
        out_res = c0(m(x))
        t = torch.tanh(out_res) if self.nonlinear else out_res
        t = c1(m(t))
        if self.nonlinear:
            t = torch.tanh(t)
        t = c2(m(t)) + out_res
        return c3(m(t)).float()


class SkipConv(nn.Module):
    """Learnable 3-tap depthwise conv along H, zero-padded. 'predict' steps
    start from taps (0, c, c), 'update' steps from (c, c, 0)."""

    def __init__(self, channels: int, coeff: float, kind: str):
        super().__init__()
        if kind == "predict":
            pattern = torch.tensor([0.0, coeff, coeff])
        elif kind == "update":
            pattern = torch.tensor([coeff, coeff, 0.0])
        else:
            raise ValueError(f"kind must be 'predict' or 'update', got {kind!r}")
        self.taps = nn.Parameter(pattern[:, None].repeat(1, channels))  # (3, C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[2]
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
        t = self.taps.view(3, 1, -1, 1, 1)
        return t[0] * xp[:, :, 0:n] + t[1] * xp[:, :, 1:n + 1] \
            + t[2] * xp[:, :, 2:n + 2]


def _split_rows(x: torch.Tensor):
    return x[:, :, 0::2], x[:, :, 1::2]


def _merge_rows(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    b, c, h2, w = even.shape
    return torch.stack([even, odd], dim=3).reshape(b, c, h2 * 2, w)


class LiftStage(nn.Module):
    """``num_pairs`` predict/update lifting pairs applied to (L, H) rows::

        skip = S_{2p}(L);   H += skip + P_p(skip) * w
        skip = S_{2p+1}(H); L += skip + U_p(skip) * w

    then optional learned gains ``H *= nh_eff, L *= nl_eff``.
    """

    def __init__(self, channels: int, hidden: int, filtersize: int,
                 num_pairs: int = 2, nonlinear: bool = True,
                 res_weight: float = 0.1, use_scale: bool = False,
                 dtype=None):
        super().__init__()
        self.num_pairs = num_pairs
        self.filtersize = filtersize
        self.res_weight = res_weight
        self.use_scale = use_scale
        pred_coeffs = [ALPHA, GAMMA]
        updt_coeffs = [BETA, DELTA]
        skips = []
        for p in range(num_pairs):
            skips.append(SkipConv(channels, pred_coeffs[p % 2], "predict"))
            skips.append(SkipConv(channels, updt_coeffs[p % 2], "update"))
        self.skips = register_list(self, "skips", skips)
        self.p_blocks = register_list(self, "p_blocks", [
            PBlock(channels, hidden, filtersize, nonlinear, dtype)
            for _ in range(num_pairs)])
        self.u_blocks = register_list(self, "u_blocks", [
            PBlock(channels, hidden, filtersize, nonlinear, dtype)
            for _ in range(num_pairs)])
        if use_scale:
            self.nh = nn.Parameter(torch.zeros(1))
            self.nl = nn.Parameter(torch.zeros(1))

    def _gains(self):
        return NH_COEFF + self.nh[0] * 0.1, NL_COEFF + self.nl[0] * 0.1

    def forward(self, L: torch.Tensor, H: torch.Tensor):
        w = self.res_weight
        for p in range(self.num_pairs):
            skip = self.skips[2 * p](L)
            H = H + skip + self.p_blocks[p](skip) * w
            skip = self.skips[2 * p + 1](H)
            L = L + skip + self.u_blocks[p](skip) * w
        if self.use_scale:
            nh_eff, nl_eff = self._gains()
            H = H * nh_eff
            L = L * nl_eff
        return L, H

    def inverse(self, L: torch.Tensor, H: torch.Tensor):
        w = self.res_weight
        if self.use_scale:
            nh_eff, nl_eff = self._gains()
            H = H / nh_eff
            L = L / nl_eff
        for p in range(self.num_pairs - 1, -1, -1):
            skip = self.skips[2 * p + 1](H)
            L = L - skip - self.u_blocks[p](skip) * w
            skip = self.skips[2 * p](L)
            H = H - skip - self.p_blocks[p](skip) * w
        return L, H


    # --- halo-sharded variants (parallel/tiling.py::make_halo_eval_step) --
    #
    # The exchanges come in as callables, so the module knows nothing of
    # the mesh: ``ext(t)`` concatenates r neighbour rows on each side along
    # the sharded axis (zeros beyond the image's first and last rows, which
    # is the ladder's zero padding); ``mask`` is 0/1 over the extended axis,
    # zero outside the image, multiplied onto every conv input so that each
    # conv's SAME zero padding is reproduced exactly (PBlock.forward). In the
    # row pass the lifted axis (2) is the sharded one and the skip conv
    # needs the extension too; in the column pass (transposed bands, sharded
    # axis 3) the skip conv is local and only the P/U convs need halos.

    @property
    def halo_radius(self) -> int:
        """Rows of valid context a P/U block consumes on each side."""
        return 4 * (self.filtersize // 2)

    def forward_halo_rows(self, L, H, ext, mask, R: int):
        """Row-pass forward, sharded axis == lifted axis (2); ``R ==
        halo_radius + 1`` (one more row for the 3-tap skip conv)."""
        w = self.res_weight
        for p in range(self.num_pairs):
            sk = self.skips[2 * p](ext(L)) * mask
            H = H + sk[:, :, R:-R] + self.p_blocks[p](sk, mask)[:, :, R:-R] * w
            sk = self.skips[2 * p + 1](ext(H)) * mask
            L = L + sk[:, :, R:-R] + self.u_blocks[p](sk, mask)[:, :, R:-R] * w
        if self.use_scale:
            nh_eff, nl_eff = self._gains()
            H = H * nh_eff
            L = L * nl_eff
        return L, H

    def inverse_halo_rows(self, L, H, ext, mask, R: int):
        w = self.res_weight
        if self.use_scale:
            nh_eff, nl_eff = self._gains()
            H = H / nh_eff
            L = L / nl_eff
        for p in range(self.num_pairs - 1, -1, -1):
            sk = self.skips[2 * p + 1](ext(H)) * mask
            L = L - sk[:, :, R:-R] - self.u_blocks[p](sk, mask)[:, :, R:-R] * w
            sk = self.skips[2 * p](ext(L)) * mask
            H = H - sk[:, :, R:-R] - self.p_blocks[p](sk, mask)[:, :, R:-R] * w
        return L, H

    def forward_halo_cols(self, L, H, ext, mask, r: int):
        """Column-pass forward on transposed bands (B, C, W, Hs): the
        lifted axis (2) is local, the sharded axis is 3; ``r ==
        halo_radius``."""
        w = self.res_weight
        for p in range(self.num_pairs):
            sk = self.skips[2 * p](L)
            ske = ext(sk) * mask
            H = H + sk + self.p_blocks[p](ske, mask)[..., r:-r] * w
            sk = self.skips[2 * p + 1](H)
            ske = ext(sk) * mask
            L = L + sk + self.u_blocks[p](ske, mask)[..., r:-r] * w
        if self.use_scale:
            nh_eff, nl_eff = self._gains()
            H = H * nh_eff
            L = L * nl_eff
        return L, H

    def inverse_halo_cols(self, L, H, ext, mask, r: int):
        w = self.res_weight
        if self.use_scale:
            nh_eff, nl_eff = self._gains()
            H = H / nh_eff
            L = L / nl_eff
        for p in range(self.num_pairs - 1, -1, -1):
            sk = self.skips[2 * p + 1](H)
            ske = ext(sk) * mask
            L = L - sk - self.u_blocks[p](ske, mask)[..., r:-r] * w
            sk = self.skips[2 * p](L)
            ske = ext(sk) * mask
            H = H - sk - self.p_blocks[p](ske, mask)[..., r:-r] * w
        return L, H


def lift_level_forward(stage: LiftStage, x: torch.Tensor):
    """One 2D level: rows then columns. The two column passes (over L and
    over H) share the stage's modules, so they run as one call on the
    batch-concatenated, H<->W transposed bands."""
    L, H = stage(*_split_rows(x))
    b = x.shape[0]
    T = torch.cat([L.transpose(2, 3), H.transpose(2, 3)], dim=0)
    lo_t, hi_t = stage(*_split_rows(T))
    ll = lo_t[:b].transpose(2, 3)
    hl = hi_t[:b].transpose(2, 3)
    lh = lo_t[b:].transpose(2, 3)
    hh = hi_t[b:].transpose(2, 3)
    return ll, lh, hl, hh


def lift_level_inverse(stage: LiftStage, ll, lh, hl, hh):
    """Exact inverse of :func:`lift_level_forward`."""
    b = ll.shape[0]
    lo_t = torch.cat([ll.transpose(2, 3), lh.transpose(2, 3)], dim=0)
    hi_t = torch.cat([hl.transpose(2, 3), hh.transpose(2, 3)], dim=0)
    merged = _merge_rows(*stage.inverse(lo_t, hi_t))
    L = merged[:b].transpose(2, 3)
    H = merged[b:].transpose(2, 3)
    return _merge_rows(*stage.inverse(L, H))
