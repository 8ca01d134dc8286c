"""Quincunx / polyphase lifting networks (NCHW).

Counterpart of the JAX package's ``ops/quincunx.py``. A 2x2 pixel block is
split spatially into "even"/"odd" channel groups (modes ``1p3``/``2p2``/
``3p1``, and the row/column splits ``hor``/``ver``), and N predict/update
CNN pairs lift between the groups::

    xo = repeat(xo) + round(P(xe));   xe = repeat(xe) + round(U(xo))

with optional integer-lifting rounding (``precision_bits``: uniform noise
from a ``torch.Generator`` in training, rounding to the
``255 * 2^(bits-8)`` grid in eval) so that the transform maps integers to
integers. The inverse replays the same nets with subtraction and is exact
(bit for bit in integer mode, where the nets give the same bits again).

The splits are strided views and concatenations on dim 1. The P/U nets'
bias-free SAME 3x3 convs run through :class:`.fast_conv.FastConv3x3` in
fp32: on the card the hand-written kernel of ``csrc/conv3x3_halo.cu``,
forward and dx.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from . import register_list
from .fast_conv import FastConv3x3
from .math_utils import lifting_add, lifting_round

SPLIT_MODE_NAMES = {1: ("1p3", 1, 3), 2: ("2p2", 2, 2), 3: ("3p1", 3, 1),
                    "hv": ("hor", 1, 3)}


def quincunx_split(x: torch.Tensor, mode: str):
    """(B,C,H,W) -> (x_even, x_odd) for ``mode``; the polyphase modes stack
    their cosets along the channels."""
    if mode in ("1p3", "2p2", "3p1"):
        h, w = x.shape[2:]
        if h % 2 or w % 2:
            raise ValueError(f"quincunx_split: {tuple(x.shape)} needs even H "
                             "and W")
        x00, x01 = x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2]
        x10, x11 = x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]
        if mode == "2p2":
            return torch.cat([x00, x11], 1), torch.cat([x01, x10], 1)
        if mode == "1p3":
            return x00, torch.cat([x01, x10, x11], 1)
        return torch.cat([x00, x01, x10], 1), x11
    if mode == "hor":
        return x[:, :, :, 0::2], x[:, :, :, 1::2]
    if mode == "ver":
        return x[:, :, 0::2, :], x[:, :, 1::2, :]
    raise ValueError(mode)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a, b interleaved along ``dim`` (2 or 3): a at even, b at odd."""
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([a, b], dim + 1).reshape(shape)


def quincunx_merge(x_even: torch.Tensor, x_odd: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """Exact inverse of :func:`quincunx_split`."""
    if mode in ("1p3", "2p2", "3p1"):
        if mode == "2p2":
            x00, x11 = x_even.chunk(2, 1)
            x01, x10 = x_odd.chunk(2, 1)
        elif mode == "1p3":
            x00 = x_even
            x01, x10, x11 = x_odd.chunk(3, 1)
        else:
            x11 = x_odd
            x00, x01, x10 = x_even.chunk(3, 1)
        return _interleave(_interleave(x00, x01, 3), _interleave(x10, x11, 3),
                           2)
    if mode == "hor":
        return _interleave(x_even, x_odd, 3)
    if mode == "ver":
        return _interleave(x_even, x_odd, 2)
    raise ValueError(mode)


def split_mode_channels(config_split_mode) -> Tuple[str, int, int]:
    """config ``split_mode`` -> (mode string, se, so) channel multipliers."""
    try:
        return SPLIT_MODE_NAMES[config_split_mode]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown split mode {config_split_mode!r}") from None


class _PredUpdNet(nn.Module):
    """in -> hid (3x3, no bias), tanh, hid -> out (3x3, no bias); hid is
    ``min(min_ch * 32, max(128, max_ch))``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        lo, hi = min(in_ch, out_ch), max(in_ch, out_ch)
        hid = min(lo * 32, max(128, hi))
        self.Conv_0 = FastConv3x3(in_ch, hid, bias=False)
        self.Conv_1 = FastConv3x3(hid, out_ch, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(torch.tanh(self.Conv_0(x)))


class QuincunxLiftingNet(nn.Module):
    """N predict/update lifting pairs between the even and odd channel
    groups, with channel-repeat expansion (``x.repeat(1, r, 1, 1)``: r
    copies of the block, one after another, as ``jnp.tile``)."""

    def __init__(self, in_xe_ch: int, in_xo_ch: int, out_xe_ch: int,
                 out_xo_ch: int, precision_bits: int = 0,
                 num_lifting: int = 1):
        super().__init__()
        if out_xe_ch % in_xe_ch or out_xo_ch % in_xo_ch:
            raise ValueError("quincunx lifting: output channels must be "
                             "multiples of the input channels")
        self.in_xe_ch, self.in_xo_ch = in_xe_ch, in_xo_ch
        self.precision_bits = precision_bits
        self.pred_repeat = out_xo_ch // in_xo_ch
        self.updt_repeat = out_xe_ch // in_xe_ch
        self.prediction = _PredUpdNet(in_xe_ch, out_xo_ch)
        self.update = _PredUpdNet(out_xo_ch, out_xe_ch)
        self.prediction2 = register_list(self, "prediction2", [
            _PredUpdNet(out_xe_ch, out_xo_ch)
            for _ in range(num_lifting - 1)])
        self.update2 = register_list(self, "update2", [
            _PredUpdNet(out_xo_ch, out_xe_ch)
            for _ in range(num_lifting - 1)])

    def _lift(self, base, x, generator, sign=1.0):
        """``base + sign * lifting_round(x)``; eval (``generator`` None)
        fuses the rounding's scaling and the add as the JAX package's
        compiled step does (:func:`.math_utils.lifting_add`)."""
        if generator is None:
            return lifting_add(base, x, self.precision_bits, sign)
        return base + sign * lifting_round(x, self.precision_bits, generator)

    def forward_lifting(self, in_xe, in_xo, generator=None):
        """``generator``: the training noise's (None: eval rounding)."""
        out_xo = self._lift(in_xo.repeat(1, self.pred_repeat, 1, 1),
                            self.prediction(in_xe), generator)
        out_xe = self._lift(in_xe.repeat(1, self.updt_repeat, 1, 1),
                            self.update(out_xo), generator)
        for pred, upd in zip(self.prediction2, self.update2):
            out_xo = self._lift(out_xo, pred(out_xe), generator)
            out_xe = self._lift(out_xe, upd(out_xo), generator)
        return out_xe, out_xo

    def inverse_lifting(self, in_xe, in_xo, generator=None):
        for pred, upd in zip(reversed(self.prediction2),
                             reversed(self.update2)):
            in_xe = self._lift(in_xe, upd(in_xo), generator, -1.0)
            in_xo = self._lift(in_xo, pred(in_xe), generator, -1.0)
        out_xe = self._lift(in_xe, self.update(in_xo), generator, -1.0)
        out_xe = out_xe[:, :self.in_xe_ch]
        out_xo = self._lift(in_xo, self.prediction(out_xe), generator, -1.0)
        return out_xe, out_xo[:, :self.in_xo_ch]


class QuincunxHorVerNet(nn.Module):
    """A horizontal lift, then a vertical split of each half and two
    vertical lifts -> (LL, cat(LH, HL, HH)): the detail blocks one after
    another along the channels, not interleaved per channel as
    :func:`.dwt97.pack_details` packs them."""

    def __init__(self, ch: int, precision_bits: int = 0, num_lifting: int = 1):
        super().__init__()
        self.ch = ch

        def mk():
            return QuincunxLiftingNet(ch, ch, ch, ch, precision_bits,
                                      num_lifting)

        self.lift_hor, self.lift_ver1, self.lift_ver2 = mk(), mk(), mk()

    def forward_lifting(self, in_xe, in_xo, generator=None):
        xe, xo = self.lift_hor.forward_lifting(in_xe, in_xo, generator)
        xe_e, xe_o = quincunx_split(xe, "ver")
        xo_e, xo_o = quincunx_split(xo, "ver")
        ll, lh = self.lift_ver1.forward_lifting(xe_e, xe_o, generator)
        hl, hh = self.lift_ver2.forward_lifting(xo_e, xo_o, generator)
        return ll, torch.cat([lh, hl, hh], 1)

    def inverse_lifting(self, ll, xo3, generator=None):
        lh, hl, hh = xo3.split(self.ch, 1)
        xo_e, xo_o = self.lift_ver2.inverse_lifting(hl, hh, generator)
        xe_e, xe_o = self.lift_ver1.inverse_lifting(ll, lh, generator)
        xo = quincunx_merge(xo_e, xo_o, "ver")
        xe = quincunx_merge(xe_e, xe_o, "ver")
        return self.lift_hor.inverse_lifting(xe, xo, generator)
