"""Per-subband learned scaling autoencoders (NCHW).

- ``SubbandAutoEncoder``: 4 x (grouped 1x1 conv, hidden in_ch*32, groups
  in_ch, tanh between), down and up: a learned companding curve per
  channel (the CDF 9/7 + factorized codec).
- ``SubbandAutoEncoderBerk``: 3x3 convs of width in_ch*32 / in_ch*64 with
  GDN/IGDN, a spatial context-aware compander (the paper's main configs).
  Its 3x3 convs run through ``conv3x3_halo``.
- ``IdentityAE``: no-op.

The two companders' ``encode`` and ``decode`` are the spans
``subband_ae.encode`` and ``subband_ae.decode`` (``utils/profiling.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.profiling import spanned
from . import register_list
from .fast_conv import Conv2d, FastConv3x3
from .gdn import GDN


HIDDEN = 64  # widest layer of the Berk AE per input channel
POINTWISE_HIDDEN = 32  # width of the pointwise AE per input channel


class SubbandAutoEncoder(nn.Module):
    """Pointwise grouped compander: each channel through its own 1 -> 32 ->
    32 -> 32 -> 1 tanh MLP, down and up."""

    def __init__(self, in_ch: int, dtype=None):
        super().__init__()
        ic, h = in_ch, POINTWISE_HIDDEN
        widths = [(ic, ic * h), (ic * h, ic * h), (ic * h, ic * h),
                  (ic * h, ic)]
        self.down = register_list(self, "down", [
            Conv2d(i, o, 1, groups=ic, dtype=dtype) for i, o in widths])
        self.up = register_list(self, "up", [
            Conv2d(i, o, 1, groups=ic, dtype=dtype) for i, o in widths])

    @staticmethod
    def _run(layers, x: torch.Tensor) -> torch.Tensor:
        for layer in layers[:-1]:
            x = torch.tanh(layer(x))
        return layers[-1](x)

    @spanned("subband_ae.encode")
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(self.down, x)

    @spanned("subband_ae.decode")
    def decode(self, y: torch.Tensor) -> torch.Tensor:
        return self._run(self.up, y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


class SubbandAutoEncoderBerk(nn.Module):
    """3x3 GDN compander; fp32 at both ends, ``dtype`` operands inside."""

    def __init__(self, in_ch: int, dtype=None):
        super().__init__()
        ic, h = in_ch, HIDDEN
        widths = [(ic, ic * h // 2), (ic * h // 2, ic * h),
                  (ic * h, ic * h // 2), (ic * h // 2, ic)]
        gdn_widths = [ic * h // 2, ic * h, ic * h // 2]
        self.down = register_list(
            self, "down", [FastConv3x3(i, o, dtype) for i, o in widths])
        self.down_gdn = register_list(
            self, "down_gdn", [GDN(c, dtype=dtype) for c in gdn_widths])
        self.up = register_list(
            self, "up", [FastConv3x3(i, o, dtype) for i, o in widths])
        self.up_gdn = register_list(
            self, "up_gdn", [GDN(c, inverse=True, dtype=dtype)
                             for c in gdn_widths])

    @spanned("subband_ae.encode")
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        for layer, gdn in zip(self.down[:-1], self.down_gdn):
            x = gdn(layer(x))
        return self.down[-1](x).float()

    @spanned("subband_ae.decode")
    def decode(self, y: torch.Tensor) -> torch.Tensor:
        for layer, gdn in zip(self.up[:-1], self.up_gdn):
            y = gdn(layer(y))
        return self.up[-1](y).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


class IdentityAE(nn.Module):
    """No-op compander."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def decode(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def make_subband_ae(kind: str, in_ch: int, dtype=None) -> nn.Module:
    if kind == "SubbandAutoEncoder":
        return SubbandAutoEncoder(in_ch=in_ch, dtype=dtype)
    if kind == "SubbandAutoEncoderBerk":
        return SubbandAutoEncoderBerk(in_ch=in_ch, dtype=dtype)
    if kind == "none":
        return IdentityAE()
    raise ValueError(f"unknown autoencoder kind {kind!r}")
