"""Learned x2 upscaling for the parent->child zerotree context (NCHW).

Counterpart of the JAX package's ``ops/upscaling.py``: a transposed conv x2
upsampler with a LeakyReLU and a residual 3x3 conv (:class:`Upscale`) and
the parent-context head built on it (:class:`ZeroTreePreviousLayer`), used
by onlyEZWT when ``zt_upsample == "learned"``.

flax's ``nn.ConvTranspose(f, (2, 2), strides=(2, 2))`` (SAME padding,
``transpose_kernel=False``) writes ``y[2i+a, 2j+b] = x[i, j] @ K[1-a, 1-b]``
with ``K`` of shape (2, 2, in, out): its taps are mirrored against
``F.conv_transpose2d``'s ``y[2i+a, 2j+b] = x[i, j] @ w[:, :, a, b]``. The
port keeps ``weight`` in ``F.conv_transpose2d``'s (in, out, 2, 2) layout;
``tools/weights.py`` mirrors the taps on the way in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .fast_conv import Conv2d


class ConvTranspose2x2(nn.Module):
    """Stride-2 2x2 transposed conv with a bias: each input pixel writes one
    2x2 output block."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


class Upscale(nn.Module):
    """ConvTranspose x2 + LeakyReLU + residual 3x3 conv."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose2x2(cin, features)
        self.Conv_0 = Conv2d(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.leaky_relu(self.ConvTranspose_0(x), 0.01)
        return up + self.Conv_0(up)


class ZeroTreePreviousLayer(nn.Module):
    """Learned x2 parent upsampling + 1x1 mixing head."""

    def __init__(self, features: int, out_features: int):
        super().__init__()
        self.Upscale_0 = Upscale(features, features)
        self.Conv_0 = Conv2d(features, out_features, 1)

    def forward(self, parent: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(self.Upscale_0(parent))
