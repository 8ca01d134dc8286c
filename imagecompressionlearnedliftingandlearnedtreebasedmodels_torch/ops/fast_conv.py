"""Convolution layers of the codec's conv stacks (NCHW).

- :class:`FastConv3x3`: every dense 3x3 layer of the main path (the Berk
  scaling AEs and the ZTsep parent-context stacks) in both dtypes, and the
  bias-free 3x3 layers of the quincunx predict/update nets in fp32, through
  ``conv3x3_halo``. On a CUDA tensor it always runs a hand-written kernel,
  picked by operand type: bf16 operands the tensor-core implicit GEMM
  ``csrc/conv_v2.cu``, fp32 operands the CUDA-core ``csrc/conv3x3_halo.cu``
  (forward and dx alike).
- :class:`Conv2d`: any other SAME conv (the 5x5 lifting P/U convs, the
  grouped 1x1 fusion stack, the CBAM head's convs, the restoration nets'
  dilated and 1x1 convs). ``F.conv2d``, grouped or dilated where needed:
  the JAX package's ``FastConv5x5``/``FastGroupedConv1x1`` are layout
  rewrites for the TPU's matrix unit with the values of a plain conv.
- :class:`StridedConv2d` and :class:`ConvTranspose2d`: the stride-2 SAME
  conv and its transposed counterpart of ``BasicWavelet``, padded and
  cropped as flax's ``nn.Conv`` / ``nn.ConvTranspose`` do.

Weights use PyTorch's ``(Cout, Cin/G, kh, kw)`` layout (a transposed
conv's ``(Cin, Cout, kh, kw)``); biases, where a layer has one, are added
after the conv in fp32. With a compute ``dtype`` the operands are rounded
to it and the output comes back in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv3x3_halo import conv3x3_halo


class Conv2d(nn.Module):
    """SAME conv with an optional compute dtype.

    With ``dtype=bfloat16`` the conv runs on bf16 operands and its bf16
    output is cast to fp32 before the fp32 bias is added, as the JAX
    package's ``FastConv5x5``/``nn.Conv(dtype=bf16)`` do. A ``dilation``
    pads ``dilation * (k // 2)`` on each side (flax's SAME for an odd
    kernel); ``stride`` 2 keeps that padding (PyTorch's alignment, which
    the JAX package's DIDN asks for explicitly, not flax's SAME).
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, groups: int = 1,
                 dtype=None, bias: bool = True, dilation: int = 1,
                 stride: int = 1):
        super().__init__()
        self.groups = groups
        self.dtype = dtype
        self.dilation, self.stride = dilation, stride
        self.padding = dilation * (kernel_size // 2)
        self.weight = nn.Parameter(
            torch.zeros(cout, cin // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        kw = dict(padding=self.padding, groups=self.groups,
                  dilation=self.dilation, stride=self.stride)
        if self.dtype is None:
            y = F.conv2d(x, weight, **kw)
        else:
            y = F.conv2d(x.to(self.dtype), weight.to(self.dtype), **kw).float()
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight)


class FastConv3x3(nn.Module):
    """Dense SAME 3x3 conv through ``conv3x3_halo`` (fp32 output, fp32 bias
    added after; ``bias=False`` makes a layer without one, as flax's
    ``use_bias=False``). ``dtype=None`` runs fp32 operands: on the card the
    register-tiled kernel of ``csrc/conv3x3_halo.cu`` (exact fp32 FFMAs on
    the CUDA cores); ``dtype=bfloat16`` runs bf16 operands: on the card the
    tensor-core kernel of ``csrc/conv_v2.cu``."""

    def __init__(self, cin: int, cout: int, dtype=None, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv3x3_halo(x, self.weight, self.dtype or torch.float32)
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)


def same_pads(n: int, k: int, stride: int):
    """flax's SAME padding (low, high) of one axis of size ``n``: the output
    has ceil(n / stride) samples and the low side gets the smaller half."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class StridedConv2d(nn.Module):
    """SAME conv at stride 2 with a bias, padded as flax pads it: on an even
    side one zero after the end and none before (PyTorch's ``padding=1``
    would shift the sampling grid by one)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(cout, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        (t, b), (lft, r) = (same_pads(n, k, 2) for n in x.shape[2:])
        return F.conv2d(F.pad(x, (lft, r, t, b)), self.weight, self.bias,
                        stride=2)


class ConvTranspose2d(nn.Module):
    """flax's ``nn.ConvTranspose(strides=(2, 2), padding="SAME")``: output
    2H x 2W. PyTorch's transposed conv with no padding, cropped to its
    first 2H rows and 2W columns; the weight (Cin, Cout, kh, kw) holds the
    flax kernel's taps mirrored (the weight carrier mirrors them, as for
    every transposed conv)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(cin, cout, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        y = F.conv_transpose2d(x, self.weight, self.bias, stride=2)
        return y[:, :, :2 * h, :2 * w]
