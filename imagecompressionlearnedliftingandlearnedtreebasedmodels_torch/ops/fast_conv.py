"""Convolution layers of the codec's conv stacks (NCHW).

- :class:`FastConv3x3`: every dense 3x3 layer of the main path (the Berk
  scaling AEs and the ZTsep parent-context stacks) in both dtypes, through
  ``conv3x3_halo``. On a CUDA tensor it always runs a hand-written kernel,
  picked by operand type: bf16 operands the tensor-core implicit GEMM
  ``csrc/conv_v2.cu``, fp32 operands the CUDA-core ``csrc/conv3x3_halo.cu``
  (forward and dx alike).
- :class:`Conv2d`: any other SAME conv (the 5x5 lifting P/U convs, the
  grouped 1x1 fusion stack). ``F.conv2d``, grouped where needed: the JAX
  package's ``FastConv5x5``/``FastGroupedConv1x1`` are layout rewrites for
  the TPU's matrix unit with the values of a plain conv.

Weights use PyTorch's ``(Cout, Cin/G, kh, kw)`` layout; biases are added
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
    package's ``FastConv5x5``/``nn.Conv(dtype=bf16)`` do.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, groups: int = 1,
                 dtype=None):
        super().__init__()
        self.groups = groups
        self.dtype = dtype
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(
            torch.zeros(cout, cin // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            y = F.conv2d(x, weight, padding=self.padding, groups=self.groups)
        else:
            y = F.conv2d(x.to(self.dtype), weight.to(self.dtype),
                         padding=self.padding, groups=self.groups).float()
        return y + self.bias.view(1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight)


class FastConv3x3(nn.Module):
    """Dense SAME 3x3 conv through ``conv3x3_halo`` (fp32 output, fp32 bias
    added after). ``dtype=None`` runs fp32 operands: on the card the
    register-tiled kernel of ``csrc/conv3x3_halo.cu`` (exact fp32 FFMAs on
    the CUDA cores); ``dtype=bfloat16`` runs bf16 operands: on the card the
    tensor-core kernel of ``csrc/conv_v2.cu``."""

    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv3x3_halo(x, self.weight, self.dtype or torch.float32)
        return y + self.bias.view(1, -1, 1, 1)
