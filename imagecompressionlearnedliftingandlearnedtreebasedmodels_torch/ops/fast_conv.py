"""Convolution layers of the codec's conv stacks (NCHW).

- :class:`FastConv3x3`: every dense 3x3 layer of the main path (the Berk
  scaling AEs and the ZTsep parent-context stacks) in both dtypes, and the
  bias-free 3x3 layers of the quincunx predict/update nets in fp32, through
  ``conv3x3_halo``. On a CUDA tensor it always runs a hand-written kernel,
  picked by operand type: bf16 operands the tensor-core implicit GEMM
  ``csrc/conv_v2.cu``, fp32 operands the CUDA-core ``csrc/conv3x3_halo.cu``
  (forward and dx alike).
- :class:`Conv2d`: any other SAME conv (the CBAM head's convs, the
  restoration nets' dilated and 1x1 convs, the pointwise AE's grouped 1x1
  convs). ``F.conv2d``, grouped or dilated where needed. With a compute
  ``dtype`` it rounds as flax's ``nn.Conv(dtype=bf16)`` does: bf16 operands,
  a bf16 output, the bias added in bf16.
- The JAX package's matmul forms of the grouped and 5x5 convs, with its
  names and its dispatch, used only with a compute dtype (an fp32 config
  runs plain ``F.conv2d``):

  * :class:`FastGroupedConv1x1` (ZTsep's cgp stack) ->
    :func:`grouped_conv1x1_einsum` on planes of 4096 pixels or more: one
    batched product per group, fp32 sums and an fp32 output;
  * ``MaskedConv2d`` (``ops/masked_conv.py``: the csc conv and the grouped
    PixelCNNs) -> :func:`grouped_conv_taps` under the same rule;
  * :class:`FastConv5x5` (the lifting P/U convs): the JAX package's
    rounding, one bf16 rounding of fp32 sums and an fp32 bias. On even
    planes that package takes :func:`conv5x5_s2d`, a layout for the TPU's
    matrix unit; here one cuDNN bf16 5x5 conv rounds the same way, and
    :func:`conv5x5_s2d` is kept as a function only.

  Below 4096 pixels, and inside :func:`disable_pallas`, the grouped forms
  take ``nn.Conv``'s rounding. A plane's size is its global one inside
  :func:`sharded_planes` (an H-sharded step's row blocks). The products
  run on the card as one cuBLAS batched product of bf16 operands with an
  fp32 output (``torch.bmm(out_dtype=float32)``), on the CPU as the
  bf16-rounded operands multiplied in fp32.
- :class:`StridedConv2d` and :class:`ConvTranspose2d`: the stride-2 SAME
  conv and its transposed counterpart of ``BasicWavelet``, padded and
  cropped as flax's ``nn.Conv`` / ``nn.ConvTranspose`` do.

Weights use PyTorch's ``(Cout, Cin/G, kh, kw)`` layout (a transposed
conv's ``(Cin, Cout, kh, kw)``); without a compute dtype, biases are added
after the conv in fp32. Every layer returns fp32.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .conv3x3_halo import conv3x3_halo

# planes of at least this many pixels take the matmul forms (the JAX
# package's FastGroupedConv1x1 and MaskedConv2d switch)
MATMUL_MIN_PIXELS = 4096

_STATE = threading.local()


def pallas_disabled() -> bool:
    return getattr(_STATE, "no_pallas", False)


@contextlib.contextmanager
def disable_pallas():
    """The JAX package's coding-path context of the same name. There it
    pins the accelerator parent-context pass to the plain lax convs; here
    it selects the small-plane form (``nn.Conv``'s bf16 rounding) of the
    grouped 1x1 and masked grouped convs whatever the plane's size, so a
    caller reproduces the JAX coding path's arithmetic. The port's own
    coding path evaluates the ZTsep contexts in host C++ and the lifting
    P/U convs as the eval forward does (``FastConv5x5`` ignores this
    context, as in the JAX package), so it never enters it."""
    old = pallas_disabled()
    _STATE.no_pallas = True
    try:
        yield
    finally:
        _STATE.no_pallas = old


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` (batched) of low-precision operands with fp32 sums and an
    fp32 output, as ``jnp.einsum(..., preferred_element_type=float32)``.
    The gradients are fp32 products cast to the operands' dtype, as JAX's
    transpose of such a product casts them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype != torch.float32:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``(N, m, k) @ (N, k, n)`` with fp32 sums and output."""
    return _MatmulF32.apply(a, b)


def _add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def conv_lowp(x: torch.Tensor, weight: torch.Tensor, dtype, **kw
              ) -> torch.Tensor:
    """``F.conv2d`` of ``dtype`` operands with fp32 sums, its output
    rounded once to ``dtype`` (XLA's and cuDNN's bf16 conv). On the card
    cuDNN's conv; on the CPU, whose bf16 conv rounds otherwise, the
    rounded operands in fp32 and the output rounded."""
    x, weight = x.to(dtype), weight.to(dtype)
    if x.is_cuda:
        return F.conv2d(x, weight, **kw)
    return F.conv2d(x.float(), weight.float(), **kw).to(dtype)


def grouped_conv1x1_einsum(x: torch.Tensor, weight: torch.Tensor, bias=None,
                           groups: int = 1, dtype=torch.bfloat16
                           ) -> torch.Tensor:
    """Grouped 1x1 conv as a block-diagonal batched product. In NCHW it
    needs no transpose: ``W_g (G, out_g, in_g) @ x (B, G, in_g, H*W)``.
    ``weight``: (Cout, Cin/G, 1, 1), output groups consecutive; fp32
    output, fp32 bias."""
    b, c, h, w = x.shape
    cout, in_g = weight.shape[:2]
    out_g = cout // groups
    xg = x.to(dtype).reshape(b * groups, in_g, h * w)
    wg = (weight.to(dtype).reshape(1, groups, out_g, in_g)
          .expand(b, groups, out_g, in_g).reshape(b * groups, out_g, in_g))
    return _add_bias(matmul_f32(wg, xg).view(b, cout, h, w), bias)


def grouped_conv_taps(x: torch.Tensor, weight: torch.Tensor, bias=None,
                      groups: int = 1, dtype=torch.bfloat16) -> torch.Tensor:
    """Grouped SAME kxk conv as one batched product per group whose
    contraction axis is the T = kh*kw tap-shifted copies of the group's
    input channels: ``W_g (G, out_g, in_g*T) @ P_g (B, G, in_g*T, H*W)``.
    Masks are the caller's (pre-zeroed taps). ``weight``: (Cout, Cin/G,
    kh, kw); fp32 output, fp32 bias."""
    b, c, h, w = x.shape
    cout, in_g, kh, kw = weight.shape
    out_g = cout // groups
    t = kh * kw
    cols = F.unfold(x.to(dtype), (kh, kw), padding=(kh // 2, kw // 2))
    p = cols.view(b * groups, in_g * t, h * w)         # k = ci * T + tap
    wg = (weight.to(dtype).reshape(1, groups, out_g, in_g * t)
          .expand(b, groups, out_g, in_g * t)
          .reshape(b * groups, out_g, in_g * t))
    return _add_bias(matmul_f32(wg, p).view(b, cout, h, w), bias)


def _s2d_index_map() -> np.ndarray:
    """Static index map of the 5x5 -> (3x3 over 2x2 phases) kernel remap:
    for output phase (i, j), input phase (a, b) and block offset (du, dv)
    in {-1, 0, 1}^2 the contributing tap is ``u = 2*du + 2 + a - i`` (rows;
    columns alike) where 0 <= u, v < 5, else none. (3,3,2,2,2,2) flat tap
    ids [du, dv, a, b, i, j], 25 = zero."""
    idx = np.full((3, 3, 2, 2, 2, 2), 25, np.int64)
    for du in range(3):
        for dv in range(3):
            for a in range(2):
                for b in range(2):
                    for i in range(2):
                        for j in range(2):
                            u = 2 * (du - 1) + 2 + a - i
                            v = 2 * (dv - 1) + 2 + b - j
                            if 0 <= u < 5 and 0 <= v < 5:
                                idx[du, dv, a, b, i, j] = u * 5 + v
    return idx


_S2D_IDX = _s2d_index_map().reshape(-1)


def s2d_kernel_5x5(weight: torch.Tensor, dtype=None) -> torch.Tensor:
    """(Cout, Cin, 5, 5) -> (4*Cout, 4*Cin, 3, 3), the polyphase-equivalent
    kernel; channel layouts ``in = (a*2+b)*Cin + c``, ``out = (i*2+j)*Cout
    + o`` (matching :func:`space_to_depth2`)."""
    cout, cin = weight.shape[:2]
    if dtype is not None:
        weight = weight.to(dtype)
    taps = weight.permute(2, 3, 1, 0).reshape(25, cin * cout)
    taps = torch.cat([taps, taps.new_zeros(1, cin * cout)])    # 25 = none
    k2 = taps[torch.from_numpy(_S2D_IDX).to(weight.device)].view(
        3, 3, 2, 2, 2, 2, cin, cout)       # (du, dv, a, b, i, j, cin, cout)
    return k2.permute(4, 5, 7, 2, 3, 6, 0, 1).reshape(4 * cout, 4 * cin, 3, 3)


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), phase-major channels."""
    b, c, h, w = x.shape
    xr = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return xr.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space2(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth2`."""
    b, c4, h2, w2 = y.shape
    c = c4 // 4
    yr = y.reshape(b, 2, 2, c, h2, w2)
    return yr.permute(0, 3, 4, 1, 5, 2).reshape(b, c, h2 * 2, w2 * 2)


def conv5x5_s2d(x: torch.Tensor, weight: torch.Tensor, bias=None,
                dtype=torch.bfloat16) -> torch.Tensor:
    """SAME 5x5 conv through the space-to-depth polyphase identity: an
    exactly equivalent 3x3 conv with 4x the channels on a quarter of the
    positions. The conv's output is in ``dtype``, cast to fp32 before the
    fp32 bias (the JAX package's convention). Needs even H and W."""
    ys = conv_lowp(space_to_depth2(x.to(dtype)), s2d_kernel_5x5(weight, dtype),
                   dtype, padding=1)
    return _add_bias(depth_to_space2(ys).float(), bias)


class Conv2d(nn.Module):
    """SAME conv with an optional compute dtype.

    With ``dtype=bfloat16`` the conv runs on bf16 operands, its bf16 output
    gets the bias added in bf16, and the result is returned as fp32, as
    flax's ``nn.Conv(dtype=bf16)`` rounds. A ``dilation`` pads ``dilation *
    (k // 2)`` on each side (flax's SAME for an odd kernel); ``stride`` 2
    keeps that padding (PyTorch's alignment, which the JAX package's DIDN
    asks for explicitly, not flax's SAME).
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

    def _conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        kw = dict(padding=self.padding, groups=self.groups,
                  dilation=self.dilation, stride=self.stride)
        if self.dtype is None:
            return F.conv2d(x, weight, **kw)
        return conv_lowp(x, weight, self.dtype, **kw)

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        y = self._conv(x, weight)
        if self.dtype is None:
            return _add_bias(y, self.bias)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1)
        return y.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight)


@contextlib.contextmanager
def sharded_planes(pixels_by_width):
    """Inside, :func:`large_plane` reads a tensor of width ``w`` by
    ``pixels_by_width[w]``, the pixels of the global plane whose row block
    it is, and not by its own H*W: an H-sharded step's blocks, extended by
    neighbour rows, then take the form that the unsharded plane takes, as
    the JAX package's sharded step (jitted on the global shapes) does. A
    width not in the map raises."""
    old = getattr(_STATE, "planes", None)
    _STATE.planes = dict(pixels_by_width)
    try:
        yield
    finally:
        _STATE.planes = old


def large_plane(x: torch.Tensor) -> bool:
    """Whether the matmul forms take ``x`` (the JAX package's rule)."""
    if pallas_disabled():
        return False
    planes = getattr(_STATE, "planes", None)
    h, w = x.shape[2], x.shape[3]
    if planes is None:
        return h * w >= MATMUL_MIN_PIXELS
    if w not in planes:
        raise ValueError(f"sharded_planes: no global plane of width {w} "
                         f"(known: {sorted(planes)})")
    return planes[w] >= MATMUL_MIN_PIXELS


class FastGroupedConv1x1(Conv2d):
    """Grouped 1x1 conv with a compute dtype (ZTsep's cgp stack): the
    batched product (:func:`grouped_conv1x1_einsum`) on large planes,
    ``nn.Conv``'s rounding on small ones and inside :func:`disable_pallas`."""

    def __init__(self, cin: int, cout: int, groups: int, dtype):
        super().__init__(cin, cout, 1, groups=groups, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if large_plane(x):
            return grouped_conv1x1_einsum(x, self.weight, self.bias,
                                          self.groups, self.dtype)
        return self.conv(x, self.weight)


class FastConv5x5(Conv2d):
    """The lifting P/U 5x5 conv with a compute dtype, rounded as the JAX
    package's ``FastConv5x5``. On even planes that layer takes
    :func:`conv5x5_s2d`, whose conv output is bf16 and gets the fp32 bias
    after it: here one bf16 5x5 conv (:func:`conv_lowp`, cuDNN's on the
    card) with the same one rounding of fp32 sums, then the fp32 bias. The
    polyphase form spends 8-9 launches a call on layout copies and took
    261.5 ms of device time a bf16 flagship eval step on an H100 against
    the plain conv's 178.7 (``chip_smoke.py``'s ``fast_conv_forms``). On
    odd planes the JAX layer casts a ``dtype`` conv's output to fp32, and
    XLA drops that round trip through bf16 (its excess-precision rule), so
    it returns the fp32 sums of the rounded operands: so does this one,
    plus the fp32 bias."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__(cin, cout, 5, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] % 2 or x.shape[3] % 2:
            y = F.conv2d(x.to(self.dtype).float(),
                         self.weight.to(self.dtype).float(), padding=2)
        else:
            y = conv_lowp(x, self.weight, self.dtype, padding=2).float()
        return _add_bias(y, self.bias)


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
