"""SAME 3x3 convolution of bf16 operands as one implicit GEMM on the tensor
cores: the hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's Pallas kernel
``scripts/bench_pallas_v2.py::conv_v2`` (body ``_kernel_v2``): the same
conv as ``conv3x3_halo`` computed as one contraction of depth ``K = 9*Cin``
(the nine tap windows concatenated along channels), bf16 operands, fp32
sums and an fp32 output. In the port it carries every dense 3x3 conv whose
operands are bf16 on the card, forward and dx: ``ops/conv3x3_halo.py``'s
autograd Function picks it by operand type (``csrc/conv3x3_halo.cu`` keeps
the fp32 ones).

The kernel (``csrc/conv_v2.cu``, built at first use by :mod:`.nvcc`) runs
``nvcuda::wmma`` 16x16x16 bf16 products into fp32 accumulators; the
wrapper pads the channels to a multiple of 16 and the weight to the
kernel's tiles with zeros (:func:`padded_operands`), which add nothing to
the sums. Its bound on an H100 SXM is the larger of its operations over
989 TFLOP/s (bf16 tensor cores) and its bytes (bf16 input and weight read
once, fp32 output written once) over 3.35 TB/s: operations at the
flagship's wide shapes, bytes at the narrow ends.

The module-level ``launches`` counts kernel launches and ``launches_dx``
those of them made for a dx; a run sets them to 0 and reads them back to
show which path it went through.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC, "conv_v2.cu")

launches = 0     # kernel launches; callers reset it to 0 before a counted run
launches_dx = 0  # those of them that computed a dx


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.conv_v2_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def cout_tile(cout: int) -> int:
    """The kernel's Cout tile: 16 where Cout <= 16, else 64 or 32,
    whichever pads Cout less (64 on a tie)."""
    if cout <= 16:
        return 16
    return 64 if _ceil(cout, 64) <= _ceil(cout, 32) else 32


def padded_operands(x: torch.Tensor, wt: torch.Tensor):
    """The kernel's operands: channels zero-padded to a multiple of 16
    (every K step whole) and the weight to (9, Cp, Coutp), Coutp a multiple
    of the kernel's Cout tile, so that every staging load is one aligned
    16-byte vector. Zero channels add nothing to the sums. x stays as it is
    where it already fits. Returns (x, weight, Coutp, tile)."""
    b, cin, h, w = x.shape
    cout = wt.shape[2]
    bn = cout_tile(cout)
    cp = _ceil(cin, 16)
    coutp = _ceil(cout, bn)
    if cp != cin or x.data_ptr() % 16:
        xp = x.new_zeros((b, h, w, cp)).permute(0, 3, 1, 2)  # channels_last
        xp[:, :cin].copy_(x)
        x = xp
    if (cp, coutp) != (cin, cout) or wt.data_ptr() % 16:
        wp = wt.new_zeros((9, cp, coutp))
        wp[:, :cin, :cout].copy_(wt)
        wt = wp
    return x, wt, coutp, bn


LIBRARY = nvcc.Library(SOURCE, _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return LIBRARY.load()


def conv_v2_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: operands rounded to bf16, then
    a fp32 SAME conv (no bias). x (B,Cin,H,W), weight (Cout,Cin,3,3)."""
    return F.conv2d(x.to(torch.bfloat16).float(),
                    weight.to(torch.bfloat16).float(), padding=1)


def launch_kernel(x: torch.Tensor, wt: torch.Tensor,
                  dx: bool = False) -> torch.Tensor:
    """Run the kernel on bf16 NHWC-stored ``x`` (B,Cin,H,W) and tap-major
    bf16 ``wt`` (9,Cin,Cout); returns fp32 (B,Cout,H,W) in channels_last.
    ``dx`` counts the launch as a dx too."""
    global launches, launches_dx
    if x.device.type != "cuda" or wt.device != x.device:
        raise ValueError("conv_v2 kernel: x and weight must be on the same "
                         "CUDA device")
    if x.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16:
        raise ValueError(f"conv_v2 kernel: operands must be bf16, got "
                         f"{x.dtype} and {wt.dtype}")
    if x.dim() != 4 or wt.dim() != 3 or wt.shape[0] != 9 \
            or wt.shape[1] != x.shape[1]:
        raise ValueError(f"conv_v2 kernel: bad shapes {tuple(x.shape)} and "
                         f"{tuple(wt.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last) \
            or not wt.is_contiguous():
        raise ValueError("conv_v2 kernel: x must be channels_last and the "
                         "weight contiguous")
    b, cin, h, w = x.shape
    cout = wt.shape[2]
    if min(b, cin, h, w, cout) < 1:
        raise ValueError(f"conv_v2 kernel: empty shape {tuple(x.shape)}")
    y = torch.empty((b, cout, h, w), device=x.device, dtype=torch.float32,
                    memory_format=torch.channels_last)
    lib = build()
    with torch.cuda.device(x.device):
        xp, wp, coutp, bn = padded_operands(x, wt)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_v2_fwd(xp.data_ptr(), wp.data_ptr(), y.data_ptr(),
                              b, h, w, xp.shape[1], cout, coutp, bn, stream)
    if err != 0:
        raise RuntimeError(f"conv_v2 kernel launch failed: cudaError {err}")
    launches += 1
    if dx:
        launches_dx += 1
    return y
