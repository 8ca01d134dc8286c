"""SAME 3x3 convolution: the hand-written CUDA kernels, the backward and
their plain versions.

Counterpart of the JAX package's Pallas kernel
``ops/pallas_conv.py::_conv3x3_halo_fwd`` and of its ``_bwd``: a
zero-padded SAME 3x3 conv with no bias whose operands are cast to ``dtype``
(bf16 or fp32) and whose sums and output are fp32.

:func:`conv3x3_halo` is a ``torch.autograd.Function`` on both devices. On a
CUDA tensor it picks the kernel by operand type, for the forward and for dx
alike: bf16 operands run the tensor-core implicit GEMM of
``csrc/conv_v2.cu`` (:mod:`.conv_v2`, the counterpart of
``scripts/bench_pallas_v2.py::conv_v2``); fp32 operands run this module's
CUDA-core kernel, ``csrc/conv3x3_halo.cu``. Either is built at first use by
:mod:`.nvcc`, or the call raises: it never falls back to another path.

- forward, on a CUDA tensor: the kernel of the operand type. On a CPU
  tensor: :func:`conv3x3_halo_plain`, a plain ``F.conv2d`` in fp32 on
  operands cast as the kernel casts them (for bf16 the same function as
  :func:`.conv_v2.conv_v2_plain`).
- backward, as ``_bwd`` computes it. ``dy`` is rounded to ``dtype``.
  **dx** is the same conv of ``dy`` with the spatially flipped, in/out
  swapped weight: on a CUDA tensor the same kernel with Cin and Cout
  swapped (a 3->96 layer's dx is a 96->3 conv and takes the kernel's narrow
  Cout tile). **dk** is, as in the JAX package, not a kernel: the nine
  shifted views of the zero-padded input against ``dy``, operands in
  ``dtype``, fp32 sums and an fp32 result (one matrix product).
  On a CPU tensor both are :func:`conv3x3_halo_bwd_plain`.

The input is saved for the backward already cast to ``dtype``. Autograd
through the plain forward would not do: it never rounds ``dy``.

The module-level ``launches`` counts launches of this module's kernel
(forward and dx) and ``launches_dx`` those of them made for a dx;
:mod:`.conv_v2` keeps its own pair. A run sets them to 0 and reads them
back to show which path it went through.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from . import conv_v2, nvcc

SOURCE = os.path.join(nvcc.CSRC, "conv3x3_halo.cu")
OPERAND_DTYPES = (torch.float32, torch.bfloat16)

launches = 0     # kernel launches; callers reset it to 0 before a counted run
launches_dx = 0  # those of them that computed a dx (fp32 operands only)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.conv3x3_halo_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = nvcc.Library(SOURCE, _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return LIBRARY.load()


def conv3x3_halo_plain(x: torch.Tensor, weight: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: operands rounded to ``dtype``,
    then a fp32 SAME conv (no bias). x (B,Cin,H,W), weight (Cout,Cin,3,3)."""
    xq = x.to(dtype).float()
    wq = weight.to(dtype).float()
    return F.conv2d(xq, wq, padding=1)


def launch_kernel(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Run the kernel on NHWC-stored ``x`` (B,Cin,H,W) and tap-major
    ``wt`` (9,Cin,Cout); returns fp32 (B,Cout,H,W) in channels_last."""
    global launches
    if x.device.type != "cuda" or wt.device != x.device:
        raise ValueError("conv3x3_halo kernel: x and weight must be on the "
                         "same CUDA device")
    if x.dtype not in OPERAND_DTYPES or wt.dtype != x.dtype:
        raise ValueError(f"conv3x3_halo kernel: operands must both be fp32 or "
                         f"bf16, got {x.dtype} and {wt.dtype}")
    if x.dim() != 4 or wt.dim() != 3 or wt.shape[0] != 9 \
            or wt.shape[1] != x.shape[1]:
        raise ValueError(f"conv3x3_halo kernel: bad shapes {tuple(x.shape)} "
                         f"and {tuple(wt.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last) \
            or not wt.is_contiguous():
        raise ValueError("conv3x3_halo kernel: x must be channels_last and "
                         "the weight contiguous")
    b, cin, h, w = x.shape
    cout = wt.shape[2]
    if min(b, cin, h, w, cout) < 1:
        raise ValueError(f"conv3x3_halo kernel: empty shape {tuple(x.shape)}")
    y = torch.empty((b, cout, h, w), device=x.device, dtype=torch.float32,
                    memory_format=torch.channels_last)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_halo_fwd(x.data_ptr(), wt.data_ptr(), y.data_ptr(),
                                   b, h, w, cin, cout,
                                   int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_halo kernel launch failed: cudaError {err}")
    launches += 1
    return y


def tap_major(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the kernel's (9, Cin, Cout), ``t = 3*du + dv``."""
    cout, cin = weight.shape[:2]
    return weight.to(dtype).permute(2, 3, 1, 0).reshape(9, cin, cout
                                                        ).contiguous()


def flip_swap(weight: torch.Tensor) -> torch.Tensor:
    """The weight of the dx conv, in PyTorch layout (Cin, Cout, 3, 3):
    ``w'[c, o, du, dv] = w[o, c, 2-du, 2-dv]``."""
    return weight.flip(2, 3).transpose(0, 1)


def _mm_t_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.T @ b`` with fp32 sums and an fp32 result, for (K, M) and (K, N)
    operands of one dtype. bf16 operands on a GPU keep their type and the
    product accumulates and returns fp32 (``out_dtype``, which only CUDA
    takes); on the CPU they are widened first, and the products of the fp32
    copies are the same exact values."""
    if a.dtype == torch.float32:
        return torch.mm(a.t(), b)
    if a.device.type == "cuda":
        return torch.mm(a.t(), b, out_dtype=torch.float32)
    return torch.mm(a.float().t(), b.float())


def dk_product(xq: torch.Tensor, dyq: torch.Tensor) -> torch.Tensor:
    """dk[o, c, du, dv] = sum_{b,y,x} x[b, c, y+du-1, x+dv-1] * dy[b, o, y, x]
    for operands already cast; fp32 (Cout, Cin, 3, 3).

    The nine shifted views of the zero-padded input are gathered into one
    (B*H*W, 9*Cin) matrix (one copy, nine times the input's bytes) and
    contracted with dy in one product."""
    b, cin, h, w = xq.shape
    cout = dyq.shape[1]
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1)).contiguous()
    sb, sh, sw, sc = xp.stride()                  # NHWC, padded
    cols = xp.as_strided((b, h, w, 3, 3, cin), (sb, sh, sw, sh, sw, sc)
                         ).reshape(b * h * w, 9 * cin)
    dyf = dyq.permute(0, 2, 3, 1).reshape(b * h * w, cout)
    return _mm_t_fp32(cols, dyf).view(3, 3, cin, cout).permute(3, 2, 0, 1)


def conv3x3_halo_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                           dy: torch.Tensor,
                           dtype: torch.dtype = torch.bfloat16):
    """The backward in plain PyTorch: ``(dx, dk)`` for x (B,Cin,H,W), weight
    (Cout,Cin,3,3) and dy (B,Cout,H,W). Operands (x, weight, dy) are rounded
    to ``dtype`` and every sum is fp32; dx comes back in x's dtype, dk in
    fp32."""
    dx = conv3x3_halo_plain(dy, flip_swap(weight), dtype).to(x.dtype)
    dk = dk_product(x.to(dtype).float(), dy.to(dtype).float())
    return dx, dk


class _Conv3x3Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, dtype):
        on_card = x.device.type == "cuda"
        xq = x.to(dtype)
        if on_card:
            xq = xq.contiguous(memory_format=torch.channels_last)
        ctx.save_for_backward(xq, weight)
        ctx.dtype, ctx.x_dtype = dtype, x.dtype
        if not on_card:
            return conv3x3_halo_plain(xq, weight, dtype)
        if dtype == torch.bfloat16:
            return conv_v2.launch_kernel(xq, tap_major(weight, dtype))
        return launch_kernel(xq, tap_major(weight, dtype))

    @staticmethod
    def backward(ctx, dy):
        global launches_dx
        xq, weight = ctx.saved_tensors
        dtype = ctx.dtype
        need_dx, need_dk = ctx.needs_input_grad[:2]
        dx = dk = None
        if dy.device.type != "cuda":
            # rounding the saved, already rounded input again changes nothing
            dx, dk = conv3x3_halo_bwd_plain(xq.to(ctx.x_dtype), weight, dy,
                                            dtype)
            return (dx if need_dx else None, dk if need_dk else None, None)
        dyq = dy.to(dtype).contiguous(memory_format=torch.channels_last)
        if need_dx:
            w9 = tap_major(flip_swap(weight), dtype)
            if dtype == torch.bfloat16:
                dx = conv_v2.launch_kernel(dyq, w9, dx=True)
            else:
                dx = launch_kernel(dyq, w9)
                launches_dx += 1
            dx = dx.to(ctx.x_dtype)
        if need_dk:
            dk = dk_product(xq, dyq)
        return dx, dk, None


def conv3x3_halo(x: torch.Tensor, weight: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SAME 3x3 conv, zero padding, no bias; fp32 output; differentiable in
    ``x`` and ``weight``.

    x: (B, Cin, H, W); weight: (Cout, Cin, 3, 3) (PyTorch layout); operands
    are cast to ``dtype`` (bf16 or fp32). A CUDA input runs the hand-written
    kernel of that type (bf16: ``conv_v2``, fp32: ``conv3x3_halo``), forward
    and dx, and comes back in ``channels_last``; a CPU input runs the plain
    versions.
    """
    if dtype not in OPERAND_DTYPES:
        raise ValueError(f"conv3x3_halo: operand dtype must be fp32 or bf16, "
                         f"got {dtype}")
    if weight.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"conv3x3_halo: weight {tuple(weight.shape)} does not "
                         f"fit input {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_halo: unsupported device {x.device}")
    return _Conv3x3Halo.apply(x, weight, dtype)
