"""The CDF 9/7 lifting ladder along one axis: the hand-written CUDA kernels,
the autograd Functions and their plain versions.

Counterpart of the JAX package's Pallas kernels in
``scripts/bench_pallas.py``: ``lift97_rows_fused`` (``_ladder_kernel``, the
analysis ladder with periodic ends) and ``ilift97_rows_fused``
(``_inverse_kernel``, its exact inverse), and of the jnp ladder
``ops/dwt97.py::lift97_1d``/``ilift97_1d`` that the JAX package runs.

A ladder is four steps and two gains. With ``s``/``d`` the even/odd
samples (pairs indexed modulo their count):

- ``P`` with coefficient c: ``d_i += c * (s_i + s_{i+1})``;
- ``U`` with coefficient c: ``s_i += c * (d_{i-1} + d_i)``.

The analysis form splits, runs the steps, then scales ``s`` and ``d`` by
the gains; the synthesis form scales first, runs the steps, then
interleaves. The ladder is linear and the transpose of a ``P`` step is a
``U`` step with the same coefficient (and the other way round), so the
four uses are two structures:

- :data:`FORWARD` (analysis): P(a) U(b) P(g) U(d), gains (NL, NH);
- :data:`INVERSE` (synthesis): gains (1/NL, 1/NH), U(-d) P(-g) U(-b) P(-a);
- :data:`FORWARD_T` (synthesis), the adjoint of the forward: gains
  (NL, NH), P(d) U(g) P(b) U(a);
- :data:`INVERSE_T` (analysis), the adjoint of the inverse: U(-a) P(-b)
  U(-g) P(-d), gains (1/NL, 1/NH).

:func:`lift97_1d` and :func:`ilift97_1d` are ``torch.autograd.Function``s on
both devices; each one's backward is the other structure with the
transposed ladder. On a CUDA tensor every pass launches the kernel of
``csrc/lift97.cu`` (built at first use by :mod:`.nvcc`) or raises; it never
falls back. On a CPU tensor it runs :func:`analysis_plain` /
:func:`synthesis_plain` (``torch.roll``, the JAX ladder's expressions).

The module-level ``launches_lift`` and ``launches_ilift`` count launches of
the analysis and synthesis kernels; a run sets them to 0 and reads them
back to show which path it went through.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Tuple

import torch

from . import nvcc
from .math_utils import LIFTING_COEFF

ALPHA, BETA, GAMMA, DELTA, NH, NL = LIFTING_COEFF
P, U = 0, 1   # step kinds, as the kernels number them


class Ladder(NamedTuple):
    steps: Tuple[Tuple[int, float], ...]   # four (kind, coefficient)
    gains: Tuple[float, float]             # (low, high)


FORWARD = Ladder(((P, ALPHA), (U, BETA), (P, GAMMA), (U, DELTA)), (NL, NH))
INVERSE = Ladder(((U, -DELTA), (P, -GAMMA), (U, -BETA), (P, -ALPHA)),
                 (1.0 / NL, 1.0 / NH))
FORWARD_T = Ladder(((P, DELTA), (U, GAMMA), (P, BETA), (U, ALPHA)), (NL, NH))
INVERSE_T = Ladder(((U, -ALPHA), (P, -BETA), (U, -GAMMA), (P, -DELTA)),
                   (1.0 / NL, 1.0 / NH))

SOURCE = os.path.join(nvcc.CSRC, "lift97.cu")

launches_lift = 0    # analysis-kernel launches (F and the adjoint of I)
launches_ilift = 0   # synthesis-kernel launches (I and the adjoint of F)


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("lift97_analysis", "lift97_synthesis"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int


LIBRARY = nvcc.Library(SOURCE, _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return LIBRARY.load()


# --- plain versions --------------------------------------------------------

def _steps(s: torch.Tensor, d: torch.Tensor, dim: int, ladder: Ladder):
    for kind, c in ladder.steps:
        if kind == P:
            d = d + c * (s + torch.roll(s, -1, dims=dim))
        else:
            s = s + c * (torch.roll(d, 1, dims=dim) + d)
    return s, d


def analysis_plain(x: torch.Tensor, dim: int, ladder: Ladder = FORWARD):
    """Split along ``dim``, the ladder's steps, then its gains -> (low,
    high), each half as long along ``dim``."""
    xr = x.unflatten(dim, (x.shape[dim] // 2, 2))
    s, d = _steps(xr.select(dim + 1, 0), xr.select(dim + 1, 1), dim, ladder)
    return s * ladder.gains[0], d * ladder.gains[1]


def synthesis_plain(low: torch.Tensor, high: torch.Tensor, dim: int,
                    ladder: Ladder = INVERSE) -> torch.Tensor:
    """The ladder's gains, its steps, then interleave along ``dim``."""
    s, d = _steps(low * ladder.gains[0], high * ladder.gains[1], dim, ladder)
    return torch.stack([s, d], dim=dim + 1).flatten(dim, dim + 1)


# --- the kernels -----------------------------------------------------------

def _geometry(shape, dim: int):
    """(outer, n, inner) of the lifted axis ``dim`` of a contiguous tensor."""
    return math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:])


def _launch(name: str, ins, out, n: int, outer: int, inner: int,
            ladder: Ladder) -> None:
    for t in (*ins, *out):
        if t.device.type != "cuda" or t.device != ins[0].device:
            raise ValueError("lift97 kernel: tensors must be on one CUDA "
                             "device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lift97 kernel: tensors must be contiguous fp32")
    m = n // 2
    # the grid: ceil(m / 64) pair tiles, ceil(lines / 8) line tiles at most
    if n < 2 or n % 2 or -(-m // 64) > 65535 \
            or -(-(outer * inner) // 8) >= 2 ** 31:
        raise ValueError(f"lift97 kernel: lifted length {n} with "
                         f"{outer * inner} lines is out of range")
    kinds = (ctypes.c_int * 4)(*(k for k, _ in ladder.steps))
    coefs = (ctypes.c_float * 4)(*(c for _, c in ladder.steps))
    ptrs = [t.data_ptr() for t in ins] + [t.data_ptr() for t in out]
    lib = build()
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream(ins[0].device).cuda_stream
        err = getattr(lib, name)(*ptrs, outer, n, inner, kinds, coefs,
                                 *ladder.gains, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def launch_analysis(x: torch.Tensor, dim: int, ladder: Ladder = FORWARD):
    """The analysis kernel on contiguous fp32 ``x`` along ``dim``."""
    global launches_lift
    dim %= x.dim()
    outer, n, inner = _geometry(x.shape, dim)
    half = x.shape[:dim] + (n // 2,) + x.shape[dim + 1:]
    low = torch.empty(half, device=x.device, dtype=x.dtype)
    high = torch.empty_like(low)
    _launch("lift97_analysis", (x,), (low, high), n, outer, inner, ladder)
    launches_lift += 1
    return low, high


def launch_synthesis(low: torch.Tensor, high: torch.Tensor, dim: int,
                     ladder: Ladder = INVERSE) -> torch.Tensor:
    """The synthesis kernel on contiguous fp32 ``low``/``high`` along
    ``dim``."""
    global launches_ilift
    if low.shape != high.shape:
        raise ValueError(f"lift97 kernel: low {tuple(low.shape)} and high "
                         f"{tuple(high.shape)} differ")
    dim %= low.dim()
    outer, m, inner = _geometry(low.shape, dim)
    full = low.shape[:dim] + (2 * m,) + low.shape[dim + 1:]
    x = torch.empty(full, device=low.device, dtype=low.dtype)
    _launch("lift97_synthesis", (low, high), (x,), 2 * m, outer, inner,
            ladder)
    launches_ilift += 1
    return x


def analysis(x: torch.Tensor, dim: int, ladder: Ladder):
    if x.device.type == "cuda":
        return launch_analysis(x.contiguous(), dim, ladder)
    return analysis_plain(x, dim, ladder)


def synthesis(low: torch.Tensor, high: torch.Tensor, dim: int,
              ladder: Ladder) -> torch.Tensor:
    if low.device.type == "cuda":
        return launch_synthesis(low.contiguous(), high.contiguous(), dim,
                                ladder)
    return synthesis_plain(low, high, dim, ladder)


# --- autograd --------------------------------------------------------------

class _Lift97(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return analysis(x, dim, FORWARD)

    @staticmethod
    def backward(ctx, g_low, g_high):
        return synthesis(g_low, g_high, ctx.dim, FORWARD_T), None


class _ILift97(torch.autograd.Function):
    @staticmethod
    def forward(ctx, low, high, dim):
        ctx.dim = dim
        return synthesis(low, high, dim, INVERSE)

    @staticmethod
    def backward(ctx, g):
        g_low, g_high = analysis(g, ctx.dim, INVERSE_T)
        return g_low, g_high, None


def _check(x: torch.Tensor, dim: int) -> int:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lift97: unsupported device {x.device}")
    return dim % x.dim()


def lift97_1d(x: torch.Tensor, dim: int):
    """One 9/7 analysis pass along ``dim`` -> (low, high); the axis must be
    of even length. Differentiable."""
    dim = _check(x, dim)
    if x.shape[dim] % 2:
        raise ValueError(f"lift97: axis {dim} length {x.shape[dim]} must be "
                         "even")
    return _Lift97.apply(x, dim)


def ilift97_1d(low: torch.Tensor, high: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact inverse of :func:`lift97_1d`. Differentiable."""
    dim = _check(low, dim)
    if low.shape != high.shape:
        raise ValueError(f"ilift97: low {tuple(low.shape)} and high "
                         f"{tuple(high.shape)} differ")
    return _ILift97.apply(low, high, dim)
