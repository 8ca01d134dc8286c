"""The CDF 9/7 lifting ladder: the hand-written CUDA level kernels, the
autograd Functions along one axis, their plain versions and the kernels'
launch plan.

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

``csrc/lift97.cu`` holds one kernel a direction (built at first use by
:mod:`.nvcc`). One launch lifts a whole 2-D level of an NCHW tensor --
rows first, then the columns of each row band, as ``ops/dwt97.py`` orders
it; the synthesis the exact reverse -- with the detail pack written and
read in place (:func:`launch_level_analysis`,
:func:`launch_level_synthesis`; ``ops/dwt97.py`` wraps them in the
level Functions), or one axis (:func:`launch_analysis`,
:func:`launch_synthesis`: a (planes, n, inner) view lifts the middle
axis, an (outer, n) view the last). :func:`launch_plan` picks the tile
and the persistent grid. A CUDA tensor launches the kernel or raises: no
build or launch failure falls back.

:func:`lift97_1d` and :func:`ilift97_1d` are ``torch.autograd.Function``s
along one axis on both devices; each one's backward is the other
structure with the transposed ladder. On a CPU tensor they run
:func:`analysis_plain` / :func:`synthesis_plain` (``torch.roll``, the JAX
ladder's expressions).

The module-level ``launches_lift`` and ``launches_ilift`` count launches of
the analysis and synthesis kernels; a run sets them to 0 and reads them
back to show which path it went through.
"""

from __future__ import annotations

import ctypes
import functools
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

# The kernels' geometry (csrc/lift97.cu keeps the same constants).
THREADS = 128
REACH = 2            # pairs a lifted axis stages each side of a tile
SMS = 132            # SMs of an H100 SXM
SM_SMEM = 233_472    # shared memory of an SM; each block reserves 1 KB more
BLOCK_SMEM = 232_448  # dynamic shared memory a block may have on sm_90
BLOCKS_PER_SM = 4    # the kernels' __launch_bounds__
AXES = {"h": 1, "w": 2, "hw": 3}
# lifted axes -> the compiled (rows, columns) sample tiles, largest first;
# csrc/lift97.cu's LIFT97_TILES lists the same
TILES = {"hw": ((64, 64), (32, 32), (16, 16)),
         "h": ((32, 128), (16, 64)),
         "w": ((128, 64), (64, 16))}


class LaunchArgs(ctypes.Structure):
    """``csrc/lift97.cu``'s ``LaunchArgs``: what a launch needs besides its
    pointers, built once per direction, geometry and ladder."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "synth", "axes", "tile_r", "tile_c", "vec", "grid", "planes", "h",
        "w")] + [("kinds", ctypes.c_int * 4), ("coefs", ctypes.c_float * 4),
                 ("g_lo", ctypes.c_float), ("g_hi", ctypes.c_float),
                 ("base", ctypes.c_int * 4),
                 ("offset", ctypes.c_longlong * 4),
                 ("stride", ctypes.c_longlong * 4)]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.lift97_level
    fn.argtypes = [ctypes.POINTER(LaunchArgs)] + [ctypes.c_void_p] * 4
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

class Plan(NamedTuple):
    """One launch's geometry. A block owns ``tile`` = (rows, columns)
    samples of one (h, w) plane and stages ``stage_rows`` rows of ``pitch``
    floats (the tile and the ladder's reach) in each of two ring stages;
    ``tiles`` such tiles are walked by ``grid`` persistent blocks of
    ``THREADS`` threads. ``vec``: 16-byte copies and float4 stores."""
    synth: bool
    axes: str
    planes: int
    h: int
    w: int
    tile: tuple
    tiles: int
    grid: int
    stage_rows: int
    pitch: int
    smem_bytes: int
    vec: bool


def stage_shape(synth: bool, axes: str, tile_r: int, tile_c: int):
    """(rows, used columns, pitch) of a ring stage. A lifted axis stages
    ``REACH`` pairs (2 REACH samples) on each side; the synthesis along W
    holds each band's pairs in a quadrant of tile_c/2 + 4 REACH columns.
    The pitch is an odd number of float4s."""
    lh, lw = "h" in axes, "w" in axes
    rows = tile_r + (4 * REACH if lh else 0)
    cols = 2 * (tile_c // 2 + 4 * REACH) if synth and lw \
        else tile_c + (4 * REACH if lw else 0)
    return rows, cols, cols if (cols // 4) % 2 else cols + 4


@functools.lru_cache(maxsize=1024)
def launch_plan(synth: bool, axes: str, planes: int, h: int, w: int,
                aligned: bool = True) -> Plan:
    """The kernel's geometry for ``planes`` planes of h x w samples lifted
    along ``axes`` ("h", "w" or "hw"); ``aligned``: every operand starts on
    a 16-byte boundary. The largest tile that gives the grid at least one
    block an SM, else the smallest."""
    for tile_r, tile_c in TILES[axes]:
        tiles = planes * -(-h // tile_r) * -(-w // tile_c)
        if tiles >= SMS:
            break
    rows, _, pitch = stage_shape(synth, axes, tile_r, tile_c)
    smem = 2 * rows * pitch * 4
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))
    vec = aligned and w % (8 if "w" in axes else 4) == 0
    return Plan(synth, axes, planes, h, w, (tile_r, tile_c), tiles,
                min(tiles, SMS * per_sm), rows, pitch, smem, vec)


_LIB = None


@functools.lru_cache(maxsize=1024)
def _launch_args(synth: bool, axes: str, planes: int, h: int, w: int,
                 aligned: bool, ladder: Ladder):
    """The launch's ``LaunchArgs`` (a pointer to it), built and checked once
    per direction, geometry, alignment and ladder. Bands (ph, pw) = (0,0),
    (0,1), (1,0), (1,1): of a level, LL at base 0 and HL, LH, HH in the
    pack at base 1 (channels 3c+1, 3c, 3c+2); of one axis, low at base 0
    and high at base 1."""
    if min(planes, h, w) < 1 or ("h" in axes and h % 2) \
            or ("w" in axes and w % 2):
        raise ValueError(f"lift97 kernel: lifted lengths of a {h}x{w} plane "
                         "must be even and non-zero")
    if h * w >= 2 ** 31:
        raise ValueError(f"lift97 kernel: a {h}x{w} plane is out of range")
    plan = launch_plan(synth, axes, planes, h, w, aligned)
    if plan.tiles >= 2 ** 31:
        raise ValueError(f"lift97 kernel: {plan.tiles} tiles are out of "
                         "range")
    n = (h // 2 if "h" in axes else h) * (w // 2 if "w" in axes else w)
    base, offset, stride = {
        "hw": ((0, 1, 1, 1), (0, n, 0, 2 * n), (n, 3 * n, 3 * n, 3 * n)),
        "h": ((0, -1, 1, -1), (0,) * 4, (n,) * 4),
        "w": ((0, 1, -1, -1), (0,) * 4, (n,) * 4)}[axes]
    return ctypes.pointer(LaunchArgs(
        int(synth), AXES[axes], *plan.tile, int(plan.vec), plan.grid, planes,
        h, w, (ctypes.c_int * 4)(*(k for k, _ in ladder.steps)),
        (ctypes.c_float * 4)(*(c for _, c in ladder.steps)), *ladder.gains,
        (ctypes.c_int * 4)(*base), (ctypes.c_longlong * 4)(*offset),
        (ctypes.c_longlong * 4)(*stride)))


def _check_operands(tensors, what: str) -> None:
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"lift97 kernel: {what} must be on one CUDA "
                             "device")
        if t.dtype is not torch.float32 or not t.is_contiguous():
            raise ValueError(f"lift97 kernel: {what} must be contiguous fp32")


def _launch(synth: bool, axes: str, x: torch.Tensor, base0: torch.Tensor,
            base1: torch.Tensor, planes: int, h: int, w: int, ladder: Ladder,
            aligned: bool) -> None:
    """One launch on x (planes, h, w) and the bands' two base tensors."""
    global _LIB
    args = _launch_args(synth, axes, planes, h, w, aligned, ladder)
    lib = _LIB or build()
    _LIB = lib
    index = x.get_device()
    if index == torch.cuda.current_device():
        err = lib.lift97_level(args, x.data_ptr(), base0.data_ptr(),
                               base1.data_ptr(),
                               torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = lib.lift97_level(args, x.data_ptr(), base0.data_ptr(),
                                   base1.data_ptr(),
                                   torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"lift97 kernel launch failed: cudaError {err}")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def launch_level_analysis(x: torch.Tensor, ladder: Ladder = FORWARD):
    """One 2-D analysis level of contiguous fp32 ``x`` (B, C, H, W) in one
    launch: H, then W of each row band -> (LL (B, C, H/2, W/2), the detail
    pack (B, 3C, H/2, W/2), channel 3c + s with s = (LH, HL, HH))."""
    global launches_lift
    _check_operands((x,), "x")
    if x.dim() != 4:
        raise ValueError(f"lift97 level: x {tuple(x.shape)} is not NCHW")
    b, c, h, w = x.shape
    ll = x.new_empty((b, c, h // 2, w // 2))
    pack = x.new_empty((b, 3 * c, h // 2, w // 2))
    _launch(False, "hw", x, ll, pack, b * c, h, w, ladder, _aligned(x))
    launches_lift += 1
    return ll, pack


def launch_level_synthesis(ll: torch.Tensor, pack: torch.Tensor,
                           ladder: Ladder = INVERSE) -> torch.Tensor:
    """One 2-D synthesis level in one launch: W of each row band, then H,
    from contiguous fp32 LL (B, C, h, w) and the detail pack (B, 3C, h, w),
    read in place -> x (B, C, 2h, 2w)."""
    global launches_ilift
    _check_operands((ll, pack), "LL and the pack")
    if ll.dim() != 4 or pack.shape != (ll.shape[0], 3 * ll.shape[1],
                                       *ll.shape[2:]):
        raise ValueError(f"lift97 level: LL {tuple(ll.shape)} and pack "
                         f"{tuple(pack.shape)} do not match")
    b, c, oh, ow = ll.shape
    x = ll.new_empty((b, c, 2 * oh, 2 * ow))
    _launch(True, "hw", x, ll, pack, b * c, 2 * oh, 2 * ow, ladder,
            _aligned(ll, pack))
    launches_ilift += 1
    return x


def _geometry(shape, dim: int):
    """(outer, n, inner) of the lifted axis ``dim`` of a contiguous tensor."""
    return math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:])


def _axis(outer: int, n: int, inner: int):
    """(axes, planes, h, w): an (outer, n, inner) view lifts h of (outer, n,
    inner) planes; the last axis (inner 1) is w of one (outer, n) plane."""
    if inner == 1:
        return "w", 1, outer, n
    return "h", outer, n, inner


def launch_analysis(x: torch.Tensor, dim: int, ladder: Ladder = FORWARD):
    """The analysis kernel on contiguous fp32 ``x`` along ``dim`` alone."""
    global launches_lift
    _check_operands((x,), "x")
    dim %= x.dim()
    outer, n, inner = _geometry(x.shape, dim)
    half = x.shape[:dim] + (n // 2,) + x.shape[dim + 1:]
    low = x.new_empty(half)
    high = x.new_empty(half)
    axes, planes, h, w = _axis(outer, n, inner)
    _launch(False, axes, x, low, high, planes, h, w, ladder, _aligned(x))
    launches_lift += 1
    return low, high


def launch_synthesis(low: torch.Tensor, high: torch.Tensor, dim: int,
                     ladder: Ladder = INVERSE) -> torch.Tensor:
    """The synthesis kernel on contiguous fp32 ``low``/``high`` along
    ``dim`` alone."""
    global launches_ilift
    _check_operands((low, high), "low and high")
    if low.shape != high.shape:
        raise ValueError(f"lift97 kernel: low {tuple(low.shape)} and high "
                         f"{tuple(high.shape)} differ")
    dim %= low.dim()
    outer, m, inner = _geometry(low.shape, dim)
    full = low.shape[:dim] + (2 * m,) + low.shape[dim + 1:]
    x = low.new_empty(full)
    axes, planes, h, w = _axis(outer, 2 * m, inner)
    _launch(True, axes, x, low, high, planes, h, w, ladder,
            _aligned(low, high))
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
