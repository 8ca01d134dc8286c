"""Grouped 1x1 convolution in fp32: the hand-written CUDA kernel, its
backward and their plain versions.

Replaces no Pallas kernel: the JAX package leaves its fp32 grouped 1x1
convs (ZTsep's cgp fusion stacks, the pointwise subband autoencoders) to
XLA. Here they ran through cuDNN's grouped conv, which on NCHW fp32
operands wraps each conv in layout transposes; ``csrc/conv1x1g.cu`` works
in NCHW directly. For image b and group g, ``Y[b,g] (M x HW) = W_g (M x K)
. X[b,g] (K x HW) + bias``: fp32 operands, fp32 FFMAs on the CUDA cores,
fp32 sums (no TF32, no tensor cores), the bias added in the kernel's
epilogue.

What bounds it on an H100, and what its design does about that (the
source's note has the detail): the cgp shapes (162 -> 162 and 162 -> 54 a
group) are bound by their FLOPs and take a large register tile (12 or 16
channels x 8 pixels a thread, the whole group's output channels a block);
the autoencoders' shapes (1 -> 32, 32 -> 32, 32 -> 1) are bound by their
bytes and take a streaming tile (128 threads over 256 or 1024 pixels, few
registers) that reads each input pixel once and writes each output once.
:func:`launch_plan` picks the tile from the group's output channels, so
one code path serves both.

:func:`conv1x1g` is a ``torch.autograd.Function`` on both devices:

- forward: on a CUDA tensor the kernel, on a CPU tensor
  :func:`conv1x1g_plain`, the same per-group product and bias in plain
  PyTorch. A CUDA tensor launches the kernel or raises: there is no
  fallback.
- backward: **dx** is the same kernel on each group's transposed weight
  (``W_g^T . dY``, no bias), read in place through strides, launched only
  where the input needs a gradient; **dk** one batched fp32 product over
  NCHW views (``dY[b,g] . X[b,g]^T``, summed over b); **db** the sum of dY
  over batch and pixels. Nothing synchronises the host and the wrapper
  allocates every output, so a CUDA graph captures it.

The module-level ``launches`` counts the kernel's launches (forward and
dx) and ``launches_dx`` those of them made for a dx. A run sets them to 0
and reads them back to show which path it went through.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC, "conv1x1g.cu")

launches = 0     # kernel launches; callers reset it to 0 before a counted run
launches_dx = 0  # those of them that computed a dx

# The kernel's geometry (csrc/conv1x1g.cu keeps the same constants).
SMEM_MAX = 232_448    # dynamic shared memory a block may have on sm_90
# M tile -> (channels a thread, pixel lanes of a warp, warps along M, warps
# along the pixels, input channels a ring stage, ring stages); a thread owns
# 8 pixels, a warp 32 / lanes channel groups of it
TILES = {4: (4, 32, 1, 4, 8, 3), 32: (8, 8, 1, 4, 8, 3),
         64: (16, 8, 1, 4, 16, 3), 96: (12, 8, 2, 2, 16, 3),
         192: (12, 8, 4, 2, 16, 3)}


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.conv1x1g_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


class Plan(NamedTuple):
    """One launch's geometry. A block computes ``m_tile`` output channels
    x ``n_tile`` pixels of one (image, group) with ``threads`` threads; the
    grid is ``grid`` = (pixel tiles, M tiles, B * G). ``vec_x`` / ``vec_y``:
    x comes and y goes by 16-byte copies (else 4-byte ones)."""
    m_tile: int
    n_tile: int
    threads: int
    bk: int           # input channels a ring stage holds
    chunks: int       # ring steps of bk input channels (the last may be short)
    stages: int
    smem_bytes: int
    vec_x: bool
    vec_y: bool
    grid: tuple


def tile_dims(m_tile: int):
    """(n_tile, threads) of an M tile."""
    tm, wn, warps_m, warps_n = TILES[m_tile][:4]
    assert tm * (32 // wn) * warps_m == m_tile
    return 8 * wn * warps_n, 32 * warps_m * warps_n


def stage_floats(m_tile: int) -> int:
    """One ring stage: bk rows of the block's pixels and bk rows of its
    weights, the latter padded by 4 floats."""
    bk = TILES[m_tile][4]
    return bk * tile_dims(m_tile)[0] + bk * (m_tile + 4)


def pick_m_tile(m: int) -> int:
    """The M tile whose tiles cover a group's M channels at the least cost,
    each tile counting its channels and 32 more for staging x again (M 1
    and 2 -> 4, 18 and 32 -> 32, 54 -> 64, 162 -> 192); ties go to the
    wider tile."""
    return min(TILES, key=lambda t: (-(-m // t) * (t + 32), -t))


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, pixels: int, groups: int, k: int, m: int,
                vec_x: bool = True, vec_y: bool = True) -> Plan:
    """The kernel's geometry for ``b`` images of ``groups`` groups of ``k``
    input and ``m`` output channels over ``pixels`` pixels. ``vec_x``:
    x's storage starts on a 16-byte boundary and its strides are multiples
    of 4 (and so for ``vec_y``); the 16-byte copies need ``pixels`` to be a
    multiple of 4 as well."""
    m_tile = pick_m_tile(m)
    n_tile, threads = tile_dims(m_tile)
    bk, stages = TILES[m_tile][4:]
    chunks = -(-k // bk)
    if chunks == 1:
        stages = 2
    grid = (-(-pixels // n_tile), -(-m // m_tile), b * groups)
    return Plan(m_tile, n_tile, threads, bk, chunks, stages,
                4 * stages * stage_floats(m_tile),
                pixels % 4 == 0 and vec_x, pixels % 4 == 0 and vec_y, grid)


LIBRARY = nvcc.Library(SOURCE, _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return LIBRARY.load()


def group_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """(Cout, K, 1, 1) -> (G, M, K), a view."""
    cout, k = weight.shape[:2]
    return weight.reshape(groups, cout // groups, k)


def conv1x1g_plain(x: torch.Tensor, weight: torch.Tensor, bias=None,
                   groups: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each group's product
    ``W_g (M x K) . X[b,g] (K x HW)`` in fp32, then the bias. x (B, G*K,
    H, W), weight (G*M, K, 1, 1), bias (G*M,) or None."""
    b, cin, h, w = x.shape
    wg = group_weight(weight, groups)
    y = torch.matmul(wg, x.reshape(b, groups, cin // groups, h * w))
    y = y.reshape(b, wg.shape[0] * wg.shape[1], h, w)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def _plane_dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where each channel's H x W plane is dense (any batch and
    channel strides), else a contiguous copy."""
    h, w = x.shape[2:]
    if (w == 1 or x.stride(3) == 1) and (h == 1 or x.stride(2) == w):
        return x
    return x.contiguous()


def launch_kernel(x: torch.Tensor, weight: torch.Tensor, bias=None,
                  groups: int = 1, transpose: bool = False) -> torch.Tensor:
    """Run the kernel on fp32 ``x`` (B, G*K, H, W) and the fp32 weight
    (G*M, K, 1, 1); ``transpose`` runs each group's transposed weight
    instead (the input gradient's conv: K and M swapped), read in place.
    Returns fp32 (B, Cout, H, W), contiguous."""
    global launches
    if x.dtype != torch.float32 or weight.dtype != torch.float32 \
            or (bias is not None and bias.dtype != torch.float32):
        raise ValueError(f"conv1x1g kernel: operands must be fp32, got "
                         f"{x.dtype} and {weight.dtype}")
    if x.device.type != "cuda" or weight.device != x.device \
            or (bias is not None and bias.device != x.device):
        raise ValueError("conv1x1g kernel: x, weight and bias must be on "
                         "the same CUDA device")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (1, 1) \
            or weight.shape[0] % groups:
        raise ValueError(f"conv1x1g kernel: bad shapes {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    b, cin, h, w = x.shape
    gm, gk = weight.shape[0] // groups, weight.shape[1]
    m, k = (gk, gm) if transpose else (gm, gk)
    if cin != groups * k or (bias is not None
                             and bias.shape != (groups * m,)):
        raise ValueError(f"conv1x1g kernel: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} and groups {groups} do not "
                         f"fit")
    if min(b, h, w, k, m) < 1:
        raise ValueError(f"conv1x1g kernel: empty shape {tuple(x.shape)}")
    x = _plane_dense(x)
    weight = weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    pixels = h * w
    sb, sc = x.stride(0), x.stride(1)
    plan = launch_plan(b, pixels, groups, k, m,
                       x.data_ptr() % 16 == 0 and sb % 4 == 0 and sc % 4 == 0)
    y = torch.empty((b, groups * m, h, w), device=x.device,
                    dtype=torch.float32)
    wsm, wsk = (1, m) if transpose else (k, 1)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv1x1g_fwd(
            x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            sb, sc, y.stride(0), b, pixels, groups, k, m, wsm, wsk,
            plan.m_tile, plan.threads, plan.stages, plan.smem_bytes,
            int(plan.vec_x), int(plan.vec_y), plan.grid[0], plan.grid[1],
            stream)
    if err != 0:
        raise RuntimeError(f"conv1x1g kernel launch failed: cudaError {err}")
    launches += 1
    return y


def transposed_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The input gradient's weight in PyTorch's layout, (G*K, M, 1, 1):
    ``w'[g*K + k, m] = w[g*M + m, k]``."""
    wg = group_weight(weight, groups)
    g, m, k = wg.shape
    return wg.transpose(1, 2).reshape(g * k, m, 1, 1)


def dk_product(x: torch.Tensor, dy: torch.Tensor, groups: int
               ) -> torch.Tensor:
    """dk[g*M + m, k] = sum_{b,p} dy[b, g*M + m, p] * x[b, g*K + k, p]: one
    batched fp32 product over the NCHW views (B*G, M, HW) and (B*G, HW, K),
    summed over the batch; (G*M, K, 1, 1)."""
    b, cin, h, w = x.shape
    cout = dy.shape[1]
    xg = x.reshape(b * groups, cin // groups, h * w)
    dyg = dy.reshape(b * groups, cout // groups, h * w)
    dk = torch.bmm(dyg, xg.transpose(1, 2))
    return dk.view(b, cout, cin // groups).sum(0).view(cout, -1, 1, 1)


def conv1x1g_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                       dy: torch.Tensor, groups: int = 1):
    """The backward in plain PyTorch: ``(dx, dk, db)``."""
    dx = conv1x1g_plain(dy, transposed_weight(weight, groups), None, groups)
    return dx, dk_product(x, dy, groups), dy.sum((0, 2, 3))


class _Conv1x1G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups):
        ctx.save_for_backward(x, weight)
        ctx.groups = groups
        if x.device.type != "cuda":
            return conv1x1g_plain(x, weight, bias, groups)
        return launch_kernel(x, weight, bias, groups)

    @staticmethod
    def backward(ctx, dy):
        global launches_dx
        x, weight = ctx.saved_tensors
        groups = ctx.groups
        need_dx, need_dk, need_db = ctx.needs_input_grad[:3]
        dx = dk = db = None
        if need_dx:
            if dy.device.type == "cuda":
                dx = launch_kernel(dy, weight, None, groups, transpose=True)
                launches_dx += 1
            else:
                dx = conv1x1g_plain(dy, transposed_weight(weight, groups),
                                    None, groups)
        if need_dk:
            dk = dk_product(x, dy, groups)
        if need_db:
            db = dy.sum((0, 2, 3))
        return dx, dk, db, None


def conv1x1g(x: torch.Tensor, weight: torch.Tensor, bias=None,
             groups: int = 1) -> torch.Tensor:
    """Grouped 1x1 conv with an optional bias, fp32, differentiable in
    ``x``, ``weight`` and ``bias``. x: (B, G*K, H, W); weight: (G*M, K, 1,
    1) (PyTorch's layout, output groups consecutive); bias: (G*M,) or None.
    A CUDA input runs the hand-written kernel (forward and dx), a CPU input
    the plain versions."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv1x1g: unsupported device {x.device}")
    if weight.dim() != 4 or weight.shape[2:] != (1, 1) \
            or x.shape[1] != groups * weight.shape[1] \
            or weight.shape[0] % groups:
        raise ValueError(f"conv1x1g: weight {tuple(weight.shape)} does not "
                         f"fit input {tuple(x.shape)} in {groups} groups")
    return _Conv1x1G.apply(x, weight, bias, groups)
