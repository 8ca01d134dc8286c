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
Hopper's ``wgmma`` on operands that TMA brings into a ring of
shared-memory stages; :func:`launch_plan` computes its geometry here
(tiles, stages, grid, shared memory), and :func:`padded_operands` pads the
operands where the kernel's TMA maps need it. Its bound on an H100 SXM is the larger of its
operations over 989 TFLOP/s (bf16 tensor cores) and its bytes (bf16 input
and weight read once, fp32 output written once) over 3.35 TB/s: operations
at the flagship's wide shapes, bytes at the narrow ends.

The module-level ``launches`` counts kernel launches and ``launches_dx``
those of them made for a dx; a run sets them to 0 and reads them back to
show which path it went through.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC, "conv_v2.cu")

launches = 0     # kernel launches; callers reset it to 0 before a counted run
launches_dx = 0  # those of them that computed a dx

# The kernel's fixed geometry (csrc/conv_v2.cu keeps the same constants).
SEG = 64              # output pixels of one row segment: wgmma's M
KC = 16               # input channels a K step: wgmma's K for bf16
CONSUMERS = 2         # consumer warpgroups a block (and one producer)
SMEM_MAX = 232_448    # dynamic shared memory a block may have on sm_90
SMEM_RESERVED = 1024  # what the card keeps for itself of each block's share
HEAD = 2048           # 1024-byte alignment slack and the ring's mbarriers
MAX_STAGES = 4
# N tiles the kernel is built for, each with its row segments a consumer
# warpgroup runs (N/2 * segments fp32 accumulators a thread)
N_TILES = (8, 16, 32, 64, 96, 128, 192, 248)
SEGMENTS = {8: 8, 16: 4, 32: 4, 64: 2, 96: 2, 128: 2, 192: 2, 248: 1}


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.conv_v2_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


class Plan(NamedTuple):
    """One launch's geometry. A block computes ``tile_h`` output rows x
    ``SEG`` columns x ``n_tile`` output channels of one image; the grid is
    ``grid`` = (pixel tiles, N tiles, batch)."""
    cin: int
    cout: int
    cp: int           # x's channels as the kernel reads them (multiple of 8)
    cw: int           # the weight's Cout as the kernel reads it (multiple of 8)
    chunks: int       # K steps of 16 channels (the last may read past cp)
    n_tile: int
    n_tiles: int
    coutp: int        # n_tile * n_tiles: the output channels the tiles span
    segments: int     # row segments a consumer warpgroup runs
    tile_h: int
    tile_w: int
    stages: int
    stage_bytes: int
    blocks_per_sm: int
    smem_bytes: int
    grid: tuple


def halo_plane_bytes(tile_h: int) -> int:
    """One 8-channel plane of a staged halo tile: (tile_h + 2) rows of
    SEG + 2 pixels of 16 bytes, rounded up to 128 bytes."""
    return _ceil((tile_h + 2) * (SEG + 2) * 16, 128)


def wcols(n_tile: int) -> int:
    """Outputs of one weight box: 64 (128-byte rows, the 128-byte swizzle)
    where the N tile is a multiple of 64 or above 192, else 32 (64-byte
    rows and swizzle)."""
    return 64 if n_tile >= 64 and (n_tile % 64 == 0 or n_tile > 192) else 32


def weight_bytes(n_tile: int) -> int:
    """One K step's weights: boxes of 9 taps x 16 channels x wcols
    outputs."""
    return -(-n_tile // wcols(n_tile)) * 9 * 16 * wcols(n_tile) * 2


def stage_bytes(n_tile: int, tile_h: int) -> int:
    """One ring stage, 1024-byte aligned: the K step's weight boxes and two
    halo planes."""
    return _ceil(weight_bytes(n_tile) + 2 * halo_plane_bytes(tile_h), 1024)


def epilogue_bytes(n_tile: int, segments: int) -> int:
    """The fp32 output tile staged for coalesced stores: one region of
    SEG x n_tile values (and 16 bytes of alignment slack) per segment."""
    return CONSUMERS * segments * (SEG * n_tile * 4 + 16)


def pick_n_tile(cout: int, chunks: int) -> int:
    """The N tile: all of Cout where one of ``N_TILES`` up to 192 holds it
    (the smallest that does). Wider Cout goes in tiles of 128 (two segments
    a warpgroup: a K step's weights serve twice the pixels) where K has 4
    steps or more, else in one tile of 248 (one narrow K step: the output's
    bytes set the pace, and one tile stores them in contiguous runs)."""
    if cout <= 192:
        return next(n for n in N_TILES if n >= cout)
    return 128 if chunks >= 4 or cout > 248 else 248


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, h: int, w: int, cin: int, cout: int) -> Plan:
    """The kernel's geometry for x (b, cin, h, w) -> cout channels."""
    cp = _ceil(cin, 8)
    chunks = -(-cp // KC)
    n_tile = pick_n_tile(cout, chunks)
    segs = SEGMENTS[n_tile]
    tile_h = CONSUMERS * segs
    n_tiles = -(-cout // n_tile)
    blocks = 2 if n_tile <= 16 else 1
    budget = SMEM_MAX if blocks == 1 else \
        (SMEM_MAX + SMEM_RESERVED) // blocks - SMEM_RESERVED
    stage = stage_bytes(n_tile, tile_h)
    stages = min(MAX_STAGES, chunks, (budget - HEAD) // stage)
    smem = HEAD + max(stages * stage, epilogue_bytes(n_tile, segs))
    if blocks == 1:
        # setmaxnreg hands one block the whole register file: ask for more
        # than half the SM's shared memory so that no second block is placed
        smem = max(smem, (SMEM_MAX + SMEM_RESERVED) // 2 + 1)
    grid = (-(-h // tile_h) * -(-w // SEG), n_tiles, b)
    return Plan(cin, cout, cp, _ceil(cout, 8), chunks, n_tile, n_tiles,
                n_tile * n_tiles, segs, tile_h, SEG, stages, stage, blocks,
                smem, grid)


def padded_operands(x: torch.Tensor, wt: torch.Tensor, plan: Plan):
    """The kernel's operands, copied only where they do not fit its TMA
    maps: x's channels zero-padded to ``plan.cp`` (a multiple of 8, so that
    every stride is a multiple of 16 bytes), the tap-major weight (9, Cin,
    Cout) zero-padded to ``plan.cw`` outputs likewise, each 16-byte aligned.
    The kernel's loads fill with zeros past Cin, Cout and the image's
    border; zero channels add nothing to the sums."""
    cin, cout = x.shape[1], wt.shape[2]
    if plan.cp != cin:
        nhwc = F.pad(x.permute(0, 2, 3, 1), (0, plan.cp - cin))
        x = nhwc.permute(0, 3, 1, 2)    # channels_last
    elif x.data_ptr() % 16:
        x = x.clone(memory_format=torch.channels_last)
    if plan.cw != cout:
        wt = F.pad(wt, (0, plan.cw - cout))
    elif wt.data_ptr() % 16:
        wt = wt.clone()
    return x, wt


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
    plan = launch_plan(b, h, w, cin, cout)
    y = torch.empty((b, cout, h, w), device=x.device, dtype=torch.float32,
                    memory_format=torch.channels_last)
    lib = build()
    with torch.cuda.device(x.device):
        xp, wp = padded_operands(x, wt, plan)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_v2_fwd(
            xp.data_ptr(), wp.data_ptr(), y.data_ptr(), b, h, w, plan.cp, cin,
            cout, plan.cw, plan.n_tile, plan.segments, plan.n_tiles,
            plan.chunks, plan.stages, plan.smem_bytes, plan.grid[0], stream)
    if err != 0:
        raise RuntimeError(f"conv_v2 kernel launch failed: error {err}")
    launches += 1
    if dx:
        launches_dx += 1
    return y
