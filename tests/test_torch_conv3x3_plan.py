"""What the wrapper of the fp32 3x3 conv kernel (``ops/conv3x3_halo.py``)
hands ``csrc/conv3x3_halo.cu``, checked on the CPU: its launch plan at
every shape the port runs, forward and dx, and at the card tests' shapes
(coverage of the output, shared memory, threads, the ring's stages), the
choice between the 16-byte and the 4-byte copies of x, the packed weight,
the tile table against
the kernel's dispatch, the ctypes declaration against the C entry point,
and the refusal of bf16 operands. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import ctypes
import importlib.util
import os
import re
import types

import numpy as np
import pytest
import torch

import chip_smoke
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv3x3_halo as conv)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source():
    with open(conv.SOURCE) as fh:
        return fh.read()


def _card_shapes():
    path = os.path.join(ROOT, "tests", "test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("_torch_cuda_k1", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K1_SHAPES + mod.SHAPES


def _plan_cases():
    """(b, h, w, cin, cout) of every launch the kernel serves: each 3x3 conv
    of the flagship's and the quincunx codec's B=8 512x768 eval steps and
    B=8 256x256 train steps with its dx (Cin and Cout swapped), every
    restoration net's (DnCNN, iwave, IRCNN, DIDN, DUDnCNN) at those sizes,
    and the card tests' cases, forward and dx."""
    cfg = config.flagship_config()
    qcfg = config.Config(**chip_smoke.QUINCUNX).validate()
    pcfg = config.flagship_config(postprocess="iwave",
                                  resnetlevel=chip_smoke.PP_RESNETLEVEL)
    cases = set()
    for size, b in (((chip_smoke.H, chip_smoke.W), chip_smoke.B),
                    ((chip_smoke.TRAIN_P,) * 2, chip_smoke.TRAIN_B)):
        for h, w, cin, cout in [*chip_smoke.conv_shapes(cfg, size),
                                *chip_smoke.quincunx_conv_shapes(qcfg, size),
                                *chip_smoke.pp_kernel_shapes(pcfg, size)]:
            cases.update({(b, h, w, cin, cout), (b, h, w, cout, cin)})
    for b, h, w, cin, cout in _card_shapes():
        cases.update({(b, h, w, cin, cout), (b, h, w, cout, cin)})
    return sorted(cases)


@pytest.mark.parametrize("b,h,w,cin,cout", _plan_cases())
def test_launch_plan_fits_the_card_and_covers_the_output(b, h, w, cin, cout):
    """Block (ty, tx, n) owns rows ty*tile_h.., columns tx*tile_w.. and
    channels n*n_tile..: every output pixel and channel once; the ring and
    the epilogue's staging fit the block's shared memory; the block's
    threads are one per (8 channels, row, 8 columns)."""
    p = conv.launch_plan(b, h, w, cin, cout)
    assert p.n_tile in conv.N_TILES and p.n_tile % 8 == 0
    co, px, rows, cgroups = conv.TILES[p.n_tile, p.small]
    assert co % 4 == 0 and p.n_tile % co == 0
    assert (p.tile_h, p.tile_w) == (rows, px * cgroups)
    assert p.threads == p.n_tile // co * rows * cgroups
    # the small tiles where the usual ones would leave SMs idle
    n = conv.pick_n_tile(cout)
    co, px, rows, cgroups = conv.TILES[n, False]
    blocks = -(-h // rows) * -(-w // (px * cgroups)) * -(-cout // n) * b
    assert p.small == (blocks < conv.SMALL_GRID)
    assert p.n_tile == (n if not p.small else 8 if cout <= 8 else 32)
    assert p.threads % 32 == 0 and p.threads <= 1024
    tiles_w = -(-w // p.tile_w)
    assert p.grid == (-(-h // p.tile_h) * tiles_w, p.n_tiles, b)
    pix = np.zeros((h, w), np.int64)
    for blk in range(p.grid[0]):
        r0, c0 = (blk // tiles_w) * p.tile_h, (blk % tiles_w) * p.tile_w
        pix[r0:r0 + p.tile_h, c0:c0 + p.tile_w] += 1
    assert (pix == 1).all()
    ch = np.zeros(cout, np.int64)
    for j in range(p.n_tiles):
        ch[j * p.n_tile:(j + 1) * p.n_tile] += 1
    assert (ch == 1).all()
    # the ring: chunks of KC channels, 2 or 3 stages, never more than the
    # chunks need (2 at least: the kernel's loop keeps one in flight)
    assert p.chunks == -(-cin // conv.KC)
    assert 2 <= p.stages <= conv.MAX_STAGES
    assert p.stages == 2 or p.stages <= p.chunks
    assert p.stage_bytes == conv.stage_bytes(p.n_tile, p.tile_h, p.tile_w)
    assert p.stage_bytes % 16 == 0
    assert p.smem_bytes >= p.stages * p.stage_bytes
    assert p.smem_bytes >= conv.epilogue_bytes(p.n_tile, p.tile_h, p.tile_w)
    assert p.smem_bytes <= conv.SMEM_MAX
    assert max(p.grid[1:]) <= 65535


@pytest.mark.parametrize("cin,cout,x_aligned,vec_x", [
    (96, 192, True, True),      # a Berk AE layer: 16-byte copies of x
    (192, 96, True, True),
    (32, 1, True, True),
    (3, 96, True, False),       # Cin 3: 4-byte copies
    (1, 32, True, False),
    (243, 243, True, False),    # plc: a 972-byte pixel stride
    (96, 192, False, False),    # a misaligned view of x
    (64, 95, False, False),
])
def test_copy_path_follows_channels_and_alignment(cin, cout, x_aligned,
                                                  vec_x):
    assert conv.launch_plan(2, 16, 40, cin, cout, x_aligned).vec_x == vec_x


@pytest.mark.parametrize("cin,cout", [(3, 96), (96, 3), (243, 243), (32, 1),
                                      (64, 97), (192, 96)])
def test_pack_weight_puts_each_weight_where_the_kernel_reads_it(cin, cout):
    """Block (., n, .) at chunk k reads stage weight [t][ci][co] from
    packed[n, k, t, ci, co], which is w[t, k*KC + ci, n*n_tile + co], and
    zero past Cin and Cout."""
    p = conv.launch_plan(1, 8, 8, cin, cout)
    w9 = torch.from_numpy(np.random.RandomState(cin + cout).randn(
        9, cin, cout).astype(np.float32))
    packed = conv.pack_weight(w9, p)
    assert packed.shape == (p.n_tiles, p.chunks, 9, conv.KC, p.n_tile)
    assert packed.is_contiguous()
    full = torch.zeros(9, p.chunks * conv.KC, p.n_tiles * p.n_tile)
    full[:, :cin, :cout] = w9
    want = full.view(9, p.chunks, conv.KC, p.n_tiles, p.n_tile)
    assert torch.equal(packed, want.permute(3, 1, 0, 2, 4))
    # the same from PyTorch's layout (Cout, Cin, 3, 3), and from a view of
    # it that is not contiguous (the dx's flipped, swapped weight)
    oihw = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    assert torch.equal(conv.pack_weight(oihw, p), packed)
    assert torch.equal(conv.pack_weight(oihw.contiguous(), p), packed)
    assert torch.equal(conv.tap_major(oihw, torch.float32), w9)


@pytest.mark.parametrize("cout,n_tile,n_tiles", [
    (1, 8, 1), (3, 8, 1), (8, 8, 1), (9, 32, 1), (32, 32, 1), (64, 64, 1),
    (95, 96, 1), (96, 96, 1), (97, 128, 1), (129, 96, 2), (192, 96, 2),
    (243, 128, 2)])
def test_n_tile_splits_cout_with_little_waste(cout, n_tile, n_tiles):
    p = conv.launch_plan(8, 256, 384, 32, cout)      # enough blocks
    assert (p.n_tile, p.n_tiles) == (n_tile, n_tiles)


def test_tile_table_matches_the_kernels_dispatch():
    """Each (N tile, small grid) launches the kernel built for the (channel
    groups, rows, column groups, channels, pixels a thread) that the plan
    reckons with, the small one told apart by its width of 16, and the
    source keeps the plan's chunk and shared-memory constants."""
    src = _source()
    built = {}
    launch = r"launch<(\d+), (\d+), (\d+), (\d+), (\d+)>\(CONV3X3_ARGS\)"
    for m in re.finditer(rf"case (\d+):\s*return (?:tile_w == 16 \? "
                         rf"{launch}\s*:\s*)?{launch};", src):
        n = int(m.group(1))
        if m.group(2):
            built[n, True] = tuple(map(int, m.group(2, 3, 4, 5, 6)))
        built[n, False] = tuple(map(int, m.group(7, 8, 9, 10, 11)))
    assert built == {(n, small): (n // co, rows, cgroups, co, px)
                     for (n, small), (co, px, rows, cgroups)
                     in conv.TILES.items()}
    for (n, small), (co, px, rows, cgroups) in conv.TILES.items():
        assert (px * cgroups == 16) == small
    assert f"constexpr int KC = {conv.KC};" in src
    assert f"constexpr int SMEM_MAX = {conv.SMEM_MAX};" in src


def test_ctypes_declaration_matches_the_c_entry_point():
    """The argument types the wrapper declares are the C function's: a
    pointer for each ``void*``, an int for each ``int`` (ctypes passes what
    it is told, so a missing or extra int shifts every later argument)."""
    params = re.search(r'extern "C" int conv3x3_halo_fwd\(([^)]*)\)',
                       _source()).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in params.split(",")]
    fn = types.SimpleNamespace()
    conv._declare(types.SimpleNamespace(conv3x3_halo_fwd=fn))
    assert fn.argtypes == want and fn.restype is ctypes.c_int


def test_launch_kernel_refuses_bf16_operands():
    """bf16 operands never reach kernel 1: they run conv_v2."""
    x = torch.zeros(1, 8, 6, 6, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w9 = torch.zeros(9, 8, 4, dtype=torch.bfloat16)
    conv.launches = 0
    with pytest.raises(ValueError, match="conv_v2"):
        conv.launch_kernel(x, w9)
    with pytest.raises(ValueError, match="fp32"):
        conv.launch_kernel(x.float(), w9)
    assert conv.launches == 0


def test_quincunx_shapes_and_their_reckoned_launches():
    """The quincunx P/U convs of a B=8 512x768 eval step: a horizontal lift
    on the (H, W/2) halves and two vertical lifts on the quarters a level,
    3 -> 96 and 96 -> 3 each; 144 launches a step, and a train step one dx
    fewer than its forwards (the first layer sees the image)."""
    qcfg = config.Config(**chip_smoke.QUINCUNX).validate()
    shapes = chip_smoke.quincunx_conv_shapes(qcfg)
    assert {(h, w) for h, w, _, _ in shapes} == {
        (512, 384), (256, 384), (256, 192), (128, 192), (128, 96), (64, 96)}
    assert {(cin, cout) for _, _, cin, cout in shapes} == {(3, 96), (96, 3)}
    assert sum(shapes.values()) == 144
    train = chip_smoke.reckon_quincunx(qcfg, True, (256, 256))
    assert (train["conv3x3_halo"], train["conv3x3_halo_dx"]) == (287, 143)
    first = chip_smoke.quincunx_first_layer(qcfg, (256, 256))
    assert first == (256, 128, 3, 96)
    assert first in chip_smoke.quincunx_conv_shapes(qcfg, (256, 256))
