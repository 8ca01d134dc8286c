"""The bf16 3x3 conv of the port against the JAX package's single-product
Pallas conv, ``scripts/bench_pallas_v2.py::conv_v2``, run as a Pallas
kernel in interpret mode on the CPU.

``bench_pallas_v2.py`` runs its benchmark when imported, so only its
imports and function definitions are taken (parsed with ``ast``; the
compile-cache switch and the ``pallas_conv`` import left out) and executed
with ``pl`` bound to a namespace whose ``pallas_call`` interprets.

Tolerance: 1e-5 of max |y|. The products of bf16 operands are exact in
fp32; the sums of the two sides differ only in order.

Also, on the CPU, what the wrapper hands the CUDA kernel: its operands'
padding, its launch plan at every shape the port runs (the kernel itself
runs only on the card, ``tests/test_torch_cuda.py``), the generated
``wgmma`` header, the ctypes declaration and the build's key.
"""

import ast
import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

import chip_smoke
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv3x3_halo as conv, conv_v2)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    gen_wgmma)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(scope="module")
def bench_v2():
    path = os.path.join(ROOT, "scripts", "bench_pallas_v2.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)

    def keep(node):
        if isinstance(node, ast.FunctionDef):
            return True
        if isinstance(node, ast.Import):
            return True
        if isinstance(node, ast.ImportFrom):
            return not any(a.name in ("pallas_conv", "enable_compile_cache")
                           for a in node.names)
        return False

    tree.body = [n for n in tree.body if keep(n)]
    ns = {"__name__": "bench_pallas_v2"}
    exec(compile(tree, path, "exec"), ns)
    ns["pl"] = types.SimpleNamespace(
        pallas_call=functools.partial(jpl.pallas_call, interpret=True),
        BlockSpec=jpl.BlockSpec, Element=jpl.Element)
    return types.SimpleNamespace(**ns)


@pytest.mark.parametrize("b,h,w,cin,cout,taps,th", [
    (1, 16, 24, 32, 48, 9, 8),    # one product of K = 9*Cin
    (1, 16, 24, 32, 48, 3, 8),    # three products of K = 3*Cin
    (2, 9, 16, 3, 8, 9, 8),       # ragged H (9 rows in tiles of 8), Cin 3
])
def test_conv_v2_matches_the_pallas_kernel(bench_v2, b, h, w, cin, cout,
                                           taps, th):
    rng = np.random.RandomState(h * cin + taps)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    want = np.asarray(bench_v2.conv_v2(jnp.asarray(x), jnp.asarray(k),
                                       th=th, taps=taps))
    assert want.shape == (b, h, w, cout) and want.dtype == np.float32
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1)
    scale = np.abs(want).max()
    plain = conv_v2.conv_v2_plain(xt, wt).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want).max() <= TOL * scale
    with torch.no_grad():
        got = conv.conv3x3_halo(xt, wt, torch.bfloat16)
    assert got.dtype == torch.float32
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= TOL * scale


def test_the_function_on_the_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches a launcher, in either operand type, forward
    or backward; the counters stay at 0."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    monkeypatch.setattr(conv_v2, "launch_kernel", refuse)
    monkeypatch.setattr(conv, "launch_kernel", refuse)
    conv_v2.launches = conv_v2.launches_dx = conv.launches = 0
    x = torch.randn(1, 4, 5, 6, requires_grad=True)
    wt = torch.randn(3, 4, 3, 3, requires_grad=True)
    for dtype in (torch.bfloat16, torch.float32):
        y = conv.conv3x3_halo(x, wt, dtype)
        y.sum().backward()
        want = conv.conv3x3_halo_plain(x.detach(), wt.detach(), dtype)
        assert torch.equal(y.detach(), want)
    assert x.grad.shape == x.shape and wt.grad.shape == wt.shape
    assert conv_v2.launches == conv_v2.launches_dx == conv.launches == 0


def test_launcher_refuses_a_cpu_tensor():
    x = torch.zeros(1, 4, 5, 6, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="CUDA"):
        conv_v2.launch_kernel(x, torch.zeros(9, 4, 3, dtype=torch.bfloat16))


@pytest.mark.parametrize("cin,cout", [(3, 96), (243, 243), (96, 3),
                                      (192, 96), (1, 32)])
def test_padded_operands_add_nothing(cin, cout):
    """The kernel's operands: x's channels padded to a multiple of 8 and the
    tap-major weight's Cout likewise (every TMA stride a multiple of 16
    bytes), each copied only where it needs that; the N tile the smallest
    of the kernel's that holds Cout, or 128 past 192 with 4 K steps or
    more; the conv of the padded operands is the
    conv (zero channels add exact zeros; the CPU conv may sum the longer K
    in another order: 1e-6)."""
    rng = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rng.randn(2, cin, 5, 7).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(rng.randn(cout, cin, 3, 3).astype(np.float32))
    w9 = conv.tap_major(wt, torch.bfloat16)
    plan = conv_v2.launch_plan(2, 5, 7, cin, cout)
    xp, wp = conv_v2.padded_operands(x, w9, plan)
    cp, cw = plan.cp, plan.cw
    assert cp % 8 == 0 and cp - cin < 8 and cw % 8 == 0 and cw - cout < 8
    assert (xp is x) == (cp == cin) and (wp is w9) == (cw == cout)
    if cout <= 192 or plan.chunks < 4:
        assert plan.n_tiles == 1 and plan.n_tile == min(
            n for n in conv_v2.N_TILES if n >= cout)
    else:
        assert plan.n_tile == 128 and plan.n_tiles == -(-cout // 128)
    assert xp.shape == (2, cp, 5, 7)
    assert xp.is_contiguous(memory_format=torch.channels_last)
    assert wp.shape == (9, cin, cw) and wp.is_contiguous()
    w4 = wp.float().reshape(3, 3, cin, cw).permute(3, 2, 0, 1)
    w4 = torch.nn.functional.pad(w4, (0, 0, 0, 0, 0, cp - cin))
    got = torch.nn.functional.conv2d(xp.float(), w4, padding=1)
    assert torch.equal(got[:, cout:], torch.zeros_like(got[:, cout:]))
    want = conv_v2.conv_v2_plain(x.float(), wt)
    assert (got[:, :cout] - want).abs().max() <= 1e-6 * want.abs().max()


def _card_shapes():
    path = os.path.join(ROOT, "tests", "test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("_torch_cuda_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.V2_SHAPES


def _plan_cases():
    """(b, h, w, cin, cout) of every launch the kernel serves: each 3x3 conv
    of the B=8 512x768 eval step and of the B=8 256x256 train step with its
    dx (Cin and Cout swapped), bench_pallas_v2.py's shapes and the card
    tests' cases, forward and dx."""
    cfg = config.flagship_config(dtype="bfloat16")
    cases = set()
    for size, b in (((chip_smoke.H, chip_smoke.W), chip_smoke.B),
                    ((chip_smoke.TRAIN_P,) * 2, chip_smoke.TRAIN_B)):
        for h, w, cin, cout in chip_smoke.conv_shapes(cfg, size):
            cases.update({(b, h, w, cin, cout), (b, h, w, cout, cin)})
    for (b, h, w, cin), cout in chip_smoke.BENCH_PALLAS_V2_SHAPES:
        cases.add((b, h, w, cin, cout))
    for b, h, w, cin, cout in _card_shapes():
        cases.update({(b, h, w, cin, cout), (b, h, w, cout, cin)})
    return sorted(cases)


@pytest.mark.parametrize("b,h,w,cin,cout", _plan_cases())
def test_launch_plan_fits_the_card_and_covers_the_output(b, h, w, cin, cout):
    """The plan the wrapper hands the kernel: its tiles cover every output
    pixel and channel exactly once, its shared memory fits a block (two
    blocks an SM where it plans two), its N tile is one the kernel is built
    for, and every TMA stride and box is one the card takes."""
    p = conv_v2.launch_plan(b, h, w, cin, cout)
    # coverage: block (ty, tx) owns rows ty*tile_h.. and columns tx*64..;
    # N tile j owns channels j*n_tile..; clipped to the image and Cout
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
    assert (ch == 1).all() and p.coutp - cout < p.n_tile
    assert p.tile_w == 64 and p.tile_h == 2 * p.segments
    # K: whole steps of 16 channels over Cp, Cp the smallest multiple of 8
    assert p.cp % 8 == 0 and 0 <= p.cp - cin < 8
    assert p.chunks == -(-p.cp // 16)
    # the N tile: wgmma's N, a multiple of 8 up to 256, built in the kernel
    assert p.n_tile % 8 == 0 and 8 <= p.n_tile <= 256
    assert p.n_tile in conv_v2.N_TILES
    # shared memory: the ring (at least two stages where there are two K
    # steps) and the epilogue's staging both fit
    assert 1 <= p.stages <= min(conv_v2.MAX_STAGES, p.chunks)
    assert p.stages >= min(2, p.chunks)
    assert p.stage_bytes == conv_v2.stage_bytes(p.n_tile, p.tile_h)
    assert p.smem_bytes >= conv_v2.HEAD + p.stages * p.stage_bytes
    assert p.smem_bytes >= conv_v2.HEAD + conv_v2.epilogue_bytes(
        p.n_tile, p.segments)
    assert p.smem_bytes <= conv_v2.SMEM_MAX
    # blocks an SM: as many as planned fit by shared memory, and a wide
    # tile's one block (its setmaxnreg takes the whole register file) has
    # the SM to itself
    per_block = p.smem_bytes + conv_v2.SMEM_RESERVED
    sm = conv_v2.SMEM_MAX + conv_v2.SMEM_RESERVED
    assert p.blocks_per_sm * per_block <= sm
    assert p.blocks_per_sm == (2 if p.n_tile <= 16 else 1)
    assert p.blocks_per_sm == 2 or 2 * per_block > sm
    # TMA: x's map (Cp, W, H, B) and the weight's (Cw, Cin, 9), bf16, their
    # strides in bytes multiples of 16, their boxes at most 256 a dimension:
    # x's (8, 66, tile_h + 2, 1), 16-byte rows, no swizzle; the weight's
    # (32, 16, 9), 64-byte rows under the 64-byte swizzle
    assert p.cw % 8 == 0 and 0 <= p.cw - cout < 8
    for strides in ((p.cp * 2, w * p.cp * 2, h * w * p.cp * 2),
                    (p.cw * 2, cin * p.cw * 2)):
        assert all(s % 16 == 0 for s in strides)
    xbox = (8, p.tile_w + 2, p.tile_h + 2, 1)
    wbox = (conv_v2.wcols(p.n_tile), 16, 9)
    assert max(xbox + wbox) <= 256 and xbox[0] * 2 == 16
    assert wbox[0] * 2 in (64, 128)
    # each box lands where its layout needs: weight boxes (a whole number
    # of 512-byte swizzle atoms) first in a 1024-byte aligned stage, then
    # the halo planes on 128-byte boundaries
    assert conv_v2.weight_bytes(p.n_tile) % 1024 == 0
    assert conv_v2.weight_bytes(p.n_tile) >= 9 * 16 * p.n_tile * 2
    assert conv_v2.halo_plane_bytes(p.tile_h) % 128 == 0
    assert p.stage_bytes % 1024 == 0
    assert p.grid[1] <= 65535 and p.grid[2] <= 65535


def test_wgmma_header_is_what_its_generator_writes():
    with open(gen_wgmma.HEADER) as fh:
        assert fh.read() == gen_wgmma.render()


def test_build_key_covers_the_included_headers(tmp_path):
    """An edited header or another flag gives another build; an unchanged
    source tree the same one."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        nvcc)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cstdint>\n')
    (tmp_path / "a.cuh").write_text('#include "b.h"\n')
    (tmp_path / "b.h").write_text("// b\n")
    src = str(tmp_path / "k.cu")
    assert nvcc.local_headers(src) == [str(tmp_path / "a.cuh"),
                                       str(tmp_path / "b.h")]
    lib = nvcc.Library(src, lambda _: None)
    key = lib.digest()
    assert nvcc.Library(src, lambda _: None).digest() == key
    assert nvcc.Library(src, lambda _: None, flags=("-DX",)).digest() != key
    (tmp_path / "b.h").write_text("// b, edited\n")
    assert lib.digest() != key


def test_ctypes_declaration_matches_the_c_entry_point():
    """The argument types the wrapper declares are the C function's: a
    pointer for each ``void*``, an int for each ``int`` (ctypes passes what
    it is told, so a missing or extra int shifts every later argument)."""
    import ctypes
    import re
    with open(conv_v2.SOURCE) as fh:
        src = fh.read()
    params = re.search(r'extern "C" int conv_v2_fwd\(([^)]*)\)', src).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in params.split(",")]
    fn = types.SimpleNamespace()
    conv_v2._declare(types.SimpleNamespace(conv_v2_fwd=fn))
    assert fn.argtypes == want and fn.restype is ctypes.c_int
