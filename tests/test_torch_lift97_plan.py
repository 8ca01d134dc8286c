"""What the wrapper of the CDF 9/7 level kernels (``ops/lift97.py``) hands
``csrc/lift97.cu``, and the level Functions of ``ops/dwt97.py``, checked on
the CPU:

- the launch plan at every shape the port runs (each level of the CDF97
  eval and train steps, the one-axis passes at ``scripts/bench_pallas.py``'s
  shapes and the card tests' shapes): tiles that cover each plane exactly,
  the persistent grid, the ring's shared memory under the card's limit,
  the small-grid tiles;
- the tile table and the constants against the kernel's, the ctypes
  declaration against the C entry point;
- in float64, that the staged reach (``REACH`` pairs) covers the ladder's
  support in both directions, read off the plain ladder with unit
  impulses as ``chip_smoke.py::ladder_filters`` reads it;
- a pure-PyTorch emulation of the kernel's tiling (each tile's window with
  the reach, wrapped periodically, the ladder run without wrapping inside
  it, the centre kept) against the plain level, in float64, where the wrap
  crosses a tile: one pair, planes smaller than a tile, W % 4 != 0;
- the level Functions against the JAX package's ``ops/dwt97.py``
  (``dwt97_level``, ``idwt97_level``, ``pack_details``) and their
  gradients against ``jax.vjp``, at 32-64 px with 2-3 levels, to
  ``LADDER_TOL`` = 1e-5 of max |reference| (fp32, the same expressions).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import ctypes
import importlib.util
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    dwt97 as pdwt, lift97)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    dwt97 as jdwt)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER_TOL = 1e-5
LADDERS = {"F": lift97.FORWARD, "I": lift97.INVERSE,
           "F_T": lift97.FORWARD_T, "I_T": lift97.INVERSE_T}
ANALYSIS = ("F", "I_T")


def _source():
    with open(lift97.SOURCE) as fh:
        return fh.read()


def _card_shapes():
    path = os.path.join(ROOT, "tests", "test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("_torch_cuda_l97", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.LADDER_SHAPES + mod.LEVEL_SHAPES


def _plan_cases():
    """(axes, planes, h, w) of every launch the kernels serve: each level of
    the CDF97 B=8 512x768 eval and B=4 256x256 train steps, the one-axis
    passes at the bench and card-test shapes, and the card tests' levels."""
    cases = set()
    for b, h, w in ((chip_smoke.B, chip_smoke.H, chip_smoke.W),
                    (chip_smoke.CDF97_TRAIN_B, chip_smoke.TRAIN_P,
                     chip_smoke.TRAIN_P)):
        for n, c, hh, ww in chip_smoke.level_shapes(4, b, h, w):
            cases.add(("hw", n * c, hh, ww))
    one_axis = list(chip_smoke.BENCH_PALLAS_SHAPES) + _card_shapes()
    for shape in one_axis:
        for dim in (2, 3):
            cases.add(lift97._axis(*lift97._geometry(shape, dim)))
    for n, c, h, w in _card_shapes():
        if h % 2 == 0 and w % 2 == 0:
            cases.add(("hw", n * c, h, w))
    return sorted(cases)


@pytest.mark.parametrize("synth", [False, True])
@pytest.mark.parametrize("axes,planes,h,w", _plan_cases())
def test_launch_plan_covers_each_plane_and_fits_the_card(axes, planes, h, w,
                                                         synth):
    plan = lift97.launch_plan(synth, axes, planes, h, w)
    tr, tc = plan.tile
    assert plan.tile in lift97.TILES[axes]
    # whole tiles of even rows and float4 columns; the output tile of a
    # lifted axis is half as long and still whole float4s
    assert tr % 2 == 0 and tc % 16 == 0
    per = -(-h // tr) * -(-w // tc)
    assert plan.tiles == planes * per
    cover = np.zeros((h, w), np.int32)
    for t in range(per):
        r0, c0 = (t // -(-w // tc)) * tr, (t % -(-w // tc)) * tc
        cover[r0:r0 + tr, c0:c0 + tc] += 1
    assert (cover == 1).all()
    # the persistent grid: at most BLOCKS_PER_SM an SM, never more blocks
    # than tiles, and the largest tile that still gives every SM a block
    assert 1 <= plan.grid <= min(plan.tiles,
                                 lift97.SMS * lift97.BLOCKS_PER_SM)
    if plan.tile != lift97.TILES[axes][-1]:
        assert plan.tiles >= lift97.SMS
    bigger = lift97.TILES[axes][:lift97.TILES[axes].index(plan.tile)]
    for r, c in bigger:
        assert planes * -(-h // r) * -(-w // c) < lift97.SMS
    # two ring stages of the reach-padded tile, rows an odd number of
    # float4s, under a block's limit; the grid's blocks fit their SMs
    rows, cols, pitch = lift97.stage_shape(synth, axes, tr, tc)
    assert (plan.stage_rows, plan.pitch) == (rows, pitch)
    assert pitch >= cols and pitch % 4 == 0 and (pitch // 4) % 2 == 1
    assert rows == tr + (4 * lift97.REACH if "h" in axes else 0)
    assert plan.smem_bytes == 2 * rows * pitch * 4 <= lift97.BLOCK_SMEM
    blocks = -(-plan.grid // lift97.SMS)
    assert blocks * (plan.smem_bytes + 1024) <= lift97.SM_SMEM
    # 16-byte copies and float4 stores where the widths allow them
    assert plan.vec == (w % (8 if "w" in axes else 4) == 0)


def test_small_grids_take_small_tiles():
    """The deepest levels: 8x3x64x96 (eval) takes 32x32 tiles (144 blocks,
    where 64x64 gives 48), 4x3x32x32 (train) the smallest, 16x16."""
    assert lift97.launch_plan(False, "hw", 24, 64, 96).tile == (32, 32)
    assert lift97.launch_plan(True, "hw", 12, 32, 32).tile == (16, 16)
    assert lift97.launch_plan(False, "hw", 24, 512, 768).tile == (64, 64)
    for b, h, w in ((chip_smoke.B, chip_smoke.H, chip_smoke.W),
                    (chip_smoke.CDF97_TRAIN_B, chip_smoke.TRAIN_P,
                     chip_smoke.TRAIN_P)):
        for n, c, hh, ww in chip_smoke.level_shapes(4, b, h, w):
            assert lift97.launch_plan(False, "hw", n * c, hh, ww).vec
    assert not lift97.launch_plan(False, "hw", 24, 64, 96, False).vec
    assert not lift97.launch_plan(True, "w", 1, 4, 12).vec   # 12 % 8


def test_tile_table_and_constants_match_the_kernel():
    src = _source()
    body = re.search(r"#define LIFT97_TILES\(SYN\)(.*?)\n\n", src, re.S)
    got = re.findall(r"entry<SYN, (\d), (\d+), (\d+)>", body.group(1))
    axes = {1: "h", 2: "w", 3: "hw"}
    table = {}
    for a, r, c in got:
        table.setdefault(axes[int(a)], []).append((int(r), int(c)))
    assert {k: tuple(v) for k, v in table.items()} == lift97.TILES
    for name, value in (("THREADS", lift97.THREADS),
                        ("REACH", lift97.REACH),
                        ("BLOCK_SMEM", lift97.BLOCK_SMEM)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert f"__launch_bounds__(THREADS, {lift97.BLOCKS_PER_SM})" in src


def test_ctypes_declaration_matches_the_c_entry_point():
    """The argument types the wrapper declares are the C function's, and
    ``LaunchArgs`` has the C struct's fields in its order and types (ctypes
    passes what it is told, so a missing or extra field shifts every later
    one)."""
    src = _source()
    params = re.search(r'extern "C" int lift97_level\(([^)]*)\)',
                       src).group(1)
    kinds = {"const LaunchArgs*": ctypes.POINTER(lift97.LaunchArgs),
             "void*": ctypes.c_void_p}
    want = [kinds[" ".join(p.split()[:-1])] for p in params.split(",")]
    fn = types.SimpleNamespace()
    lift97._declare(types.SimpleNamespace(lift97_level=fn))
    assert fn.argtypes == want and fn.restype is ctypes.c_int
    body = re.search(r"struct LaunchArgs \{(.*?)\};", src, re.S).group(1)
    scalar = {"int": ctypes.c_int, "float": ctypes.c_float,
              "long long": ctypes.c_longlong}
    fields = []
    for decl in body.split(";")[:-1]:
        kind, names = re.match(r"\s*(int|float|long long)\s+(.*)",
                               decl).groups()
        for name in names.split(","):
            m = re.match(r"\s*(\w+)(?:\[(\w+)\])?", name)
            n = {"STEPS": 4}.get(m.group(2), m.group(2))
            fields.append((m.group(1), scalar[kind] * int(n) if n
                           else scalar[kind]))
    got = lift97.LaunchArgs._fields_
    assert [f for f, _ in got] == [f for f, _ in fields]
    for (_, a), (_, b) in zip(got, fields):
        assert ctypes.sizeof(a) == ctypes.sizeof(b)
        assert getattr(a, "_type_", a) == getattr(b, "_type_", b)


def test_launch_args_lay_out_the_bands():
    """LL at base 0, the pack's HL, LH, HH channels (3c+1, 3c, 3c+2) at base
    1; one axis: low at base 0, high at base 1 in its parity's slot."""
    args = lift97._launch_args(False, "hw", 24, 64, 96, True,
                               lift97.FORWARD).contents
    n = 32 * 48
    assert list(args.base) == [0, 1, 1, 1]
    assert list(args.offset) == [0, n, 0, 2 * n]
    assert list(args.stride) == [n, 3 * n, 3 * n, 3 * n]
    assert (args.tile_r, args.tile_c, args.vec) == (32, 32, 1)
    assert list(args.kinds) == [k for k, _ in lift97.FORWARD.steps]
    h = lift97._launch_args(True, "h", 3, 10, 6, True, lift97.INVERSE).contents
    assert list(h.base) == [0, -1, 1, -1] and h.vec == 0
    assert list(h.stride) == [5 * 6] * 4
    assert list(lift97._launch_args(False, "w", 1, 7, 10, True,
                                    lift97.FORWARD).contents.base) \
        == [0, 1, -1, -1]
    with pytest.raises(ValueError, match="even"):
        lift97._launch_args(False, "hw", 1, 6, 5, True, lift97.FORWARD)


# --- the reach ----------------------------------------------------------------

@pytest.mark.parametrize("use", sorted(LADDERS))
def test_staged_reach_covers_the_ladders_support(use):
    """Unit impulses through the plain ladder in float64: an analysis pair
    i reads x only within pairs i - REACH .. i + REACH, and a synthesis
    pair i only low and high pairs within the same reach; F and I reach
    exactly REACH pairs, so the kernel stages no more than it needs."""
    ladder, n, i = LADDERS[use], 64, 16
    r = lift97.REACH
    if use in ANALYSIS:
        lo, hi = lift97.analysis_plain(torch.eye(n, dtype=torch.float64), 1,
                                       ladder)           # [k, i]: impulse k
        dep = (lo[:, i].abs() > 1e-12) | (hi[:, i].abs() > 1e-12)
        pairs = dep.nonzero().flatten() // 2
    else:
        eye = torch.eye(n // 2, dtype=torch.float64)
        zero = torch.zeros_like(eye)
        xl = lift97.synthesis_plain(eye, zero, 1, ladder)  # [k, x]: low k
        xh = lift97.synthesis_plain(zero, eye, 1, ladder)
        dep = (xl[:, 2 * i:2 * i + 2].abs() > 1e-12).any(1) \
            | (xh[:, 2 * i:2 * i + 2].abs() > 1e-12).any(1)
        pairs = dep.nonzero().flatten()
    assert int(pairs.min()) >= i - r and int(pairs.max()) <= i + r
    if use in ("F", "I"):
        assert int(pairs.max() - pairs.min()) == 2 * r


def test_reach_agrees_with_chip_smokes_filters():
    """chip_smoke.py's yardstick filters: the analysis taps span x[2i-4 ..
    2i+4] and the synthesis's start r0 samples from pair i, both inside
    the staged reach of REACH pairs."""
    wa, ws, r0 = chip_smoke.ladder_filters(torch, lift97)
    assert wa.shape == (2, 4 * lift97.REACH + 1)
    assert -2 * lift97.REACH <= r0 and r0 + ws.shape[1] - 1 \
        <= 2 * lift97.REACH + 1


# --- the tiling, emulated -------------------------------------------------------

def _window_steps(s, d, ladder, dim):
    """The ladder's steps on a staged window, as the kernel runs them: no
    wrap; an end pair that lacks a neighbour keeps its value."""
    s, d = s.clone(), d.clone()
    n = s.shape[dim]
    for kind, c in ladder.steps:
        if kind == lift97.P:
            d.narrow(dim, 0, n - 1).add_(
                c * (s.narrow(dim, 0, n - 1) + s.narrow(dim, 1, n - 1)))
        else:
            s.narrow(dim, 1, n - 1).add_(
                c * (d.narrow(dim, 0, n - 1) + d.narrow(dim, 1, n - 1)))
    return s, d


def _centre(t, dim, n):
    return t.narrow(dim, lift97.REACH, n)


def emulate_analysis(x, ladder, tile):
    """x (planes, h, w) -> {(ph, pw): band}, tile by tile as the kernel
    does: the staged window wraps, the ladder runs inside it, the centre is
    kept."""
    planes, h, w = x.shape
    tr, tc = tile
    rh = rw = 2 * lift97.REACH
    g_lo, g_hi = ladder.gains
    out = {(a, b): torch.zeros(planes, h // 2, w // 2, dtype=x.dtype)
           for a in (0, 1) for b in (0, 1)}
    for r0 in range(0, h, tr):
        for c0 in range(0, w, tc):
            rows = torch.arange(r0 - rh, r0 + tr + rh) % h
            cols = torch.arange(c0 - rw, c0 + tc + rw) % w
            win = x[:, rows][:, :, cols]
            s, d = _window_steps(win[:, 0::2], win[:, 1::2], ladder, 1)
            row_bands = (_centre(s, 1, tr // 2) * g_lo,
                         _centre(d, 1, tr // 2) * g_hi)
            i0, j0 = r0 // 2, c0 // 2
            ni, nj = min(tr // 2, h // 2 - i0), min(tc // 2, w // 2 - j0)
            for ph, band in enumerate(row_bands):
                s, d = _window_steps(band[:, :, 0::2], band[:, :, 1::2],
                                     ladder, 2)
                for pw, v in enumerate((_centre(s, 2, tc // 2) * g_lo,
                                        _centre(d, 2, tc // 2) * g_hi)):
                    out[ph, pw][:, i0:i0 + ni, j0:j0 + nj] = v[:, :ni, :nj]
    return out


def emulate_synthesis(bands, ladder, tile):
    """{(ph, pw): band (planes, oh, ow)} -> x (planes, 2oh, 2ow), tile by
    tile: W of both row bands over the window's rows, then H."""
    planes, oh, ow = bands[0, 0].shape
    h, w = 2 * oh, 2 * ow
    tr, tc = tile
    r = lift97.REACH
    g_lo, g_hi = ladder.gains
    x = torch.zeros(planes, h, w, dtype=bands[0, 0].dtype)
    for r0 in range(0, h, tr):
        for c0 in range(0, w, tc):
            i0, j0 = r0 // 2, c0 // 2
            rows = torch.arange(i0 - r, i0 + tr // 2 + r) % oh
            cols = torch.arange(j0 - r, j0 + tc // 2 + r) % ow
            row_bands = []
            for ph in (0, 1):
                s, d = _window_steps(bands[ph, 0][:, rows][:, :, cols] * g_lo,
                                     bands[ph, 1][:, rows][:, :, cols] * g_hi,
                                     ladder, 2)
                row_bands.append(torch.stack(
                    [_centre(s, 2, tc // 2), _centre(d, 2, tc // 2)],
                    3).flatten(2))
            s, d = _window_steps(row_bands[0] * g_lo, row_bands[1] * g_hi,
                                 ladder, 1)
            tile_x = torch.stack([_centre(s, 1, tr // 2),
                                  _centre(d, 1, tr // 2)], 2).flatten(1, 2)
            nr, nc = min(tr, h - r0), min(tc, w - c0)
            x[:, r0:r0 + nr, c0:c0 + nc] = tile_x[:, :nr, :nc]
    return x


def _split(ll, pack):
    """LL and the pack -> {(ph, pw): band} over planes (B*C)."""
    lh, hl, hh = pdwt.unpack_details(pack)
    flat = lambda t: t.reshape(-1, *t.shape[2:])  # noqa: E731
    return {(0, 0): flat(ll), (0, 1): flat(hl), (1, 0): flat(lh),
            (1, 1): flat(hh)}


# one pair; planes smaller than a tile; W % 4 != 0; ragged tiles
EMULATED = [(1, 1, 2, 2), (2, 3, 6, 10), (1, 2, 12, 6), (1, 1, 34, 18),
            (1, 1, 130, 34)]


@pytest.mark.parametrize("tile", lift97.TILES["hw"])
@pytest.mark.parametrize("shape", EMULATED)
def test_tiled_emulation_matches_the_plain_level(shape, tile):
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(*shape))
    planes = shape[0] * shape[1]
    for use in ANALYSIS:
        ladder = LADDERS[use]
        ll, pack = pdwt.level_analysis_plain(x, ladder)
        got = emulate_analysis(x.reshape(planes, *shape[2:]), ladder, tile)
        for key, want in _split(ll, pack).items():
            assert torch.allclose(got[key], want, rtol=0, atol=1e-12), \
                (use, key)
    ll, pack = pdwt.level_analysis_plain(x)
    for use in ("I", "F_T"):
        ladder = LADDERS[use]
        want = pdwt.level_synthesis_plain(ll, pack, ladder)
        got = emulate_synthesis(_split(ll, pack), ladder, tile)
        assert torch.allclose(got, want.reshape(planes, *shape[2:]), rtol=0,
                              atol=1e-12), use


# --- the level Functions against the JAX package ---------------------------

def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@jax.jit
def _jax_level(x):
    ll, lh, hl, hh = jdwt.dwt97_level(x)
    return ll, jdwt.pack_details(lh, hl, hh)


@jax.jit
def _jax_ilevel(ll, pack):
    return jdwt.idwt97_level(ll, *jdwt.unpack_details(pack))


@pytest.mark.parametrize("size", [32, 64])
def test_level_functions_match_jax(size):
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size + 16, 3).astype(np.float32)
    want_ll, want_pack = _jax_level(jnp.asarray(x))
    ll, pack = pdwt.dwt97_level(nchw(x))
    assert ll.shape == (2, 3, size // 2, size // 2 + 8)
    assert pack.shape == (2, 9, size // 2, size // 2 + 8)
    assert rel_err(nhwc(ll), want_ll) <= LADDER_TOL
    assert rel_err(nhwc(pack), want_pack) <= LADDER_TOL
    back = pdwt.idwt97_level(nchw(np.asarray(want_ll)),
                             nchw(np.asarray(want_pack)))
    assert rel_err(nhwc(back), _jax_ilevel(want_ll, want_pack)) <= LADDER_TOL
    assert rel_err(nhwc(back), x) <= LADDER_TOL


@pytest.mark.parametrize("levels,size", [(2, 32), (3, 64)])
def test_level_gradients_match_jax_vjp(levels, size):
    rng = np.random.RandomState(levels)
    x = rng.randn(2, size, size, 3).astype(np.float32)

    def forward(a):
        return jdwt.dwt97_forward(a, levels)

    @jax.jit
    def jax_side(a, g_fwd, g_inv):
        outs, vjp = jax.vjp(forward, a)
        _, vjp_inv = jax.vjp(jdwt.dwt97_inverse, *outs)
        return outs, vjp(g_fwd)[0], vjp_inv(g_inv)

    ll_s, highs_s = jax.eval_shape(forward, jnp.asarray(x))
    g_ll = rng.randn(*ll_s.shape).astype(np.float32)
    g_highs = [rng.randn(*h.shape).astype(np.float32) for h in highs_s]
    gy = rng.randn(*x.shape).astype(np.float32)
    (ll_w, highs_w), want_gx, (want_gll, want_gh) = jax_side(
        jnp.asarray(x), (jnp.asarray(g_ll), [jnp.asarray(g) for g in g_highs]),
        jnp.asarray(gy))

    xt = nchw(x).requires_grad_(True)
    ll, highs = pdwt.dwt97_forward(xt, levels)
    assert len(highs) == levels
    torch.autograd.backward([ll, *highs],
                            [nchw(g_ll)] + [nchw(g) for g in g_highs])
    assert rel_err(nhwc(xt.grad), want_gx) <= LADDER_TOL
    llt = nchw(np.asarray(ll_w)).requires_grad_(True)
    hts = [nchw(np.asarray(h)).requires_grad_(True) for h in highs_w]
    # a non-contiguous incoming gradient
    g_in = nchw(gy).transpose(2, 3).contiguous().transpose(2, 3)
    assert not g_in.is_contiguous()
    pdwt.dwt97_inverse(llt, hts).backward(g_in)
    assert rel_err(nhwc(llt.grad), want_gll) <= LADDER_TOL
    for g, w in zip(hts, want_gh):
        assert rel_err(nhwc(g.grad), w) <= LADDER_TOL


def test_level_backward_takes_a_missing_gradient():
    """Only LL reaches the loss: the pack's gradient is None and counts as
    zeros, as jax.vjp with a zero cotangent for the pack."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, 32, 32, 3).astype(np.float32)
    g_ll = rng.randn(1, 16, 16, 3).astype(np.float32)
    _, vjp = jax.vjp(_jax_level, jnp.asarray(x))
    want = vjp((jnp.asarray(g_ll), jnp.zeros((1, 16, 16, 9), jnp.float32)))[0]
    xt = nchw(x).requires_grad_(True)
    ll, _ = pdwt.dwt97_level(xt)
    (ll * nchw(g_ll)).sum().backward()
    assert rel_err(nhwc(xt.grad), want) <= LADDER_TOL


def test_level_refuses_odd_sides_and_mismatched_packs():
    with pytest.raises(ValueError, match="even"):
        pdwt.dwt97_level(torch.zeros(1, 3, 6, 5))
    with pytest.raises(ValueError, match="differ"):
        pdwt.idwt97_level(torch.zeros(1, 3, 4, 4), torch.zeros(1, 6, 4, 4))
