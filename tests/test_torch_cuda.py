"""The hand-written kernels against their plain versions, on the card:
the 3x3 conv Function forward and backward in both operand types (fp32:
conv3x3_halo; bf16: the tensor-core conv_v2), each conv kernel alone, the
fp32 grouped 1x1 conv (conv1x1g) forward and backward and ``Conv2d``'s
dispatch to it, and
the CDF 9/7 ladder's analysis and synthesis kernels in all four uses, along
one axis and over a whole level (adjoints, repeats, the launches of the
multi-level transform and its backward); the tree-based entropy models
(onlyEZWT, ZTBlock) in the flagship codec on the card against the CPU, with
the kernels' launches counted per model and dtype, and their coding path's
parameter passes on the card; the quincunx lifting nets of the lambda=400
snapshot on kernel 1 (the same bits twice, card against CPU, a stream
decoded twice to the same bits) and the other transforms on the card; the
CUDA graph of ``steps_per_call`` train steps against eager steps. Imports
no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Skips where there is no CUDA device (as on the CPU test machines).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
    codec_coder)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
    codec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv1x1g, conv3x3_halo as conv, conv_v2, dwt97, fast_conv, lift97)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    data, state)

# max |kernel - plain| / max |plain|: fp32 sums of the same exact products
# in another order
TOL = 1e-4


# dk in bf16: the product sums B*H*W exact bf16 products in fp32 on the
# tensor cores, the plain version the same products in a full-fp32 matmul;
# only the order (and the tensor cores' truncation) of the fp32 sums differs
DK_BF16_TOL = 1e-3

SHAPES = [
    (2, 13, 16, 3, 8),      # ragged rows, narrow in
    (1, 17, 35, 32, 70),    # ragged rows and columns, two Cout tiles
    (2, 9, 7, 243, 3),      # plc width in, narrow out, image < one tile
    (1, 64, 96, 96, 192),   # a Berk AE layer
]


def kernel_of(dtype):
    """The module whose kernel the Function launches for ``dtype``."""
    return conv_v2 if dtype == torch.bfloat16 else conv


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False  # a full fp32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_kernel_matches_plain(card, dtype, b, h, w, cin, cout):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(b, cin, h, w).astype(np.float32)).to(card)
    wt = torch.from_numpy((rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin))
                          .astype(np.float32)).to(card)
    mod = kernel_of(dtype)
    conv.launches = conv_v2.launches = 0
    with torch.no_grad():
        got = conv.conv3x3_halo(x, wt, dtype)
    torch.cuda.synchronize()
    assert mod.launches == 1 and conv.launches + conv_v2.launches == 1
    assert got.dtype == torch.float32 and got.shape == (b, cout, h, w)
    want = conv.conv3x3_halo_plain(x, wt, dtype)
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_kernel_backward_matches_plain(card, dtype, b, h, w, cin, cout):
    """dx through the kernel (one launch, Cin and Cout swapped) and dk, the
    matrix product, against ``conv3x3_halo_bwd_plain``; dy arrives in the
    standard (not channels_last) layout."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(b, cin, h, w).astype(np.float32)).to(card)
    wt = torch.from_numpy((rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin))
                          .astype(np.float32)).to(card)
    dy = torch.from_numpy(rng.randn(b, cout, h, w).astype(np.float32)).to(card)
    x.requires_grad_(True)
    wt.requires_grad_(True)
    mod = kernel_of(dtype)
    conv.launches = conv_v2.launches = 0
    y = conv.conv3x3_halo(x, wt, dtype)
    assert mod.launches == 1
    y.backward(dy)
    torch.cuda.synchronize()
    assert mod.launches == 2             # forward and dx
    assert conv.launches + conv_v2.launches == 2
    want_dx, want_dk = conv.conv3x3_halo_bwd_plain(x.detach(), wt.detach(),
                                                   dy, dtype)
    want_y = conv.conv3x3_halo_plain(x.detach(), wt.detach(), dtype)
    assert ((y.detach() - want_y).abs().max() / want_y.abs().max()
            ).item() < TOL               # the forward under autograd too
    assert x.grad.dtype == wt.grad.dtype == torch.float32
    assert x.grad.shape == x.shape and wt.grad.shape == wt.shape
    dx_err = (x.grad - want_dx).abs().max() / want_dx.abs().max()
    dk_err = (wt.grad - want_dk).abs().max() / want_dk.abs().max()
    assert dx_err.item() < TOL
    assert dk_err.item() < (DK_BF16_TOL if dtype == torch.bfloat16 else TOL)
    # a weight-only gradient launches no dx kernel
    mod.launches = 0
    y = conv.conv3x3_halo(x.detach(), wt, dtype)
    torch.autograd.grad(y, wt, dy)
    assert mod.launches == 1


# conv_v2 alone: every width class of the flagship's bf16 convs (Cin 1, 3,
# 32, 96, 192, 243; Cout 1, 3, 32, 96, 192, 243), ragged tiles both ways
V2_SHAPES = [
    (2, 13, 40, 3, 96),     # narrow in (K padded from 3 to 16), ragged rows
    (1, 17, 35, 32, 70),    # ragged rows and columns, two Cout tiles
    (2, 9, 7, 243, 3),      # plc width in (last K chunk of 3), Cout 3
    (1, 20, 33, 96, 192),   # a Berk AE layer, ragged columns
    (1, 16, 64, 192, 96),
    (2, 12, 20, 1, 32),     # the LL AE's ends: 1 -> 32
    (1, 11, 18, 32, 1),     # and 32 -> 1
    (1, 8, 32, 3, 243),     # plc's first layer
    (1, 5, 70, 32, 64),     # W above one 64-pixel segment, ragged
    (2, 6, 130, 16, 8),     # three segments across, Cout 8 (N tile 8)
    (1, 1, 40, 96, 192),    # H = 1: every tap row but one is padding
    (2, 7, 2, 32, 9),       # an image narrower than the halo, Cout 9
    (1, 9, 20, 64, 200),    # Cout 200: two N tiles of 128
    (3, 10, 24, 96, 243),   # B = 3, Cout 243 (two N tiles of 128; its dx
                            # 243 -> 96, 16 K steps)
    (1, 6, 20, 16, 300),    # Cout 300: three N tiles of 128
]


def misaligned(t):
    """``t`` (channels_last) copied into storage that starts one element
    (2 bytes in bf16, 4 in fp32) past a 16-byte boundary."""
    b, c, h, w = t.shape
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(b, h, w, c).permute(0, 3, 1, 2)
    out.copy_(t)
    assert out.data_ptr() % 16 and out.is_contiguous(
        memory_format=torch.channels_last)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout", V2_SHAPES)
def test_conv_v2_matches_plain_forward_and_dx(card, b, h, w, cin, cout):
    """Direct launches: the forward, and dx (the same kernel on the
    flipped, swapped weight), against ``conv_v2_plain``; then the forward
    again on an x whose storage is not 16-byte aligned, which must give
    the same result."""
    rng = np.random.RandomState(cin * cout + h)
    x = torch.from_numpy(rng.randn(b, cin, h, w).astype(np.float32)).to(card)
    wt = torch.from_numpy((rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin))
                          .astype(np.float32)).to(card)
    dy = torch.from_numpy(rng.randn(b, cout, h, w).astype(np.float32)).to(card)
    cl = torch.channels_last
    conv_v2.launches = conv_v2.launches_dx = 0
    got = conv_v2.launch_kernel(x.to(torch.bfloat16).contiguous(memory_format=cl),
                                conv.tap_major(wt, torch.bfloat16))
    wdx = conv.flip_swap(wt)
    got_dx = conv_v2.launch_kernel(
        dy.to(torch.bfloat16).contiguous(memory_format=cl),
        conv.tap_major(wdx, torch.bfloat16), dx=True)
    torch.cuda.synchronize()
    assert (conv_v2.launches, conv_v2.launches_dx) == (2, 1)
    for g, want in ((got, conv_v2.conv_v2_plain(x, wt)),
                    (got_dx, conv_v2.conv_v2_plain(dy, wdx))):
        assert g.dtype == torch.float32 and g.shape == want.shape
        assert g.is_contiguous(memory_format=cl)
        err = (g - want).abs().max().item() / want.abs().max().item()
        assert err < TOL
    again = conv_v2.launch_kernel(misaligned(x.to(torch.bfloat16).contiguous(
        memory_format=cl)), conv.tap_major(wt, torch.bfloat16))
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_bf16_function_on_the_card_runs_only_conv_v2(card, monkeypatch):
    """bf16 on the card: forward and dx through conv_v2, never the plain
    versions nor the fp32 kernel; a wrong operand raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a bf16 CUDA conv left the conv_v2 kernel")

    for mod, name in ((conv, "launch_kernel"), (conv, "conv3x3_halo_plain"),
                      (conv_v2, "conv_v2_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.randn(2, 96, 24, 40, device=card, requires_grad=True)
    wt = torch.randn(192, 96, 3, 3, device=card, requires_grad=True)
    conv_v2.launches = conv_v2.launches_dx = 0
    y = conv.conv3x3_halo(x, wt, torch.bfloat16)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    assert (conv_v2.launches, conv_v2.launches_dx) == (2, 1)
    assert x.grad.shape == x.shape and wt.grad.shape == wt.shape
    with pytest.raises(ValueError, match="bf16"):
        conv_v2.launch_kernel(x.detach().contiguous(
            memory_format=torch.channels_last), conv.tap_major(wt, torch.float32))
    with pytest.raises(ValueError, match="channels_last"):
        conv_v2.launch_kernel(x.detach().to(torch.bfloat16),
                              conv.tap_major(wt, torch.bfloat16))


# kernel 1 alone (fp32 operands): its copy paths (16-byte where Cin is a
# multiple of 4, 4-byte otherwise), each of its tiles and their edges,
# ragged tiles both ways; each case runs forward and dx (Cin and Cout
# swapped). Grids of fewer than 132 blocks take the small-grid tiles (N
# tiles of 8 and 32, 4 pixels a thread), so the first cases are sized to
# get the usual tiles (N tiles 8, 32, 64, 96, 128, 8 pixels a thread).
K1_SHAPES = [
    (6, 64, 96, 3, 96),     # narrow in (4-byte copies): N tile 96
    (5, 64, 100, 192, 96),  # a Berk AE layer, ragged columns; its dx
                            # 96 -> 192 in two N tiles of 96
    (4, 70, 64, 243, 243),  # plc: two N tiles of 128, ragged rows, Cin 243
                            # (4-byte copies, a last chunk of 3)
    (6, 64, 96, 64, 95),    # the N tile's edges: 95 in one tile of 96,
    (6, 64, 96, 64, 97),    # 97 in one of 128,
    (3, 64, 96, 64, 129),   # 129 in two of 96
    (6, 64, 96, 32, 64),    # N tile 64; its dx 64 -> 32 in one of 32
    (9, 64, 128, 1, 32),    # the LL AE's first layer; its dx 32 -> 1 in
                            # an N tile of 8
    (9, 64, 128, 96, 3),    # Cout 3: N tile 8
    (2, 13, 40, 3, 96),     # small grids from here on: ragged rows
    (1, 17, 35, 32, 70),    # ragged rows and columns
    (2, 9, 7, 243, 3),      # Cin 243, Cout 3, an image below one tile
    (1, 20, 33, 96, 192),
    (1, 16, 64, 192, 96),
    (2, 12, 20, 1, 32),
    (1, 11, 18, 32, 1),
    (1, 10, 40, 3, 243),
    (1, 9, 20, 243, 243),
    (1, 1, 40, 96, 192),    # H = 1: every tap row but one is padding
    (2, 7, 2, 32, 9),       # W = 2
    (3, 10, 24, 96, 243),   # B = 3, Cout 243; its dx 243 -> 96
    # the restoration nets' shapes (iwave, DnCNN, DUDnCNN at full
    # resolution; DIDN at 1/2, 1/4 and 1/8, and its 16 -> 3 tail)
    (6, 64, 96, 3, 64),     # the head; its dx 64 -> 3
    (6, 64, 96, 64, 64),    # the 64-wide body
    (2, 64, 96, 16, 3),     # DIDN's tail after the pixel shuffle
    (4, 32, 48, 128, 128),
    (4, 16, 24, 256, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout", K1_SHAPES)
def test_conv3x3_halo_matches_plain_forward_and_dx(card, b, h, w, cin, cout):
    """Direct launches of kernel 1 in fp32: the forward, and dx (the same
    kernel on the flipped, swapped weight), against the plain version; the
    same forward again gives bit-identical output, and so does an x whose
    storage is not 16-byte aligned (the 4-byte copy path)."""
    rng = np.random.RandomState(cin * cout + h + 7)
    x = torch.from_numpy(rng.randn(b, cin, h, w).astype(np.float32)).to(card)
    wt = torch.from_numpy((rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin))
                          .astype(np.float32)).to(card)
    dy = torch.from_numpy(rng.randn(b, cout, h, w).astype(np.float32)).to(card)
    cl = torch.channels_last
    f32 = torch.float32
    xl = x.contiguous(memory_format=cl)
    w9 = conv.tap_major(wt, f32)
    wdx = conv.flip_swap(wt)
    conv.launches = 0
    got = conv.launch_kernel(xl, w9)
    got_dx = conv.launch_kernel(dy.contiguous(memory_format=cl),
                                conv.tap_major(wdx, f32))
    torch.cuda.synchronize()
    assert conv.launches == 2
    for g, want in ((got, conv.conv3x3_halo_plain(x, wt, f32)),
                    (got_dx, conv.conv3x3_halo_plain(dy, wdx, f32))):
        assert g.dtype == f32 and g.shape == want.shape
        assert g.is_contiguous(memory_format=cl)
        err = (g - want).abs().max().item() / want.abs().max().item()
        assert err < TOL
    assert torch.equal(conv.launch_kernel(xl, w9), got)
    assert torch.equal(conv.launch_kernel(misaligned(xl), w9), got)


@pytest.mark.cuda
def test_conv3x3_halo_refuses_bf16_operands_on_the_card(card):
    x = torch.randn(1, 8, 6, 6, device=card).contiguous(
        memory_format=torch.channels_last)
    w9 = conv.tap_major(torch.randn(4, 8, 3, 3, device=card), torch.bfloat16)
    with pytest.raises(ValueError, match="conv_v2"):
        conv.launch_kernel(x.to(torch.bfloat16), w9)


# the fp32 grouped 1x1 conv (conv1x1g): (B, H, W, Cin, Cout, groups) at the
# main path's group shapes (ZTsep's cgp, the pointwise AEs) on small planes,
# a ragged plane (4-byte copies) and a plane of one pixel
C1_SHAPES = [
    (2, 16, 24, 486, 486, 3), (2, 16, 24, 486, 162, 3),
    (2, 16, 24, 162, 54, 3), (2, 16, 24, 54, 6, 3),
    (2, 32, 48, 9, 288, 9), (2, 32, 48, 288, 288, 9), (2, 32, 48, 288, 9, 9),
    (3, 13, 7, 96, 96, 3), (1, 1, 1, 3, 96, 3), (2, 37, 41, 486, 486, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,groups", C1_SHAPES)
def test_conv1x1g_matches_plain_forward_and_backward(card, b, h, w, cin, cout,
                                                     groups):
    """The Function on the card: the forward with its fused bias, and the
    backward (dx through the kernel on the transposed weight, dk the batched
    product, db the sum) against the plain versions; one launch forward and
    one for dx; the same forward again gives bit-identical output, and so
    does an x that is a channel slice of a wider tensor (strided rows) and
    one whose storage is not 16-byte aligned (the 4-byte copies)."""
    rng = np.random.RandomState(cin * cout + h)
    f32 = np.float32
    x = torch.from_numpy(rng.randn(b, cin, h, w).astype(f32)).to(card)
    wt = torch.from_numpy((rng.randn(cout, cin // groups, 1, 1)
                           / np.sqrt(cin // groups)).astype(f32)).to(card)
    bias = torch.from_numpy(rng.randn(cout).astype(f32)).to(card)
    dy = torch.from_numpy(rng.randn(b, cout, h, w).astype(f32)).to(card)
    leaves = [t.clone().requires_grad_(True) for t in (x, wt, bias)]
    conv1x1g.launches = conv1x1g.launches_dx = 0
    y = conv1x1g.conv1x1g(*leaves, groups)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (conv1x1g.launches, conv1x1g.launches_dx) == (2, 1)
    want = conv1x1g.conv1x1g_plain(x, wt, bias, groups)
    wants = conv1x1g.conv1x1g_bwd_plain(x, wt, dy, groups)
    for got, ref in ((y.detach(), want), *zip(
            [t.grad for t in leaves], wants)):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert (got - ref).abs().max().item() / ref.abs().max().item() < TOL
    with torch.no_grad():
        again = conv1x1g.conv1x1g(x, wt, bias, groups)
        wide = torch.cat([x, x[:, :4]], 1)[:, :cin]
        buf = torch.empty(x.numel() + 1, device=card)[1:].view(x.shape)
        buf.copy_(x)
        assert torch.equal(again, y.detach())
        assert torch.equal(conv1x1g.conv1x1g(wide, wt, bias, groups), again)
        assert torch.equal(conv1x1g.conv1x1g(buf, wt, bias, groups), again)


@pytest.mark.cuda
def test_conv2d_runs_conv1x1g_only_for_fp32_grouped_1x1(card):
    """An fp32 grouped 1x1 ``Conv2d`` on the card launches the kernel (and
    its dx in the backward); its bf16 counterpart and a groups-1 1x1 conv
    do not."""
    x = torch.randn(2, 96, 8, 8, device=card, requires_grad=True)
    conv1x1g.launches = conv1x1g.launches_dx = 0
    for layer in (fast_conv.Conv2d(96, 96, 1, groups=3,
                                   dtype=torch.bfloat16),
                  fast_conv.Conv2d(96, 96, 1)):
        layer.to(card)(x).sum().backward()
    assert conv1x1g.launches == 0
    layer = fast_conv.Conv2d(96, 96, 1, groups=3).to(card)
    torch.nn.init.normal_(layer.weight)
    y = layer(x)
    y.sum().backward()
    torch.cuda.synchronize()
    assert (conv1x1g.launches, conv1x1g.launches_dx) == (2, 1)
    want = F.conv2d(x.detach(), layer.weight.detach(), layer.bias.detach(),
                    groups=3)
    assert (y.detach() - want).abs().max().item() \
        / want.abs().max().item() < TOL


# the ladder: max |kernel - plain| / max |plain|; the same fp32 expressions,
# which the kernel may contract into FMAs
LADDER_TOL = 1e-5
LADDER_SHAPES = [
    (2, 3, 64, 96),     # whole tiles along W, one tile along H
    (1, 2, 130, 34),    # ragged pair tiles, inner < one column tile
    (3, 1, 2, 6),       # one pair along H: every neighbour wraps to itself
    (1, 3, 300, 258),   # several pair tiles both ways
]
USES = [("F", lift97.FORWARD), ("I", lift97.INVERSE),
        ("F_T", lift97.FORWARD_T), ("I_T", lift97.INVERSE_T)]


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("shape", LADDER_SHAPES)
def test_ladder_kernels_match_plain(card, shape, dim):
    rng = np.random.RandomState(sum(shape) + dim)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(card)
    lo, hi = lift97.analysis_plain(x, dim)
    for name, ladder in USES:
        lift97.launches_lift = lift97.launches_ilift = 0
        if ladder in (lift97.FORWARD, lift97.INVERSE_T):
            got = lift97.launch_analysis(x, dim, ladder)
            want = lift97.analysis_plain(x, dim, ladder)
        else:
            got = (lift97.launch_synthesis(lo, hi, dim, ladder),)
            want = (lift97.synthesis_plain(lo, hi, dim, ladder),)
        torch.cuda.synchronize()
        assert (lift97.launches_lift, lift97.launches_ilift) == (
            (1, 0) if len(got) == 2 else (0, 1)), name
        for g, w in zip(got, want):
            err = (g - w).abs().max().item() / w.abs().max().item()
            assert err < LADDER_TOL, (name, err)


# level kernels beyond LADDER_SHAPES: W % 4 != 0 (scalar copies), the CDF97
# eval path's deepest level (small tiles), the train path's deepest
LEVEL_SHAPES = [
    (2, 1, 10, 22),
    (8, 3, 64, 96),
    (4, 3, 32, 32),
]


def _fdot(a, b):
    return float((a.double() * b.double()).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LADDER_SHAPES + LEVEL_SHAPES)
def test_level_kernels_match_plain(card, shape):
    """One launch a level in all four uses against the plain level, the
    adjoint identities <A x, y> = <x, A^T y> of the analysis and of the
    synthesis level, and bit-identical outputs from run to run."""
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(card)
    b, c, h, w = shape
    half = (b, c, h // 2, w // 2)
    ll = torch.from_numpy(rng.randn(*half).astype(np.float32)).to(card)
    pack = torch.from_numpy(rng.randn(b, 3 * c, h // 2, w // 2).astype(
        np.float32)).to(card)
    got = {}
    for name, ladder in USES:
        lift97.launches_lift = lift97.launches_ilift = 0
        if ladder in (lift97.FORWARD, lift97.INVERSE_T):
            got[name] = lift97.launch_level_analysis(x, ladder)
            again = lift97.launch_level_analysis(x, ladder)
            want = dwt97.level_analysis_plain(x, ladder)
            counts = (2, 0)
        else:
            got[name] = (lift97.launch_level_synthesis(ll, pack, ladder),)
            again = (lift97.launch_level_synthesis(ll, pack, ladder),)
            want = (dwt97.level_synthesis_plain(ll, pack, ladder),)
            counts = (0, 2)
        torch.cuda.synchronize()
        assert (lift97.launches_lift, lift97.launches_ilift) == counts, name
        for g, a, w_ in zip(got[name], again, want):
            assert g.shape == w_.shape, name
            err = (g - w_).abs().max().item() / w_.abs().max().item()
            assert err < LADDER_TOL, (name, err)
            assert torch.equal(g, a), name
    fx, (fty,) = got["F"], got["F_T"]
    lhs = _fdot(fx[0], ll) + _fdot(fx[1], pack)
    norm = (_fdot(fx[0], fx[0]) + _fdot(fx[1], fx[1])) ** 0.5 \
        * (_fdot(ll, ll) + _fdot(pack, pack)) ** 0.5
    assert abs(lhs - _fdot(x, fty)) <= LADDER_TOL * norm
    (ix,), itx = got["I"], got["I_T"]
    lhs = _fdot(ix, x)
    norm = _fdot(ix, ix) ** 0.5 * _fdot(x, x) ** 0.5
    assert abs(lhs - _fdot(ll, itx[0]) - _fdot(pack, itx[1])) \
        <= LADDER_TOL * norm


@pytest.mark.cuda
def test_ladder_on_the_card_never_takes_the_plain_path(card, monkeypatch):
    """dwt97 forward and inverse, and their gradients, on a CUDA tensor:
    one launch a level each way, the backward through the kernels, and
    the plain ladder never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain ladder")

    for name in ("analysis_plain", "synthesis_plain"):
        monkeypatch.setattr(lift97, name, refuse)
    for name in ("level_analysis_plain", "level_synthesis_plain"):
        monkeypatch.setattr(dwt97, name, refuse)
    x = torch.rand(2, 3, 32, 48, device=card, requires_grad=True)
    lift97.launches_lift = lift97.launches_ilift = 0
    ll, highs = dwt97.dwt97_forward(x, 3)
    y = dwt97.dwt97_inverse(ll, highs)
    assert (lift97.launches_lift, lift97.launches_ilift) == (3, 3)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    # the inverse's backward runs the analysis kernel, the forward's the
    # synthesis kernel, one launch a level each
    assert (lift97.launches_lift, lift97.launches_ilift) == (6, 6)
    assert (y - x).abs().max().item() < 1e-5
    assert (x.grad - 1).abs().max().item() < 1e-5   # the identity's gradient
    with pytest.raises(ValueError, match="even"):
        dwt97.lift97_1d(torch.zeros(1, 1, 6, 5, device=card), 3)
    with pytest.raises(ValueError, match="lifted length"):
        lift97.launch_analysis(torch.zeros(1, 1, 6, 5, device=card), 3)
    with pytest.raises(ValueError, match="contiguous"):
        lift97.launch_level_analysis(
            torch.zeros(1, 1, 8, 8, device=card).transpose(2, 3))


TREE_LEVELS = 3
TREE_RTOL = 1e-4      # eval RD terms, card vs CPU, fp32
TREE_XHAT_TOL = 1e-5  # mean |xhat_card - xhat_cpu|


def tree_launches(cfg):
    """(Berk AE, plc) dense 3x3 convs of one flagship eval step: 8 a scaling
    AE (one a level, one for LL) and, for onlyEZWT, 2 a finer level, on
    each of the 3 planes."""
    ae = 3 * 8 * (cfg.dwtlevels + 1)
    plc = 3 * 2 * (cfg.dwtlevels - 1) if cfg.entropy_layer == "onlyEZWT" \
        else 0
    return ae, plc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entropy_layer", [
    "onlyEZWT", "DWTConditioned2EntropyLayerZTBlock"])
def test_tree_entropy_models_on_the_card(card, entropy_layer, dtype):
    """The flagship codec with onlyEZWT or ZTBlock, one 64x64 image: fp32
    on the card against the CPU; the kernels' launches per model and dtype
    (bf16: the AEs on conv_v2, onlyEZWT's fp32 plc on conv3x3_halo)."""
    cfg = config.flagship_config(entropy_layer=entropy_layer, dtype=dtype,
                                 dwtlevels=TREE_LEVELS)
    img = data.synthetic_natural_images(1, 64, seed=0)[0]
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0
    model = codec.CodecWrapper(cfg, generator=torch.Generator().manual_seed(0))
    want, want_xhat = state.make_eval_step(cfg, model, "cpu")(x)
    step = state.make_eval_step(cfg, model, card)
    conv.launches = conv_v2.launches = 0
    got, got_xhat = step(x)
    torch.cuda.synchronize()
    ae, plc = tree_launches(cfg)
    if dtype == "float32":
        assert (conv.launches, conv_v2.launches) == (ae + plc, 0)
        for k in ("loss", "mse", "rate1", "rate2"):
            a, b = float(getattr(got, k)), float(getattr(want, k))
            assert abs(a - b) <= TREE_RTOL * abs(b), k
        assert (got_xhat.cpu() - want_xhat).abs().mean().item() \
            < TREE_XHAT_TOL
    else:
        assert (conv.launches, conv_v2.launches) == (plc, ae)
        assert all(np.isfinite(float(v)) for v in got)


@pytest.mark.cuda
@pytest.mark.parametrize("entropy_layer", [
    "onlyEZWT", "DWTConditioned2EntropyLayerZTBlock"])
def test_tree_coding_parameter_passes_run_on_the_card(card, entropy_layer):
    """The decoder's (CDF indexes, mu) pass on the card against the CPU's,
    then one image's round trip on the card (lossless, or it raises)."""
    cfg = config.flagship_config(entropy_layer=entropy_layer,
                                 dwtlevels=TREE_LEVELS)
    model = codec.CodecWrapper(cfg, generator=torch.Generator().manual_seed(1))
    cpu = codec_coder.CodecCoder(cfg, model, "cpu")
    rng = np.random.RandomState(0)
    parent = np.round(rng.randn(1, 16, 16, 3) * 3).astype(np.float32)
    if entropy_layer == "onlyEZWT":
        args = ("level_params_from_parent", 1, parent)
    else:
        args = ("level_coset_params", 0, 2, parent, parent * 0.5, parent)
    want_idx, want_mu = cpu._dec_params(0, *args)
    gpu = codec_coder.CodecCoder(cfg, model, card)
    assert next(gpu.model.parameters()).is_cuda
    conv.launches = 0
    idx, mu = gpu._dec_params(0, *args)
    torch.cuda.synchronize()
    assert conv.launches == (2 if entropy_layer == "onlyEZWT" else 0)
    assert idx.dtype == np.int32 and idx.shape == want_idx.shape
    assert np.mean(idx == want_idx) >= 0.999
    assert np.abs(mu - want_mu).max() <= 1e-4 * np.abs(want_mu).max()
    img = data.synthetic_natural_images(1, 64, seed=2)[0]
    res = gpu.compress_decompress(img[None].astype(np.float32) / 255.0)
    assert np.isfinite(res.bpp) and res.bpp > 0 and np.isfinite(res.psnr)


QUINCUNX = dict(netType="QuincunxLifting", entropy_layer="factorized",
                autoencoder="SubbandAutoEncoder", clrch=3, dwtlevels=3,
                split_mode="hv", lif_prec_bits=8, num_lifting_perlayer=2,
                lambda_=400.0)


def quincunx_model():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = codec.CodecWrapper(config.Config(**QUINCUNX).validate())
    weights.load_flax_params(model, weights.load_npz(os.path.join(
        root, "results", "ckpt_snapshots", "quincunx_lam400.npz")))
    return model


@pytest.mark.cuda
def test_quincunx_lifting_on_kernel_1_gives_the_same_bits(card):
    """The lambda=400 snapshot's analysis on the card: every P/U conv on
    kernel 1 (72 launches), the same subbands bit for bit twice, rounded
    subbands equal to the CPU's in >= 99.9 % of elements (integer lifting
    may flip a grid step where a value sits within an ulp of a boundary);
    one plane's stream decodes twice to the same bits."""
    model = quincunx_model()
    img = data.synthetic_natural_images(1, 128, seed=4)[0]
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0 - 0.5
    with torch.inference_mode():
        want = model.codec.transform.encode(x)
        model.to(card)
        conv.launches = 0
        a = model.codec.transform.encode(x.to(card))
        torch.cuda.synchronize()
        assert conv.launches == 72
        b = model.codec.transform.encode(x.to(card))
    flat = [torch.cat([s[0].flatten().cpu()] + [t.flatten().cpu()
                                                for t in s[1]])
            for s in (want, a, b)]
    assert torch.equal(flat[1], flat[2])
    assert (flat[0].round() == flat[1].round()).double().mean() >= 0.999
    coder = codec_coder.CodecCoder(model.cfg, model, card)
    streams, _, xe_hat, xo_hats = coder.compress_plane(0, x.to(card))
    shapes = (xe_hat.shape, [t.shape for t in xo_hats])
    np.testing.assert_array_equal(coder.decompress_plane(0, streams, *shapes),
                                  coder.decompress_plane(0, streams, *shapes))


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["BasicWavelet", "AttentionWavelet",
                                 "AttentionWaveletPostProcessing"])
def test_other_transforms_on_the_card(card, net):
    """Seeded weights, fp32: the eval step on the card against the CPU, the
    ladder kernels launched once a level each way for the attention
    transforms (none for BasicWavelet), one train step finite."""
    cfg = config.Config(netType=net, entropy_layer="factorized", clrch=3,
                        dwtlevels=3, lambda_=400.0).validate()
    model = codec.CodecWrapper(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(data.synthetic_natural_images(1, 64, seed=1)[0]
                         ).permute(2, 0, 1)[None].float() / 255.0
    want, _ = state.make_eval_step(cfg, model, "cpu")(x)
    torch.backends.cudnn.allow_tf32 = False
    try:
        lift97.launches_lift = lift97.launches_ilift = 0
        got, _ = state.make_eval_step(cfg, model, card)(x)
        torch.cuda.synchronize()
        n = 0 if net == "BasicWavelet" else 3
        assert (lift97.launches_lift, lift97.launches_ilift) == (n, n)
        assert abs(float(got.loss) - float(want.loss)) \
            <= 1e-4 * abs(float(want.loss))
        step = state.make_train_step(cfg, model,
                                     state.make_optimizer(cfg, model), card)
        out, _ = step(x, torch.Generator().manual_seed(2), 1e-4, 1.0)
        assert torch.isfinite(out.loss)
    finally:
        torch.backends.cudnn.allow_tf32 = True


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["DnCNN", "iwave", "IRCNN", "DIDN",
                                  "DUDnCNN"])
def test_restoration_nets_on_the_card(card, kind):
    """Each restoration net, seeded, on the card against the CPU: the
    train-mode forward (and its running statistics), then the eval forward;
    every stride-1 undilated 3x3 conv on kernel 1."""
    import copy
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
        postprocess)
    cfg = config.flagship_config(postprocess=kind, resnetlevel=6)
    cpu = postprocess.make_postprocess(cfg, torch.Generator().manual_seed(2))
    gpu = copy.deepcopy(cpu).to(card)
    n = sum(isinstance(m, postprocess.FastConv3x3) for m in cpu.modules())
    if kind == "DIDN":
        n += 5 * 9                   # the shared reconstruction block, 6 uses
    x = torch.from_numpy(data.synthetic_natural_images(2, 32, seed=3)[0]
                         ).permute(2, 0, 1)[None].float() / 255.0
    with torch.no_grad():
        for train in (True, False):
            want = cpu(x, train)
            conv.launches = 0
            got = gpu(x.to(card), train).cpu()
            torch.cuda.synchronize()
            assert conv.launches == n
            err = ((got - x) - (want - x)).abs().max() / (want - x).abs().max()
            assert err.item() < TOL
    for (name, a), b in zip(gpu.named_buffers(), cpu.buffers()):
        assert (a.cpu() - b).abs().max() <= TOL * b.abs().max(), name


@pytest.mark.cuda
def test_entry_points_run_fp32_in_full_precision(card):
    """With PyTorch's defaults on entry (cuDNN may round fp32 convs to
    TF32), the coder and the eval step turn TF32 off, and the eval step on
    the card then matches the CPU's to fp32 rounding."""
    cfg = config.flagship_config(dwtlevels=2, lambda_=2000.0)
    model = codec.CodecWrapper(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(data.synthetic_natural_images(1, 64, seed=1)[0]
                         ).permute(2, 0, 1)[None].float() / 255.0
    want, _ = state.make_eval_step(cfg, model, "cpu")(x)
    for build in (lambda: codec_coder.CodecCoder(cfg, model, card),
                  lambda: state.make_eval_step(cfg, model, card)):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        build()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    got, _ = state.make_eval_step(cfg, model, card)(x)
    for k in ("loss", "mse", "rate1", "rate2"):
        assert abs(float(getattr(got, k)) - float(getattr(want, k))) \
            <= 1e-4 * abs(float(getattr(want, k))), k


@pytest.mark.cuda
def test_graph_chained_step_matches_eager_steps(card):
    """``steps_per_call``: two replays of the CUDA graph of k=3 flagship
    train steps (2 levels, 32x32, fp32, seeded weights) against 6 eager
    steps of the same model from the same state, both with the capturable
    Adam, cuDNN deterministic. The same kernels run on the same inputs in
    the same order, so rows and parameters agree within 1e-6 (relative; of
    each tensor's max |p|). The noise advances a replay: the second replay's
    rows differ from the first's on the same batches, and the generator
    ends where the eager steps leave theirs."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = config.Config(
            netType="LiftingBasedNeuralWaveletv4",
            entropy_layer="conditioned2ZTsepSubbands",
            autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=2,
            batch_size=2, patch_size=32, lambda_=100.0, learning_rate=1e-4,
            steps_per_call=3).validate()
        k = cfg.steps_per_call
        chunk = np.stack([np.stack(data.synthetic_images(2, 32, seed=i))
                          for i in range(k)])
        models = []
        for _ in range(2):
            model = codec.CodecWrapper(
                cfg, generator=torch.Generator().manual_seed(0)).to(card)
            models.append((model, state.make_optimizer(cfg, model,
                                                       capturable=True)))
        chained = state.make_chained_train_step(cfg, *models[0], card)
        assert chained.form == "graph"
        step = state.make_train_step(cfg, *models[1], card)
        gens = [torch.Generator(device=card).manual_seed(3)
                for _ in range(2)]
        got = [chained(chunk, gens[0], 1e-4, 1.0).cpu() for _ in range(2)]
        want = torch.tensor([[float(v) for v in step(
            torch.from_numpy(chunk[i].astype(np.float32) / 255.0).permute(
                0, 3, 1, 2), gens[1], 1e-4, 1.0)[0]]
            for _ in range(2) for i in range(k)])
        rows = torch.cat(got)
        assert float(((rows - want).abs() / want.abs()).max()) <= 1e-6
        for (name, p), q in zip(models[0][0].named_parameters(),
                                models[1][0].parameters()):
            d, q = (p - q).detach(), q.detach()
            gap = float(d.abs().max() / q.abs().max().clamp_min(1e-30))
            assert gap <= 1e-6, name
        assert not torch.equal(got[0], got[1])
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
        assert chained.replays == 2
    finally:
        torch.backends.cudnn.deterministic = old
