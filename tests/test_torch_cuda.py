"""The hand-written kernels against their plain versions, on the card:
the 3x3 conv Function forward and backward in both operand types (fp32:
conv3x3_halo; bf16: the tensor-core conv_v2), conv_v2 alone, and the CDF
9/7 ladder's analysis and synthesis kernels in all four uses. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Skips where there is no CUDA device (as on the CPU test machines).
"""

import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv3x3_halo as conv, conv_v2, dwt97, lift97)

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
    """``t`` (channels_last) copied into storage that starts 2 bytes past
    a 16-byte boundary."""
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


@pytest.mark.cuda
def test_ladder_on_the_card_never_takes_the_plain_path(card, monkeypatch):
    """dwt97 forward and inverse, and their gradients, on a CUDA tensor:
    three launches a level each way, the backward through the kernels, and
    the plain ladder never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain ladder")

    monkeypatch.setattr(lift97, "analysis_plain", refuse)
    monkeypatch.setattr(lift97, "synthesis_plain", refuse)
    x = torch.rand(2, 3, 32, 48, device=card, requires_grad=True)
    lift97.launches_lift = lift97.launches_ilift = 0
    ll, highs = dwt97.dwt97_forward(x, 3)
    y = dwt97.dwt97_inverse(ll, highs)
    assert (lift97.launches_lift, lift97.launches_ilift) == (9, 9)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    # the inverse's backward runs the analysis kernel, the forward's the
    # synthesis kernel
    assert (lift97.launches_lift, lift97.launches_ilift) == (18, 18)
    assert (y - x).abs().max().item() < 1e-5
    assert (x.grad - 1).abs().max().item() < 1e-5   # the identity's gradient
    with pytest.raises(ValueError, match="even"):
        dwt97.lift97_1d(torch.zeros(1, 1, 6, 5, device=card), 3)
    with pytest.raises(ValueError, match="lifted length"):
        lift97.launch_analysis(torch.zeros(1, 1, 6, 5, device=card), 3)
