"""The hand-written kernels against their plain versions, on the card:
conv3x3_halo forward and backward, and the CDF 9/7 ladder's analysis and
synthesis kernels in all four uses. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Skips where there is no CUDA device (as on the CPU test machines).
"""

import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv3x3_halo as conv, dwt97, lift97)

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
    conv.launches = 0
    with torch.no_grad():
        got = conv.conv3x3_halo(x, wt, dtype)
    torch.cuda.synchronize()
    assert conv.launches == 1
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
    conv.launches = 0
    y = conv.conv3x3_halo(x, wt, dtype)
    assert conv.launches == 1
    y.backward(dy)
    torch.cuda.synchronize()
    assert conv.launches == 2            # forward and dx
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
    conv.launches = 0
    y = conv.conv3x3_halo(x.detach(), wt, dtype)
    torch.autograd.grad(y, wt, dy)
    assert conv.launches == 1


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
