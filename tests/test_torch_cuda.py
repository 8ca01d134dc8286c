"""The hand-written conv3x3_halo kernel, forward and backward, against its
plain versions, on the card. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Skips where there is no CUDA device (as on the CPU test machines).
"""

import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv3x3_halo as conv)

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
