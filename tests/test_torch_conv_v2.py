"""The bf16 3x3 conv of the port against the JAX package's single-product
Pallas conv, ``scripts/bench_pallas_v2.py::conv_v2``, run as a Pallas
kernel in interpret mode on the CPU.

``bench_pallas_v2.py`` runs its benchmark when imported, so only its
imports and function definitions are taken (parsed with ``ast``; the
compile-cache switch and the ``pallas_conv`` import left out) and executed
with ``pl`` bound to a namespace whose ``pallas_call`` interprets.

Tolerance: 1e-5 of max |y|. The products of bf16 operands are exact in
fp32; the sums of the two sides differ only in order.
"""

import ast
import functools
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv3x3_halo as conv, conv_v2)

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
    """The kernel's operands: Cin padded to a multiple of 16, the weight to
    the Cout tile (the smaller padding of 64 or 32, or 16 for Cout <= 16);
    the conv of the padded operands is the conv (zero channels add exact
    zeros; the CPU conv may sum the longer K in another order: 1e-6)."""
    rng = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rng.randn(2, cin, 5, 7).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(rng.randn(cout, cin, 3, 3).astype(np.float32))
    xp, wp, coutp, bn = conv_v2.padded_operands(
        x, conv.tap_major(wt, torch.bfloat16))
    cp = xp.shape[1]
    assert cp % 16 == 0 and coutp % bn == 0 and coutp - cout < bn
    assert coutp == (16 if cout <= 16 else
                     min(-(-cout // 64) * 64, -(-cout // 32) * 32))
    assert xp.is_contiguous(memory_format=torch.channels_last)
    assert wp.shape == (9, cp, coutp) and wp.is_contiguous()
    w4 = wp.float().reshape(3, 3, cp, coutp).permute(3, 2, 0, 1)
    got = torch.nn.functional.conv2d(xp.float(), w4, padding=1)
    assert torch.equal(got[:, cout:], torch.zeros_like(got[:, cout:]))
    want = conv_v2.conv_v2_plain(x.float(), wt)
    assert (got[:, :cout] - want).abs().max() <= 1e-6 * want.abs().max()
