"""The fp32 grouped 1x1 conv (``ops/conv1x1g.py``), checked on the CPU: the
plain version against ``F.conv2d`` at the main path's group shapes (ZTsep's
cgp stacks, the pointwise autoencoders) and on ragged planes, the
Function's dx, dk and db against autograd of ``F.conv2d``, ``Conv2d``'s
dispatch (which layers take the kernel on a CUDA tensor and which keep
their paths), the launch plan per shape, the tile table and the ctypes
declaration against ``csrc/conv1x1g.cu``, and the harness's ``conv1x1g``
span picking every grouped 1x1 layer of both benchmark configurations.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s phase ``conv1x1g_kernel``).
"""

import ctypes
import importlib.util
import os
import re
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
    codec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv1x1g as c1, fast_conv, masked_conv)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (Cin, Cout, groups) of the main path: the cgp stack of a one-plane ZTsep
# codec (so = 3 groups of 162 channels) and the pointwise AEs of the CDF97
# codec's detail levels (9 channels) and of its LL band (3 channels)
SHAPES = [(486, 486, 3), (486, 162, 3), (162, 54, 3), (54, 6, 3),
          (9, 288, 9), (288, 288, 9), (288, 9, 9),
          (3, 96, 3), (96, 96, 3), (96, 3, 3)]
PLANES = [(2, 4, 8), (1, 5, 7)]      # (B, H, W): a dense and a ragged plane
# fp32 sums of the same products in another order
TOL = 1e-5


def case(cin, cout, groups, b, h, w, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, cin, h, w).astype(np.float32))
    wt = torch.from_numpy((rng.randn(cout, cin // groups, 1, 1)
                           / np.sqrt(cin // groups)).astype(np.float32))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    return x, wt, bias


def rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("cin,cout,groups", SHAPES)
def test_plain_matches_conv2d(cin, cout, groups, plane):
    x, wt, bias = case(cin, cout, groups, *plane)
    got = c1.conv1x1g_plain(x, wt, bias, groups)
    assert got.shape == (plane[0], cout, *plane[1:])
    assert rel(got, F.conv2d(x, wt, bias, groups=groups)) < TOL
    assert rel(c1.conv1x1g_plain(x, wt, None, groups),
               F.conv2d(x, wt, groups=groups)) < TOL


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("cin,cout,groups", SHAPES)
def test_function_gradients_match_conv2d_autograd(cin, cout, groups, plane):
    """dx (the plain version of the transposed-weight conv), dk (the batched
    product summed over b) and db against autograd of ``F.conv2d`` with the
    bias; the forward under autograd too."""
    x, wt, bias = case(cin, cout, groups, *plane, seed=1)
    dy = torch.from_numpy(np.random.RandomState(2).randn(
        plane[0], cout, *plane[1:]).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, wt, bias)]
    want_leaves = [t.clone().requires_grad_(True) for t in (x, wt, bias)]
    y = c1.conv1x1g(*leaves, groups)
    want = F.conv2d(*want_leaves, groups=groups)
    assert rel(y.detach(), want.detach()) < TOL
    y.backward(dy)
    want.backward(dy)
    for got_t, want_t in zip(leaves, want_leaves):
        assert got_t.grad.shape == want_t.grad.shape
        assert rel(got_t.grad, want_t.grad) < TOL


def test_function_skips_dx_where_the_input_needs_none(monkeypatch):
    """The first encoder layer of a fixed transform's AE: no dx, and dk and
    db as autograd's."""
    x, wt, bias = case(9, 288, 9, 2, 4, 8)
    wt.requires_grad_(True)
    bias.requires_grad_(True)
    seen = []
    plain = c1.conv1x1g_plain

    def spy(x_, *args):
        seen.append(tuple(x_.shape))
        return plain(x_, *args)

    monkeypatch.setattr(c1, "conv1x1g_plain", spy)
    c1.conv1x1g(x, wt, bias, 9).sum().backward()
    assert seen == [(2, 9, 4, 8)]          # the forward only
    wt2, bias2 = (t.detach().clone().requires_grad_(True) for t in (wt, bias))
    F.conv2d(x, wt2, bias2, groups=9).sum().backward()
    assert rel(wt.grad, wt2.grad) < TOL and rel(bias.grad, bias2.grad) < TOL


def test_transposed_weight_and_dk_layouts():
    """w'[g*K + k, m] = w[g*M + m, k]; dk summed over the batch as the
    per-image, per-group products."""
    g, m, k = 3, 5, 4
    wt = torch.arange(g * m * k, dtype=torch.float32).view(g * m, k, 1, 1)
    wtt = c1.transposed_weight(wt, g)
    assert wtt.shape == (g * k, m, 1, 1)
    for gi in range(g):
        for mi in range(m):
            for ki in range(k):
                assert wtt[gi * k + ki, mi, 0, 0] == wt[gi * m + mi, ki, 0, 0]
    x, _, _ = case(g * k, g * m, g, 2, 3, 5)
    dy, _, _ = case(g * m, g * m, g, 2, 3, 5, seed=3)
    dk = c1.dk_product(x, dy, g)
    want = torch.zeros(g * m, k)
    for b in range(2):
        for gi in range(g):
            want[gi * m:(gi + 1) * m] += (
                dy[b, gi * m:(gi + 1) * m].reshape(m, -1)
                @ x[b, gi * k:(gi + 1) * k].reshape(k, -1).t())
    assert rel(dk.view(g * m, k), want) < TOL


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on a CUDA device, so that a CPU test
    sees which path ``Conv2d`` dispatches a card's tensor to."""

    @property
    def is_cuda(self):
        return True


def _layers():
    bf = torch.bfloat16
    return {
        "fp32_grouped_1x1": (fast_conv.Conv2d(96, 96, 1, groups=3), True),
        "fp32_grouped_1x1_no_bias": (
            fast_conv.Conv2d(96, 96, 1, groups=3, bias=False), True),
        "bf16_grouped_1x1": (
            fast_conv.Conv2d(96, 96, 1, groups=3, dtype=bf), False),
        "bf16_cgp": (fast_conv.FastGroupedConv1x1(96, 96, 3, bf), False),
        "groups_1_1x1": (fast_conv.Conv2d(96, 96, 1), False),
        "grouped_3x3": (fast_conv.Conv2d(96, 96, 3, groups=3), False),
        "grouped_1x1_stride_2": (
            fast_conv.Conv2d(96, 96, 1, groups=3, stride=2), False),
        "grouped_1x1_dilation_2": (
            fast_conv.Conv2d(96, 96, 1, groups=3, dilation=2), False),
        "masked_grouped_3x3": (
            masked_conv.MaskedConv2d(96, 96, 3, "B", groups=3), False),
    }


@pytest.mark.parametrize("name", sorted(_layers()))
def test_conv2d_dispatch(name, monkeypatch):
    """On a CUDA tensor an fp32 grouped 1x1 conv at stride and dilation 1
    takes ``conv1x1g`` with the layer's weight, bias and groups (and
    nothing else: no separate bias add); every other layer keeps its path.
    A CPU tensor keeps ``F.conv2d``."""
    layer, takes = _layers()[name]
    torch.nn.init.normal_(layer.weight)
    calls = []

    def fake(x, weight, bias=None, groups=1):
        calls.append((weight, bias, groups))
        return torch.zeros(x.shape[0], weight.shape[0], *x.shape[2:])

    monkeypatch.setattr(fast_conv, "conv1x1g", fake)
    x = torch.randn(1, 96, 8, 8)
    layer(x)
    assert calls == []
    out = layer(x.as_subclass(_OnCard))
    assert layer.pointwise_grouped == (
        name.endswith("grouped_1x1") or name.endswith("1x1_no_bias")
        or name == "bf16_cgp")
    if takes:
        assert len(calls) == 1
        weight, bias, groups = calls[0]
        assert weight is layer.weight and bias is layer.bias \
            and groups == layer.groups
        assert not out.abs().any()
    else:
        assert calls == []


@pytest.mark.parametrize("cin,cout,groups", SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
def test_launch_plan_per_shape(cin, cout, groups, transpose):
    """Each main-path shape, forward and dx (K and M swapped), at the eval
    plane (B=8, 256x384) and a ragged one: the M tile covers the group's M
    in one tile (each input pixel staged once), the ring fits the block's
    shared memory, the grid covers the plane; the cgp's wide layers (bound
    by their FLOPs) take a large tile, the AEs' layers (bound by their
    bytes) a streaming one."""
    k, m = cin // groups, cout // groups
    if transpose:
        k, m = m, k
    for pixels in (256 * 384, 37 * 41):
        p = c1.launch_plan(8, pixels, groups, k, m)
        assert p.m_tile in c1.TILES and p.m_tile >= m
        assert p.grid == (-(-pixels // p.n_tile), 1, 8 * groups)
        assert p.n_tile * p.grid[0] >= pixels
        assert p.bk == c1.TILES[p.m_tile][4] and p.chunks == -(-k // p.bk)
        assert p.stages == (2 if p.chunks == 1 else c1.TILES[p.m_tile][5])
        assert p.smem_bytes == 4 * p.stages * c1.stage_floats(p.m_tile) \
            <= c1.SMEM_MAX
        assert p.vec_x == p.vec_y == (pixels % 4 == 0)
        assert p.threads % 32 == 0 and p.threads <= 256
        if m == k == 162 or (k, m) in ((162, 54), (54, 162)):
            assert p.m_tile >= 64 and p.bk == 16
        if {k, m} <= {1, 32}:
            assert p.m_tile <= 32 and p.n_tile >= 256 and p.threads == 128 \
                and p.bk == 8


def test_pick_m_tile():
    assert {m: c1.pick_m_tile(m) for m in (1, 2, 18, 32, 54, 162)} \
        == {1: 4, 2: 4, 18: 32, 32: 32, 54: 64, 162: 192}
    assert not c1.launch_plan(8, 4096, 3, 162, 162, vec_x=False).vec_x


def _source():
    with open(c1.SOURCE) as fh:
        return fh.read()


def test_tile_table_matches_the_kernel_dispatch():
    """``TILES`` (Python) and the kernel's ``switch (m_tile)`` name the same
    <TM, WN, WARPS_M, WARPS_N, BK> for every M tile; the ring's stages and
    the shared-memory limit agree."""
    src = _source()
    cases = re.findall(r"case (\d+):\s*return launch<(\d+), (\d+), (\d+), "
                       r"(\d+), (\d+)>", src)
    assert {int(t): tuple(int(v) for v in vs) for t, *vs in cases} \
        == {t: v[:5] for t, v in c1.TILES.items()}
    stages = int(re.search(r"constexpr int MAX_STAGES = (\d+);", src)[1])
    assert all(2 <= v[5] <= stages for v in c1.TILES.values())
    assert f"constexpr int SMEM_MAX = {c1.SMEM_MAX};" in src


def test_ctypes_declaration_matches_the_c_entry_point():
    sig = re.search(r'extern "C" int conv1x1g_fwd\((.*?)\)\s*\{', _source(),
                    re.S).group(1)
    want = [ctypes.c_void_p if "*" in arg else ctypes.c_longlong
            if "long long" in arg else ctypes.c_int for arg in sig.split(",")]
    lib = types.SimpleNamespace(conv1x1g_fwd=types.SimpleNamespace())
    c1._declare(lib)
    assert lib.conv1x1g_fwd.argtypes == want
    assert lib.conv1x1g_fwd.restype is ctypes.c_int


def test_kernel_refuses_cpu_and_bf16_operands():
    x, wt, bias = case(96, 96, 3, 1, 4, 4)
    with pytest.raises(ValueError, match="same CUDA device"):
        c1.launch_kernel(x, wt, bias, 3)
    with pytest.raises(ValueError, match="fp32"):
        c1.launch_kernel(x.bfloat16(), wt, bias, 3)
    with pytest.raises(ValueError, match="does not fit"):
        c1.conv1x1g(x, wt, bias, 4)


def _bench(name):
    from bench_port.harness import common, port
    model_cfg = common.model_config(name)
    return model_cfg, port.config(model_cfg, {})


def _span_specs():
    path = os.path.join(ROOT, "bench_port", "metrics",
                        "conv1x1g_roofline.eval.py")
    spec = importlib.util.spec_from_file_location("_conv1x1g_metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SPANS


@pytest.mark.parametrize("name,count", [("cdf97_fp32", 40),
                                        ("flagship_fp32", 36)])
def test_span_picks_every_grouped_1x1_layer_of_the_bench_configs(name,
                                                                 count):
    """The per-layer metric ``conv1x1g_roofline.eval`` reads the span that
    its spec installs on modules of class ``Conv2d`` with a 1x1 weight and
    groups > 1: it picks every layer that the kernel runs (CDF97: 5 AEs x 8
    layers; the flagship: 3 codecs x 3 levels x 4 cgp layers), as many as
    the work counter counts."""
    from bench_port import work
    from bench_port.harness import spans
    model_cfg, cfg = _bench(name)
    model = codec.CodecWrapper(cfg)
    runs_kernel = [m for m in model.modules()
                   if isinstance(m, fast_conv.Conv2d) and m.dtype is None
                   and m.pointwise_grouped]
    assert len(runs_kernel) == count
    found = spans.install(model, _span_specs())
    assert found == {"conv1x1g": count}
    wrapped = [m for m in runs_kernel if "forward" in vars(m)]
    assert len(wrapped) == count
    layers = work.step_layers(model_cfg, 1, 64, 64)
    assert sum(x.kind == "conv1x1g" for x in layers) == count
