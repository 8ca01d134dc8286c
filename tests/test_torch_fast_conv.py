"""The JAX package's matmul conv forms and their dispatch in the port, on
the CPU: ``grouped_conv1x1_einsum``, ``grouped_conv_taps`` and
``conv5x5_s2d`` against the JAX functions on the same numpy inputs, the
layers that dispatch them (ZTsep's cgp, the masked grouped convs, the
lifting P/U 5x5 convs, the pointwise AE's grouped 1x1) against the JAX
layers in bf16 on both sides of the 4096-pixel switch (a row block of an
H-sharded plane read by its global plane), one lifting level with the
snapshot's P/U weights, and the bf16 flagship eval forward against the JAX
package's (the snapshot's weights).

Tolerances: fp32 1e-5 of max |y| (fp32 sums in another order); bf16
1e-6 of max |y| where the form returns fp32 sums of bf16 operands. Where
the output is rounded to bf16 (one rounding of fp32 sums, as XLA's and
the port's convs round), every element within one bf16 step (2^-7 of its
magnitude) and at most 1e-3 of the elements apart at all: fp32 sums in
another order land on the other side of a bf16 rounding boundary now and
then. The lifting level's subbands: one bf16 step at the band's largest
value, a quarter step on average (see its test). The eval forward: loss
2e-4 relative, rates 5e-4, xhat mean 1e-4 (measured, see its test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    fast_conv as pf, masked_conv as pmc, subband_ae as pae)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    fast_conv as jf, masked_conv as jmc)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    state as jstate)

from test_torch_codec import (SNAPSHOT, cfgs, images, nchw, random_params,
                              unflatten)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-6)}


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def torch_weight(kernel):
    """flax (kh, kw, Cin/G, Cout) -> PyTorch (Cout, Cin/G, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_one_bf16_rounding(got, want):
    """Both bf16-rounded: each element within one bf16 step of the other,
    and few elements apart at all."""
    diff = np.abs(got - want)
    assert np.all(diff <= 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)))
    assert (diff > 0).mean() <= 1e-3


def form_case(name, rng):
    """(jax fn, port fn, x NHWC, flax kernel, bias, groups)."""
    if name == "grouped_conv1x1_einsum":
        return (jf.grouped_conv1x1_einsum, pf.grouped_conv1x1_einsum,
                rng.randn(2, 16, 12, 12), rng.randn(1, 1, 4, 9) / 2,
                rng.randn(9), 3)
    if name == "grouped_conv_taps":
        return (jf.grouped_conv_taps, pf.grouped_conv_taps,
                rng.randn(2, 16, 12, 3), rng.randn(5, 5, 1, 27) / 5,
                rng.randn(27), 3)
    return (jf.conv5x5_s2d, pf.conv5x5_s2d, rng.randn(2, 16, 12, 4),
            rng.randn(5, 5, 4, 8) / 10, rng.randn(8), None)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["grouped_conv1x1_einsum",
                                  "grouped_conv_taps", "conv5x5_s2d"])
def test_form_matches_jax(name, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jfn, pfn, x, k, b, groups = form_case(name, np.random.RandomState(0))
    x, k, b = (a.astype(np.float32) for a in (x, k, b))
    gkw = {} if groups is None else {"groups": groups}
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                          dtype=jdt, **gkw)).astype(np.float32)
    got = nhwc(pfn(nchw(x), torch_weight(k), torch.from_numpy(b), dtype=tdt,
                   **gkw))
    assert got.dtype == np.float32
    if name == "conv5x5_s2d" and dtype == "bfloat16":
        assert_one_bf16_rounding(got, want)   # the conv's output is bf16
    else:
        assert rel(got, want) <= tol


def test_s2d_layouts_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 6, 3).astype(np.float32)
    k = rng.randn(5, 5, 3, 4).astype(np.float32)
    s2d = pf.space_to_depth2(nchw(x))
    np.testing.assert_array_equal(
        nhwc(s2d), np.asarray(jf.space_to_depth2(jnp.asarray(x))))
    np.testing.assert_array_equal(nhwc(pf.depth_to_space2(s2d)), x)
    np.testing.assert_array_equal(
        np.transpose(pf.s2d_kernel_5x5(torch_weight(k)).numpy(),
                     (2, 3, 1, 0)),
        np.asarray(jf.s2d_kernel_5x5(jnp.asarray(k))))


def layer_case(kind, hw, rng):
    """(flax module, port layer, x NHWC) for one dispatching layer."""
    bf = torch.bfloat16
    if kind == "cgp":        # ZTsep's grouped 1x1 fusion layer
        return (jf.FastGroupedConv1x1(486, groups=3, dtype=jnp.bfloat16),
                pf.FastGroupedConv1x1(486, 486, 3, bf),
                rng.randn(1, hw, hw, 486))
    if kind == "csc":        # the masked grouped 5x5 context conv
        return (jmc.MaskedConv2d(243, (5, 5), mask_type="A",
                                 feature_group_count=3, dtype=jnp.bfloat16),
                pmc.MaskedConv2d(3, 243, 5, "A", groups=3, dtype=bf),
                rng.randn(1, hw, hw, 3) * 3)
    if kind == "pixelcnn":   # a grouped PixelCNN hidden layer
        return (jmc.MaskedConv2d(81, (3, 3), mask_type="B",
                                 feature_group_count=3, dtype=jnp.bfloat16),
                pmc.MaskedConv2d(243, 81, 3, "B", groups=3, dtype=bf),
                rng.randn(1, hw, hw, 243))
    if kind == "pointwise_ae":   # SubbandAutoEncoder's grouped 1x1
        return (nn.Conv(96, (1, 1), feature_group_count=3,
                        dtype=jnp.bfloat16),
                pf.Conv2d(96, 96, 1, groups=3, dtype=bf),
                rng.randn(1, hw, hw, 96))
    return (jf.FastConv5x5(16, dtype=jnp.bfloat16),   # lifting P/U conv
            pf.FastConv5x5(16, 16, bf),
            rng.randn(2, hw, hw + (kind == "pu_odd"), 16))


@pytest.mark.parametrize("hw", [64, 32])
@pytest.mark.parametrize("kind", ["cgp", "csc", "pixelcnn", "pointwise_ae",
                                  "pu", "pu_odd"])
def test_bf16_dispatch_matches_jax(kind, hw):
    """At 64x64 (4096 pixels) the grouped layers take the matmul forms
    (fp32 output), at 32x32 ``nn.Conv``'s rounding (bf16 output, bf16
    bias); the P/U conv rounds its output to bf16 on even planes (the JAX
    layer's ``conv5x5_s2d``, the port's plain bf16 conv) and returns fp32
    sums on odd ones."""
    rng = np.random.RandomState(hw)
    jmod, layer, x = layer_case(kind, hw, rng)
    x = x.astype(np.float32)
    params = dict(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["bias"] = jnp.asarray(rng.randn(*params["bias"].shape) * 0.1,
                                 jnp.float32)
    want = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v))(
        params, jnp.asarray(x))).astype(np.float32)
    layer.weight.data = torch_weight(params["kernel"])
    layer.bias.data = torch.from_numpy(np.asarray(params["bias"]))
    with torch.no_grad():
        got = nhwc(layer(nchw(x)))
    if kind == "pu_odd" or (kind in ("cgp", "csc", "pixelcnn")
                            and hw == 64):
        assert rel(got, want) <= 1e-6
        assert not np.array_equal(got, got.astype(jnp.bfloat16))   # fp32
    else:
        assert_one_bf16_rounding(got, want)


def test_disable_pallas_selects_the_small_plane_form():
    rng = np.random.RandomState(2)
    layer = pf.FastGroupedConv1x1(12, 12, 3, torch.bfloat16)
    layer.weight.data = torch.from_numpy(
        rng.randn(12, 4, 1, 1).astype(np.float32))
    layer.bias.data = torch.from_numpy(rng.randn(12).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, 12, 64, 64).astype(np.float32))
    with torch.no_grad():
        big = layer(x)
        with pf.disable_pallas():
            small = layer(x)
            assert pf.pallas_disabled()
        assert not pf.pallas_disabled()
    assert torch.equal(small, small.bfloat16().float())   # bf16-rounded
    assert not torch.equal(big, big.bfloat16().float())   # fp32 sums


def test_pointwise_ae_bf16_stack_matches_flax():
    """The pointwise AE's 4-layer grouped 1x1 tanh stack in bf16 (every
    layer ``nn.Conv`` rounding) against flax's, on a 64x64 plane."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
        subband_ae as jae)
    rng = np.random.RandomState(3)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    jmod = jae.SubbandAutoEncoder(in_ch=3, dtype=jnp.bfloat16)
    flat = random_params(lambda: jmod.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x)), 4)
    want = np.asarray(jax.jit(lambda p, v: jmod.apply(
        {"params": p}, v, method=jae.SubbandAutoEncoder.encode))(
            unflatten(flat), jnp.asarray(x))).astype(np.float32)
    port = pae.SubbandAutoEncoder(3, dtype=torch.bfloat16)
    weights.load_flax_params(port, flat)
    with torch.no_grad():
        got = nhwc(port.encode(nchw(x)))
    assert_one_bf16_rounding(got, want)


def test_sharded_planes_reads_the_global_plane():
    """Inside ``sharded_planes`` a row block (here 52 of a 64x64 plane's
    rows, fewer than 4096 pixels) takes the form of its global plane, and
    a block of a width the map does not know raises."""
    block = torch.zeros(1, 3, 52, 64)
    assert not pf.large_plane(block)
    with pf.sharded_planes({64: 64 * 64, 32: 32 * 32}):
        assert pf.large_plane(block)
        assert not pf.large_plane(torch.zeros(1, 3, 80, 32))
        with pytest.raises(ValueError, match="width 48"):
            pf.large_plane(torch.zeros(1, 3, 52, 48))
        with pf.disable_pallas():
            assert not pf.large_plane(block)
    assert not pf.large_plane(block)


@pytest.mark.parametrize("plane", [0, 1, 2])
def test_bf16_lifting_level_with_the_snapshot_pu_weights(plane):
    """One lifting level in bf16 with the lambda=2000 snapshot's stage of
    each YCbCr plane, its P/U blocks as trained, on a 128x128 image: the
    subbands before quantization against the JAX package's. A P/U block on
    one input differs by one bf16 rounding of its output now and then, and
    the ladder carries such flips on to every later block's input
    rounding, so each subband element is held within one bf16 step of the
    band's largest value (2^-7 of max |band|; measured at most 5.5e-3) and
    on average within a quarter step (2^-9 of mean |band|; measured at
    most 1.3e-3, where the fp32 ladder's subbands sit 1.6e-3 to 3.8e-3
    from the JAX package's bf16 ones)."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        lifting as plift)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
        lifting as jlift)
    pre = f"['codecs_{plane}']['transform']['stages_0']"
    flat = {k[len(pre):]: v for k, v in weights.load_npz(SNAPSHOT).items()
            if k.startswith(pre)}
    x = images(128, seed=5)[..., plane:plane + 1] - 0.5
    kw = dict(num_pairs=2, nonlinear=True, res_weight=0.1, use_scale=False)
    jstage = jlift.LiftStage(channels=1, hidden=16, filtersize=5,
                             dtype=jnp.bfloat16, **kw)
    want = jax.jit(lambda p, v: jstage.apply(
        {"params": p}, v, method=lambda m, t: jlift.lift_level_forward(
            m, t)))(unflatten(flat), jnp.asarray(x))
    stage = plift.LiftStage(1, 16, 5, dtype=torch.bfloat16, **kw)
    weights.load_flax_params(stage, flat)
    with torch.no_grad():
        got = plift.lift_level_forward(stage, nchw(x))
    for g, w in zip(got, want):
        g, w = nhwc(g), np.asarray(w)
        d = np.abs(g - w)
        assert d.max() <= 2.0 ** -7 * np.abs(w).max()
        assert d.mean() <= 2.0 ** -9 * np.abs(w).mean()


def test_bf16_flagship_eval_forward_matches_jax():
    """The flagship codec in bf16 with the committed lambda=2000 snapshot,
    one 128x128 image (4 levels): level 1's 64x64 subbands take the matmul
    forms (cgp einsum, csc taps), the coarser levels the small-plane forms
    (the PixelCNNs, the cgp and csc of level 2). The P/U blocks' last conv
    is zeroed (the trained ones are held in the test above), so the lifting
    ladder is exact in both packages: bf16 sums of 400 terms in another
    order flip a bf16 rounding at ~1e-4 of the elements, and the subbands'
    quantization turns such flips into rate noise of ~1e-3 that would hide
    the entropy model's rounding. Measured: loss within 4.4e-5 relative,
    rates 1.1e-4, xhat mean |diff| 2.7e-5; with the port's earlier rounding
    of these convs (a bf16 cast of every conv's output, an fp32 bias after
    it) the loss was 6.4e-4 off and the rates 1.4e-3 and 1.8e-3."""
    jcfg, pcfg = cfgs(dtype="bfloat16")
    flat = {k: (v * 0 if "Conv_3" in k and ("p_blocks" in k
                                             or "u_blocks" in k) else v)
            for k, v in weights.load_npz(SNAPSHOT).items()}
    x = images(128, seed=5)
    jmodel = JCodec(jcfg)

    @jax.jit
    def jax_forward(p, v):
        xs, xhat, info_xe, info_xo, _ = jstate.apply_color_forward(
            jcfg, jmodel, p, v, False, None)
        xhat = jnp.clip(xhat, -0.5, 0.5)
        return jstate.rd_loss3(xs, xhat, info_xe, info_xo, jcfg.lambda_,
                               1.0), xhat

    want, want_xhat = jax_forward(unflatten(flat), jnp.asarray(x))
    model = PCodec(pcfg)
    weights.load_flax_params(model, flat)
    got, xhat = pstate.make_eval_step(pcfg, model, device="cpu")(nchw(x))
    for name, rtol in (("loss", 2e-4), ("rate1", 5e-4), ("rate2", 5e-4)):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=rtol,
                                   err_msg=name)
    assert np.abs(nhwc(xhat) - np.asarray(want_xhat)).mean() <= 1e-4


@pytest.mark.parametrize("name", ["grouped_conv1x1_einsum",
                                  "grouped_conv_taps", "conv5x5_s2d"])
def test_form_gradients_match_the_plain_conv(name):
    """fp32: each form's gradients (the batched product's own backward for
    the grouped forms) equal ``F.conv2d``'s within 1e-5 of max |grad|."""
    import torch.nn.functional as F
    _, pfn, x, k, b, groups = form_case(name, np.random.RandomState(4))
    x = nchw(x.astype(np.float32)).requires_grad_(True)
    w = torch_weight(k.astype(np.float32)).requires_grad_(True)
    bias = torch.from_numpy(b.astype(np.float32)).requires_grad_(True)
    gkw = {} if groups is None else {"groups": groups}
    g = torch.randn(x.shape[0], w.shape[0], *x.shape[2:],
                    generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(pfn(x, w, bias, dtype=torch.float32, **gkw),
                              (x, w, bias), g)
    want = torch.autograd.grad(F.conv2d(x, w, bias, padding=w.shape[2] // 2,
                                        groups=groups or 1), (x, w, bias), g)
    for a, c in zip(got, want):
        assert float((a - c).abs().max() / c.abs().max()) <= 1e-5
