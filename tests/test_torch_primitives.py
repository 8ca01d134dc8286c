"""The port's primitives against the JAX package's, on the CPU: color, GDN,
masked convs, math utilities and the Gaussian likelihood. Inputs come from
numpy with a fixed seed and weights are carried across with
``tools/weights.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    gaussian as pg)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    color as pc, gdn as pgdn, masked_conv as pmc, math_utils as pmu)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    gaussian as jg)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    color as jc, gdn as jgdn, masked_conv as jmc, math_utils as jmu)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def perturbed(params, seed, scale=0.05):
    """Flat flax params with every leaf moved by N(0, scale): non-zero
    biases and off-diagonal GDN terms exercise every term."""
    rng = np.random.RandomState(seed)
    return {k: np.abs(v + scale * rng.randn(*v.shape)).astype(np.float32)
            if k.endswith("['gamma']") or k.endswith("['beta']")
            else (v + scale * rng.randn(*v.shape)).astype(np.float32)
            for k, v in weights.flatten_params(params).items()}


def unflatten(flat):
    return jax.tree_util.tree_map(jnp.asarray, weights.unflatten_params(flat))


def test_color_transforms_match():
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (2, 8, 12, 3)).astype(np.float32)
    y = jc.shift_ycbcr(jc.rgb_to_ycbcr(jnp.asarray(x)))
    yt = pc.shift_ycbcr(pc.rgb_to_ycbcr(nchw(x)))
    np.testing.assert_allclose(nhwc(yt), np.asarray(y), rtol=0, atol=1e-6)
    back = jc.ycbcr_to_rgb(jc.unshift_ycbcr(y))
    backt = pc.ycbcr_to_rgb(pc.unshift_ycbcr(yt))
    np.testing.assert_allclose(nhwc(backt), np.asarray(back), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nhwc(backt), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches(inverse):
    c = 12
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 7, c).astype(np.float32)
    mod = jgdn.GDN(c, inverse=inverse)
    flat = perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                     seed=2)
    want = np.asarray(mod.apply({"params": unflatten(flat)}, jnp.asarray(x)))
    layer = pgdn.GDN(c, inverse=inverse)
    weights.load_flax_params(layer, flat)
    with torch.no_grad():
        got = nhwc(layer(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask_type,k,cin,cout,groups", [
    ("A", 5, 3, 27, 3),   # the csc shape family (one input channel a group)
    ("B", 3, 9, 9, 3),    # PixelCNN hidden layers
    ("A", 3, 1, 4, 1),    # the LL PixelCNN's first layer
])
def test_masked_conv_matches(mask_type, k, cin, cout, groups):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 10, cin).astype(np.float32)
    mod = jmc.MaskedConv2d(cout, (k, k), mask_type=mask_type,
                           feature_group_count=groups)
    flat = perturbed(mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"],
                     seed=4)
    want = np.asarray(mod.apply({"params": unflatten(flat)}, jnp.asarray(x)))
    layer = pmc.MaskedConv2d(cin, cout, k, mask_type=mask_type, groups=groups)
    weights.load_flax_params(layer, flat)
    with torch.no_grad():
        got = nhwc(layer(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        pmc.causal_mask((k, k), mask_type), jmc.causal_mask((k, k), mask_type))


def test_lower_bound_values_and_gradient():
    rng = np.random.RandomState(5)
    x = rng.randn(64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    want = np.asarray(jmu.lower_bound(jnp.asarray(x), 0.1))
    want_grad = np.asarray(jax.grad(
        lambda v: jnp.sum(jmu.lower_bound(v, 0.1) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pmu.lower_bound(xt, 0.1)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)


def test_nnp_and_quantize_match():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -3.7],
                 np.float32)
    mu = np.array([0.25, -0.5, 0.0, 1.0, 0.5, -2.0, 0.0, 0.3], np.float32)
    # half-to-even rounding on both sides, with and without means
    np.testing.assert_array_equal(
        pmu.quantize_dequantize(torch.from_numpy(v)).numpy(),
        np.asarray(jmu.quantize_dequantize(jnp.asarray(v))))
    np.testing.assert_array_equal(
        pmu.quantize_dequantize(torch.from_numpy(v), torch.from_numpy(mu)).numpy(),
        np.asarray(jmu.quantize_dequantize(jnp.asarray(v), jnp.asarray(mu))))
    a = np.abs(v)
    np.testing.assert_allclose(pmu.nnp_init(torch.from_numpy(a)).numpy(),
                               np.asarray(jmu.nnp_init(jnp.asarray(a))),
                               rtol=1e-6)
    np.testing.assert_allclose(pmu.nnp_apply(torch.from_numpy(v)).numpy(),
                               np.asarray(jmu.nnp_apply(jnp.asarray(v))),
                               rtol=1e-6)


def test_likelihood_and_bits_match():
    rng = np.random.RandomState(6)
    x = (rng.randn(4, 3, 8, 8) * 4).astype(np.float32)
    scales = np.exp(rng.randn(4, 3, 8, 8)).astype(np.float32) * 0.5
    means = rng.randn(4, 3, 8, 8).astype(np.float32)
    for m in (None, means):
        jq, jl = jg.likelihood(jnp.asarray(x), jnp.asarray(scales),
                               None if m is None else jnp.asarray(m),
                               training=False)
        pq, pl = pg.likelihood(torch.from_numpy(x), torch.from_numpy(scales),
                               None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-9)
    _, jb = jg.self_information_bits(jnp.asarray(x), jnp.asarray(scales),
                                     jnp.asarray(means), training=False)
    _, pb = pg.self_information_bits(torch.from_numpy(x),
                                     torch.from_numpy(scales),
                                     torch.from_numpy(means))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-4)
