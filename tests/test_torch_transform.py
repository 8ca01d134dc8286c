"""The port's learned lifting transform against the JAX package's, on the
CPU: ``LiftStage``, one lifting level, the Berk scaling AE and the whole
``LearnedLiftingTransform``. Inputs come from numpy with a fixed seed and
weights are carried across with ``tools/weights.py``.

Tolerance 1e-4 on values scaled by max(1, max |value|), as the JAX
package's parity tests against the original PyTorch modules (fp32 sums in
another order, through up to four levels of conv stacks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
    transforms as ptr)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    lifting as plift, subband_ae as pae)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models import (
    transforms as jtr)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    lifting as jlift, subband_ae as jae)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

TOL = 1e-4


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def random_params(mod, *args, seed, scale=0.05):
    """Flat flax params of ``mod`` drawn from numpy: conv kernels with std
    1/sqrt(fan_in), biases, gains and skip taps moved off their initial
    values by N(0, scale), GDN terms near their init and positive. Only the
    shapes come from flax (``eval_shape``, no compute)."""
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in weights.flatten_params(
            jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes["params"])).items():
        leaf = k.rsplit("['", 1)[1][:-2]
        n = rng.randn(*v.shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(v.shape[:-1]))
        elif leaf == "beta":
            v = 1.0 + scale * np.abs(n)
        elif leaf == "gamma":
            v = np.sqrt(0.1) * np.eye(v.shape[0]) + scale * np.abs(n)
        elif leaf == "taps":
            v = 0.5 * n
        else:
            v = scale * n
        out[k] = v.astype(np.float32)
    return out


def unflatten(flat):
    return jax.tree_util.tree_map(jnp.asarray, weights.unflatten_params(flat))


def close(got, want, what):
    want = np.asarray(want)
    err = float(np.max(np.abs(np.asarray(got) - want)))
    tol = TOL * max(1.0, float(np.max(np.abs(want))))
    assert err < tol, f"{what}: max abs err {err:.3e} >= {tol:.3e}"


@pytest.mark.parametrize("channels,use_scale", [(1, False), (3, True)])
def test_lift_stage_forward_inverse(channels, use_scale):
    rng = np.random.RandomState(0)
    L = rng.randn(2, 8, 12, channels).astype(np.float32)
    H = rng.randn(2, 8, 12, channels).astype(np.float32)
    kw = dict(channels=channels, hidden=16 * channels, filtersize=5,
              num_pairs=2, nonlinear=True, res_weight=0.1, use_scale=use_scale)
    mod = jlift.LiftStage(**kw)
    flat = random_params(mod, jnp.asarray(L), jnp.asarray(H), seed=1)
    variables = {"params": unflatten(flat)}
    jl, jh = mod.apply(variables, jnp.asarray(L), jnp.asarray(H),
                       method="forward")
    il, ih = mod.apply(variables, jl, jh, method="inverse")
    stage = plift.LiftStage(**kw)
    weights.load_flax_params(stage, flat)
    with torch.no_grad():
        pl_, ph = stage(nchw(L), nchw(H))
        ql, qh = stage.inverse(pl_, ph)
    close(nhwc(pl_), jl, "L")
    close(nhwc(ph), jh, "H")
    close(nhwc(ql), il, "inverse L")
    close(nhwc(qh), ih, "inverse H")


def test_lift_level_forward_inverse():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 24, 1).astype(np.float32)
    kw = dict(channels=1, hidden=16, filtersize=5, num_pairs=2)
    mod = jlift.LiftStage(**kw)
    half = jnp.zeros((2, 8, 24, 1))
    flat = random_params(mod, half, half, seed=4)
    variables = {"params": unflatten(flat)}
    jbands = mod.apply(variables, jnp.asarray(x),
                       method=lambda m, v: jlift.lift_level_forward(m, v))
    jx = mod.apply(variables, *jbands,
                   method=lambda m, *b: jlift.lift_level_inverse(m, *b))
    stage = plift.LiftStage(**kw)
    weights.load_flax_params(stage, flat)
    with torch.no_grad():
        pbands = plift.lift_level_forward(stage, nchw(x))
        px = plift.lift_level_inverse(stage, *pbands)
    for name, p, j in zip(("ll", "lh", "hl", "hh"), pbands, jbands):
        close(nhwc(p), j, name)
    close(nhwc(px), jx, "inverse")
    close(nhwc(px), x, "round trip")


@pytest.mark.parametrize("in_ch", [1, 3])
def test_berk_ae_encode_decode(in_ch):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12, 10, in_ch).astype(np.float32)
    mod = jae.SubbandAutoEncoderBerk(in_ch=in_ch)
    flat = random_params(mod, jnp.asarray(x), seed=7)
    variables = {"params": unflatten(flat)}
    jy = mod.apply(variables, jnp.asarray(x), method="encode")
    jx = mod.apply(variables, jy, method="decode")
    ae = pae.SubbandAutoEncoderBerk(in_ch=in_ch)
    weights.load_flax_params(ae, flat)
    with torch.no_grad():
        py = ae.encode(nchw(x))
        px = ae.decode(py)
    close(nhwc(py), jy, "encode")
    close(nhwc(px), jx, "decode")


def _cfgs(**kw):
    base = dict(netType="LiftingBasedNeuralWaveletv4",
                autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=2,
                depth_scale=2, filtersize=5, num_lifting_perlayer=2,
                block_property="same", scale=0, linearity_flag=1,
                res_connection_weight=0.1)
    base.update(kw)
    return jconfig.Config(**base), pconfig.Config(**base).validate()


@pytest.mark.parametrize("size,kw", [
    (32, dict(dwtlevels=2)),
    (64, dict(dwtlevels=3)),
    (32, dict(dwtlevels=2, clrch=3, block_property="different", scale=1)),
])
def test_learned_lifting_transform_encode_decode(size, kw):
    jcfg, pcfg = _cfgs(**kw)
    rng = np.random.RandomState(8)
    x = rng.uniform(-0.5, 0.5, (1, size, size, pcfg.clrch)).astype(np.float32)
    mod = jtr.LearnedLiftingTransform(jcfg)
    flat = random_params(mod, jnp.asarray(x), seed=10)
    variables = {"params": unflatten(flat)}
    jxe, jxo = mod.apply(variables, jnp.asarray(x), method="encode")
    jx = mod.apply(variables, jxe, jxo, method="decode")
    tr = ptr.LearnedLiftingTransform(pcfg)
    weights.load_flax_params(tr, flat)
    with torch.no_grad():
        pxe, pxo = tr.encode(nchw(x))
        px = tr.decode(pxe, pxo)
    close(nhwc(pxe), jxe, "xe")
    assert len(pxo) == len(jxo) == pcfg.dwtlevels
    for i, (p, j) in enumerate(zip(pxo, jxo)):
        close(nhwc(p), j, f"xo[{i}]")
    close(nhwc(px), jx, "xhat")


def test_identity_ae_round_trip_is_exact():
    """Without scaling AEs the inverse replays the same P/U outputs, so
    decode(encode(x)) returns x up to fp32 rounding of the adds."""
    _, pcfg = _cfgs(autoencoder="none", dwtlevels=3)
    tr = ptr.LearnedLiftingTransform(pcfg)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
        reset_conv_weights)
    reset_conv_weights(tr, torch.Generator().manual_seed(0))
    x = torch.from_numpy(
        np.random.RandomState(11).randn(2, 1, 32, 48).astype(np.float32))
    with torch.no_grad():
        xe, xo = tr.encode(x)
        xhat = tr.decode(xe, xo)
    assert tuple(xe.shape) == (2, 1, 4, 6)
    assert [tuple(t.shape) for t in xo] == [(2, 3, 16, 24), (2, 3, 8, 12),
                                            (2, 3, 4, 6)]
    assert float((xhat - x).abs().max()) < 1e-5


def test_make_transform_rejects_unported():
    """Every netType of the config is ported now: a name outside them is
    refused."""
    _, pcfg = _cfgs()
    with pytest.raises(ValueError, match="unknown netType"):
        ptr.make_transform(dataclasses.replace(pcfg, netType="HaarWavelet"))
