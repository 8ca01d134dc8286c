"""The port's ZTsep entropy model and whole eval step against the JAX
package's, on the CPU, with weights carried across by ``tools/weights.py``:
random weights at the flagship widths (dwtlevels=3, 64x64, fp32), then the
committed flagship lambda=2000 snapshot (dwtlevels=4).

Tolerances: self-information 2e-3 bits per sample (as the JAX package's
parity tests against the original modules); quantized subbands exact (the
same rounding of the same values); the RD terms 1e-4 relative (fp32 sums
of ~10^4 samples in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    models as pem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    data as pdata, state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    models as jem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    state as jstate)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

SNAPSHOT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "results", "ckpt_snapshots", "flagship_lam2000.npz")
FLAGSHIP = dict(netType="LiftingBasedNeuralWaveletv4",
                entropy_layer="conditioned2ZTsepSubbands",
                autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=4,
                num_lifting_perlayer=2, filtersize=5, depth_scale=2,
                block_property="same", scale=0, linearity_flag=1,
                res_connection_weight=0.1, lambda_=117.3)


def cfgs(**kw):
    base = dict(FLAGSHIP, **kw)
    return jconfig.Config(**base), pconfig.Config(**base).validate()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def random_params(init, seed):
    """Flat flax params drawn from numpy (conv kernels with std
    1/sqrt(fan_in), small non-zero biases, GDN terms near their init and
    positive, random skip taps); only the shapes come from ``init``."""
    shapes = jax.eval_shape(init)["params"]
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in weights.flatten_params(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), shapes)).items():
        leaf = k.rsplit("['", 1)[1][:-2]
        n = rng.randn(*v.shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(v.shape[:-1]))
        elif leaf == "beta":
            v = 1.0 + 0.05 * np.abs(n)
        elif leaf == "gamma":
            v = np.sqrt(0.1) * np.eye(v.shape[0]) + 0.05 * np.abs(n)
        elif leaf == "taps":
            v = 0.5 * n
        else:
            v = 0.05 * n
        out[k] = v.astype(np.float32)
    return out


def unflatten(flat):
    """Flat params (f16 in the snapshot) -> fp32 flax tree."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  weights.unflatten_params(flat))


def images(size, seed):
    img = pdata.synthetic_natural_images(1, size, seed=seed)[0]
    return img[None].astype(np.float32) / 255.0


def test_ztsep_eval_matches():
    jcfg, pcfg = cfgs(dwtlevels=3)
    rng = np.random.RandomState(0)
    xe = (rng.randn(1, 8, 8, 1) * 3).astype(np.float32)
    xo = [(rng.randn(1, s, s, 3) * 3).astype(np.float32) for s in (32, 16, 8)]
    mod = jem.ZTSepSubbands(jcfg)
    args = (jnp.asarray(xe), [jnp.asarray(t) for t in xo], False)
    flat = random_params(lambda: mod.init(jax.random.PRNGKey(0), *args), 1)
    j_ixe, j_ixo, j_qe, j_qo = mod.apply({"params": unflatten(flat)}, *args)
    model = pem.ZTSepSubbands(pcfg)
    weights.load_flax_params(model, flat)
    with torch.no_grad():
        p_ixe, p_ixo, p_qe, p_qo = model(nchw(xe), [nchw(t) for t in xo])
    np.testing.assert_allclose(nhwc(p_ixe), np.asarray(j_ixe), rtol=0,
                               atol=2e-3)
    np.testing.assert_array_equal(nhwc(p_qe), np.asarray(j_qe))
    for i in range(3):
        np.testing.assert_allclose(nhwc(p_ixo[i]), np.asarray(j_ixo[i]),
                                   rtol=0, atol=2e-3)
        np.testing.assert_array_equal(nhwc(p_qo[i]), np.asarray(j_qo[i]))


def _eval_both(jcfg, pcfg, flat, x):
    want = jstate.make_eval_step(jcfg, JCodec(jcfg))(unflatten(flat),
                                                     jnp.asarray(x))
    model = PCodec(pcfg)
    weights.load_flax_params(model, flat)
    got, xhat = pstate.make_eval_step(pcfg, model, device="cpu")(nchw(x))
    assert tuple(xhat.shape) == (x.shape[0], 3, *x.shape[1:3])
    assert float(xhat.abs().max()) <= 0.5
    for name in ("loss", "mse", "rate1", "rate2"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-4,
                                   err_msg=name)
    return got


def test_eval_step_matches_at_flagship_widths():
    jcfg, pcfg = cfgs(dwtlevels=3)
    x = images(64, seed=1)
    flat = random_params(lambda: JCodec(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x), False), 2)
    _eval_both(jcfg, pcfg, flat, x)


def test_eval_step_matches_joint_rgb():
    """clrch=3: one codec on the shifted RGB tensor (no color split)."""
    jcfg, pcfg = cfgs(clrch=3, dwtlevels=2, autoencoder="none")
    x = images(32, seed=4)
    flat = random_params(lambda: JCodec(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x), False), 5)
    _eval_both(jcfg, pcfg, flat, x)


def test_eval_step_matches_on_flagship_snapshot():
    jcfg, pcfg = cfgs()
    got = _eval_both(jcfg, pcfg, weights.load_npz(SNAPSHOT), images(64, 3))
    # a trained codec: a few bits per pixel on a natural-looking image
    assert 0.5 < float(got.rate1 + got.rate2) < 16
    assert float(got.mse) < 0.01
