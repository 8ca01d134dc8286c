"""The port's quincunx lifting against the JAX package's, on the CPU: the
spatial splits, the lifting nets, ``QuincunxLiftingTransform`` in every
split mode, integer lifting, the quincunx codec's eval forward and one Adam
step, and the two trained snapshots through the weight carrier. Inputs
come from numpy with fixed seeds; weights are drawn with numpy in the JAX
package's shapes and carried by ``tools/weights.py``.

Tolerances: splits and merges exact; a transform with
``lif_prec_bits=0`` within 1e-5 of max(1, max |value|) (fp32 sums of the
3x3 convs in another order); with ``lif_prec_bits=8`` the eval rounding
to the 1/255 grid turns those last-ulp differences into whole grid steps
where a value sits on a rounding boundary, so the subbands must be equal
in >= 99.9 % of their elements, and a grid-valued input must come back to
1e-6 (as ``tests/test_alt_transforms.py`` holds the JAX package). The
training noise is pinned to zero in both packages (as
``tests/test_torch_tree_entropy.py`` pins it) where gradients and the Adam
step are compared.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    bottleneck as pbn)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
    transforms as ptr)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    math_utils as pmu, quincunx as pq)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    data as pdata, state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    bottleneck as jbn)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models import (
    transforms as jtr)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    math_utils as jmu, quincunx as jq)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    loss as jloss, state as jstate)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOTS = [os.path.join(ROOT, "results", "ckpt_snapshots", f"{n}.npz")
             for n in ("quincunx_lam400", "quincunx_lam1600")]
# scripts/rd_sweep.py's quincunx preset (its dtype aside: these nets take
# none)
PRESET = dict(netType="QuincunxLifting", entropy_layer="factorized",
              autoencoder="SubbandAutoEncoder", clrch=3, dwtlevels=3,
              split_mode="hv", lif_prec_bits=8, num_lifting_perlayer=2)
TOL = 1e-5
EQUAL_SHARE = 0.999
SIZE = 32


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def draw(shapes, seed):
    """Flat flax params for a tree of shapes: kernels with std
    1/sqrt(fan_in), bottleneck quantiles around [-8, 0, 8], every other
    leaf small."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in weights.flatten_params(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), shapes)).items():
        leaf = k.rsplit("['", 1)[1][:-2]
        n = rng.randn(*v.shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(v.shape[:-1]))
        elif leaf == "quantiles":
            v = np.array([-8.0, 0.0, 8.0]) + 0.1 * n
        else:
            v = 0.05 * n
        out[k] = v.astype(np.float32)
    return out


def tree(flat):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  weights.unflatten_params(flat))


def close(got, want, what, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol} * {scale:.3g}"


def equal_share(got, want):
    return float(np.mean(np.asarray(got) == np.asarray(want)))


# --- splits -----------------------------------------------------------------

def test_split_modes_are_the_configs():
    assert set(pq.SPLIT_MODE_NAMES) == set(pconfig.SPLIT_MODES) \
        == set(jconfig.SPLIT_MODES)
    for m in pconfig.SPLIT_MODES:
        assert pq.split_mode_channels(m) == jq.split_mode_channels(m)
    for bad in ("1p3", 4, None, "vh"):
        with pytest.raises(ValueError, match="split mode"):
            pq.split_mode_channels(bad)


@pytest.mark.parametrize("mode", ["1p3", "2p2", "3p1", "hor", "ver"])
def test_split_and_merge_match_jax_exactly(mode):
    x = np.random.RandomState(0).randn(2, 8, 12, 3).astype(np.float32)
    je, jo = jq.quincunx_split(jnp.asarray(x), mode)
    pe, po = pq.quincunx_split(nchw(x), mode)
    np.testing.assert_array_equal(nhwc(pe), np.asarray(je))
    np.testing.assert_array_equal(nhwc(po), np.asarray(jo))
    back = pq.quincunx_merge(pe, po, mode)
    np.testing.assert_array_equal(nhwc(back), x)
    np.testing.assert_array_equal(
        nhwc(back), np.asarray(jq.quincunx_merge(je, jo, mode)))


# --- transforms -------------------------------------------------------------

# (split_mode, lif_prec_bits, clrch, dwtlevels, autoencoder)
CASES = {"hv_ae": ("hv", 0, 3, 2, "SubbandAutoEncoder"),
         "hv_gray": ("hv", 0, 1, 2, "none"),
         "1p3": (1, 0, 1, 2, "none"),
         "2p2": (2, 0, 1, 2, "none"),
         "3p1": (3, 0, 1, 2, "none")}


class TransformPair:
    """One quincunx transform in both packages with the same weights."""

    def __init__(self, split_mode, bits, c, levels, ae, seed=0):
        kw = dict(netType="QuincunxLifting", split_mode=split_mode,
                  lif_prec_bits=bits, clrch=c, dwtlevels=levels,
                  autoencoder=ae, num_lifting_perlayer=2)
        self.jcfg = jconfig.Config(**kw)
        self.pcfg = pconfig.Config(**kw).validate()
        self.x = np.random.RandomState(seed + 1).rand(
            2, SIZE, SIZE, c).astype(np.float32) - 0.5
        self.jm = jtr.make_transform(self.jcfg)
        shapes = jax.eval_shape(lambda: self.jm.init(
            jax.random.PRNGKey(0), jnp.asarray(self.x)))["params"]
        self.flat = draw(shapes, seed)
        self.params = tree(self.flat)
        self.pm = ptr.make_transform(self.pcfg)
        weights.load_flax_params(self.pm, self.flat)

    def jax_encode(self, x):
        return jax.jit(lambda p, v: self.jm.apply(
            {"params": p}, v, False, method="encode"))(self.params,
                                                       jnp.asarray(x))

    def jax_decode(self, xe, xo):
        return jax.jit(lambda p, e, o: self.jm.apply(
            {"params": p}, e, o, False, method="decode"))(self.params, xe, xo)


@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_jax(case):
    pair = TransformPair(*CASES[case])
    jxe, jxo = pair.jax_encode(pair.x)
    with torch.no_grad():
        pxe, pxo = pair.pm.encode(nchw(pair.x))
    assert len(pxo) == len(jxo)
    close(nhwc(pxe), jxe, f"{case} LL")
    for i, (a, b) in enumerate(zip(pxo, jxo)):
        close(nhwc(a), b, f"{case} details {i}")
    # decode the same subbands in both packages
    want = pair.jax_decode(jxe, jxo)
    with torch.no_grad():
        got = pair.pm.decode(nchw(np.asarray(jxe)),
                             [nchw(np.asarray(t)) for t in jxo])
    close(nhwc(got), want, f"{case} synthesis")
    if CASES[case][4] == "none":         # lifting alone inverts exactly
        close(nhwc(got), pair.x, f"{case} round trip", 1e-4)


@pytest.mark.parametrize("split_mode", ["hv", 1])
def test_integer_lifting_matches_jax_and_maps_grid_to_grid(split_mode):
    pair = TransformPair(split_mode, 8, 1, 2, "none", seed=3)
    grid = (np.random.RandomState(4).randint(0, 256, (2, SIZE, SIZE, 1))
            / 255.0).astype(np.float32)
    jxe, jxo = pair.jax_encode(grid)
    with torch.no_grad():
        pxe, pxo = pair.pm.encode(nchw(grid))
        back = pair.pm.decode(pxe, pxo)
    got = np.concatenate([nhwc(pxe).ravel()] + [nhwc(t).ravel() for t in pxo])
    want = np.concatenate([np.asarray(jxe).ravel()]
                          + [np.asarray(t).ravel() for t in jxo])
    assert equal_share(got, want) >= EQUAL_SHARE
    close(got, want, "subbands", 2.0 / 255)      # a flip moves one grid step
    np.testing.assert_allclose(nhwc(back), grid, atol=1e-6)


def test_training_noise_follows_the_generator():
    pair = TransformPair("hv", 8, 1, 1, "none", seed=5)
    x = nchw(pair.x)

    def encode(seed):
        with torch.no_grad():
            return pair.pm.encode(x, True, torch.Generator().manual_seed(seed))

    a, b, c = encode(1), encode(1), encode(2)
    assert torch.equal(a[1][0], b[1][0]) and not torch.equal(a[1][0], c[1][0])
    with torch.no_grad():
        ev = pair.pm.encode(x)
    # each rounding moves a value by at most half a grid step: one level,
    # LL through at most six roundings
    assert float((a[0] - ev[0]).abs().max()) <= 6 / 255
    with pytest.raises(ValueError, match="Generator"):
        pair.pm.encode(x, True)


# --- the codec --------------------------------------------------------------

LR, LAM = 1e-4, 400.0
CODEC = dict(PRESET, dwtlevels=2, lambda_=LAM, learning_rate=LR)


@pytest.fixture
def zero_noise(monkeypatch):
    """Pin the training noise to zero in both packages: the bottlenecks'
    quantization noise and integer lifting's."""
    for mod in (jmu, jbn):
        monkeypatch.setattr(mod, "quantize_noise", lambda x, rng=None: x)
    for mod in (pmu, pbn):
        monkeypatch.setattr(mod, "quantize_noise",
                            lambda x, generator=None: x)
    monkeypatch.setattr(jq, "lifting_round",
                        lambda x, bits, rng=None: x if rng is not None
                        else jmu.lifting_round(x, bits))
    # the port's eval rounding is lifting_add; lifting_round draws noise
    monkeypatch.setattr(pq, "lifting_round",
                        lambda x, bits, generator=None: x)


def codec_pair(seed):
    jcfg = jconfig.Config(**CODEC)
    pcfg = pconfig.Config(**CODEC).validate()
    x = pdata.synthetic_natural_images(1, SIZE, seed=1)[0][None].astype(
        np.float32) / 255.0
    model = JCodec(jcfg)
    flat = draw(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), False))["params"], seed)
    pmodel = PCodec(pcfg)
    weights.load_flax_params(pmodel, flat)
    return jcfg, pcfg, x, model, flat, pmodel


def test_codec_eval_forward_matches_jax():
    jcfg, pcfg, x, model, flat, pmodel = codec_pair(2)
    out, xhat = jax.jit(lambda p, b: _jax_eval(jcfg, model, p, b))(
        tree(flat), jnp.asarray(x))
    p_out, p_xhat = pstate.make_eval_step(pcfg, pmodel, "cpu")(nchw(x))
    for k in ("loss", "mse", "rate1", "rate2"):
        np.testing.assert_allclose(float(getattr(p_out, k)),
                                   float(getattr(out, k)), rtol=1e-4,
                                   err_msg=k)
    # the analysis: the same symbols, values to fp32 rounding
    jxe, jxo = jax.jit(lambda p, v: model.apply(
        {"params": p}, v, method=lambda m, u: m.codec.transform.encode(u)))(
        tree(flat), jnp.asarray(x) - 0.5)
    with torch.no_grad():
        pxe, pxo = pmodel.codec.transform.encode(nchw(x) - 0.5)
    for got, want in zip([pxe] + pxo, [jxe] + list(jxo)):
        np.testing.assert_array_equal(np.round(nhwc(got)),
                                      np.round(np.asarray(want)))
        close(nhwc(got), want, "subband")
    # the synthesis: where a value sits within an ulp of a grid boundary
    # one rounding flips and moves the pixels it reaches by a grid step
    diff = np.abs(nhwc(p_xhat) - np.asarray(xhat))
    assert float(diff.max()) <= 2.0 / 255 + 1e-5
    assert float(diff.mean()) <= 5e-4


def _jax_eval(jcfg, model, params, batch):
    xs, xhat, ixe, ixo, _ = jstate.apply_color_forward(
        jcfg, model, params, batch, False, None)
    xhat = jnp.clip(xhat, -0.5, 0.5)
    return jloss.rd_loss3(xs, xhat, ixe, ixo, jcfg.lambda_, 1.0), xhat


def test_adam_train_step_matches_jax(zero_noise):
    jcfg, pcfg, x, model, flat, pmodel = codec_pair(3)
    params = tree(flat)

    @jax.jit
    def grads(p, batch):
        def loss_fn(q):
            xs, xhat, ixe, ixo, aux = jstate.apply_color_forward(
                jcfg, model, q, batch, True, jax.random.PRNGKey(0))
            out = jloss.rd_loss3(xs, xhat, ixe, ixo, LAM, 1.0)
            return out.loss + aux, out
        return jax.grad(loss_fn, has_aux=True)(p)

    tx = jstate.make_optimizer(jcfg)
    j_grads, j_out = grads(params, jnp.asarray(x))
    j1 = weights.state_dict_from_flax(weights.flatten_params(jax.jit(
        lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        params, j_grads)))
    g = weights.state_dict_from_flax(weights.flatten_params(j_grads))
    p0 = {n: p.detach().clone() for n, p in pmodel.named_parameters()}
    step = pstate.make_train_step(pcfg, pmodel,
                                  pstate.make_optimizer(pcfg, pmodel), "cpu")
    p_out, _ = step(nchw(x), torch.Generator().manual_seed(0), LR, 1.0)
    for k in ("loss", "mse", "rate1", "rate2"):
        np.testing.assert_allclose(float(getattr(p_out, k)),
                                   float(getattr(j_out, k)), rtol=1e-5,
                                   err_msg=k)
    compared = 0
    for name, p in pmodel.named_parameters():
        w = g[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * max(np.abs(w).max(), 1e-12), name
        gm = np.abs(w)
        mask = (gm > 1e-2 * gm.max()) & (gm > 1e-6)
        d_got = (p.detach() - p0[name]).numpy()
        d_want = (j1[name] - p0[name]).numpy()
        assert np.abs(d_got).max() <= 1.01 * LR, name
        assert np.abs(d_got - d_want)[mask].max(initial=0.0) <= 0.02 * LR, name
        compared += int(mask.sum())
    assert compared > 0.3 * sum(p.numel() for p in p0.values())
    # the lifting nets' weights moved
    assert any(n.startswith("codec.transform.layers_1.lift_ver2.update2_0")
               and p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in pmodel.named_parameters())


# --- the snapshots ----------------------------------------------------------

@pytest.mark.parametrize("path", SNAPSHOTS, ids=os.path.basename)
def test_snapshot_loads_strictly_and_carries_back_unchanged(path):
    flat = weights.load_npz(path)
    model = PCodec(pconfig.Config(**PRESET).validate())
    weights.load_flax_params(model, flat)
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in flat.values()) == 320994
    lifting = [m for m in model.modules() if isinstance(m, pq._PredUpdNet)]
    assert len(lifting) == 3 * 3 * 4          # levels x nets x P/U nets
    assert all(m.Conv_0.bias is None and m.Conv_1.bias is None
               and tuple(m.Conv_0.weight.shape) == (96, 3, 3, 3)
               for m in lifting)
    back = weights.flax_params_from_state_dict(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32),
                                      err_msg=k)
    with pytest.raises(KeyError):
        weights.load_flax_params(PCodec(pconfig.Config(
            **dict(PRESET, dwtlevels=2)).validate()), flat)


def test_unknown_split_mode_raises_when_the_transform_is_built():
    cfg = dataclasses.replace(pconfig.Config(**PRESET).validate(),
                              split_mode="diag")
    with pytest.raises(ValueError, match="split mode"):
        ptr.make_transform(cfg)
