"""The port's tree-based entropy models against the JAX package's, on the
CPU: onlyEZWT (nearest and learned parent upsampling) and ZTBlock, with
seeded numpy weights carried into both packages by ``tools/weights.py``.

- forward, eval mode, fp32: each subband's summed self-information (its
  rate) within 1e-5 relative, and every sample's within 2e-3 bits (as
  ``tests/test_torch_codec.py`` holds ZTsep's: where a likelihood sits in
  a Gaussian's far tail, -log2 of it moves by ~100 bits per unit of mu, so
  mu's last-ulp differences reach 1e-4 bits there); the quantized LL and
  coarsest details equal, the finer levels'
  ``round(x - mu) + mu`` within 1e-5 (mu is a conv output: its last ulps
  differ, a flipped rounding would be off by 1); the coding path's
  parameter passes ``level_params_from_parent`` / ``level_coset_params``:
  CDF indexes equal, mu within 1e-5 of its largest value;
- gradients of the summed information (training, noise pinned to zero)
  against ``jax.grad``, per tensor within 1e-4 of the tensor's max |grad|;
- one Adam step of the whole codec (CDF 9/7 transform, per-plane YCbCr,
  2 levels, 32x32) to ``tests/test_torch_train_step.py``'s tolerances: the
  port's train step against the JAX package's loss differentiated and its
  optimizer's update (its train step's arithmetic, traced once);
- a bf16 config keeps onlyEZWT's parent-context stacks in fp32;
- weights carried both ways, the transposed conv's taps included.

onlyEZWT runs 3 levels at 64x64 (and one joint-RGB case at 2 levels);
ZTBlock 2 levels, since its JAX trace grows with the number of dep-nets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    bottleneck as pbn, gaussian as pg, models as pem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    fast_conv as pfc, math_utils as pmu, upscaling as pup)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    data as pdata, state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    bottleneck as jbn, gaussian as jg, models as jem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    math_utils as jmu, upscaling as jup)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    loss as jloss, state as jstate)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

SIZE = 64
INFO_RTOL = 1e-5     # a subband's summed information, relative
INFO_ATOL = 2e-3     # bits, each sample
MU_RTOL = 1e-5       # of max |mu|
Q_ATOL = 1e-5
GRAD_TOL = 1e-4      # of a tensor's max |grad|
# (entropy_layer, zt_upsample, clrch, dwtlevels)
CASES = {"ezwt": ("onlyEZWT", "nearest", 1, 3),
         "ezwt_learned": ("onlyEZWT", "learned", 1, 3),
         "ezwt_rgb": ("onlyEZWT", "nearest", 3, 2),
         "ztblock": ("DWTConditioned2EntropyLayerZTBlock", "nearest", 1, 2)}
JAX_MODEL = {"onlyEZWT": jem.OnlyEZWT,
             "DWTConditioned2EntropyLayerZTBlock": jem.ZTBlock}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def draw(shapes, seed):
    """Flat flax params drawn from numpy for a tree of shapes: conv kernels
    with std 1/sqrt(fan_in), bottleneck quantiles around [-8, 0, 8], every
    other leaf small."""
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
        elif leaf == "beta":
            v = 1.0 + 0.05 * np.abs(n)
        elif leaf == "gamma":
            v = np.sqrt(0.1) * np.eye(v.shape[0]) + 0.05 * np.abs(n)
        else:
            v = 0.05 * n
        out[k] = v.astype(np.float32)
    return out


def tree(flat):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  weights.unflatten_params(flat))


def subbands(c, levels, seed):
    """A pyramid in NHWC: LL and details spread over a few bins."""
    rng = np.random.RandomState(seed)
    s = SIZE >> levels
    xe = (rng.randn(1, s, s, c) * 4).astype(np.float32)
    xo = [(rng.randn(1, SIZE >> (i + 1), SIZE >> (i + 1), 3 * c)
           * (2.0 + i)).astype(np.float32) for i in range(levels)]
    return xe, xo


class Pair:
    """One entropy model in both packages, the same weights."""

    def __init__(self, case, seed=0):
        el, up, c, levels = CASES[case]
        kw = dict(entropy_layer=el, zt_upsample=up, clrch=c, dwtlevels=levels)
        self.jcfg = jconfig.Config(**kw)
        self.pcfg = pconfig.Config(**kw).validate()
        self.xe, self.xo = subbands(c, levels, seed + 1)
        self.jm = JAX_MODEL[el](self.jcfg)
        shapes = jax.eval_shape(lambda: self.jm.init(
            jax.random.PRNGKey(0), jnp.asarray(self.xe),
            [jnp.asarray(t) for t in self.xo], False))["params"]
        self.flat = draw(shapes, seed)
        self.params = tree(self.flat)
        self.pm = pem.make_entropy_model(self.pcfg)
        weights.load_flax_params(self.pm, self.flat)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return Pair(request.param)


@pytest.fixture
def zero_noise(monkeypatch):
    """Pin the training quantization noise to zero in both packages."""
    for mod in (jmu, jg, jem, jbn):
        monkeypatch.setattr(mod, "quantize_noise", lambda x, rng=None: x)
    for mod in (pmu, pg, pem, pbn):
        monkeypatch.setattr(mod, "quantize_noise",
                            lambda x, generator=None: x)


def close(got, want, rtol, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rtol * np.abs(want).max(), \
        f"{what}: {err:.3e} > {rtol} * {np.abs(want).max():.3e}"


def close_info(got, want, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert abs(got.sum() - want.sum()) <= INFO_RTOL * want.sum(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=INFO_ATOL,
                               err_msg=what)


def test_forward_matches_jax(pair):
    L = pair.pcfg.dwtlevels
    want = jax.jit(lambda p, xe, xo: pair.jm.apply(
        {"params": p}, xe, xo, False))(pair.params, jnp.asarray(pair.xe),
                                       [jnp.asarray(t) for t in pair.xo])
    with torch.no_grad():
        got = pair.pm(nchw(pair.xe), [nchw(t) for t in pair.xo])
    info_xe, info_xo, xe_q, xo_q = got
    j_info_xe, j_info_xo, j_xe_q, j_xo_q = want
    close_info(nhwc(info_xe), j_info_xe, "info_xe")
    np.testing.assert_array_equal(nhwc(xe_q), np.asarray(j_xe_q))
    for i in range(L):
        close_info(nhwc(info_xo[i]), j_info_xo[i], f"info_xo[{i}]")
        if i == L - 1 or pair.pcfg.entropy_layer != "onlyEZWT":
            # a bottleneck's median, or ZTBlock's plain rounding: exact
            np.testing.assert_array_equal(nhwc(xo_q[i]), np.asarray(j_xo_q[i]))
        else:
            np.testing.assert_allclose(nhwc(xo_q[i]), np.asarray(j_xo_q[i]),
                                       rtol=0, atol=Q_ATOL)
    assert np.isfinite(nhwc(info_xo[0])).all() and float(info_xo[0].mean()) > 0


def _param_passes(pair):
    """The coding path's parameter passes in both packages, on the decoded
    coarsest details and random earlier cosets: [(name, (sigma, mu) port,
    (sigma, mu) JAX)]."""
    L = pair.pcfg.dwtlevels
    parent = np.round(pair.xo[L - 1])
    out = []
    if pair.pcfg.entropy_layer == "onlyEZWT":
        method = jem.OnlyEZWT.level_params_from_parent
        i = L - 2
        with torch.no_grad():
            got = pair.pm.level_params_from_parent(i, nchw(parent))
        want = jax.jit(lambda p, x: pair.jm.apply(
            {"params": p}, i, x, method=method))(pair.params,
                                                 jnp.asarray(parent))
        out.append((f"level {i}", got, want))
        return out
    rng = np.random.RandomState(5)
    prev = [np.round(rng.randn(*parent.shape) * 3).astype(np.float32)
            for _ in range(3)]
    for k in range(4):
        method = jem.ZTBlock.level_coset_params
        with torch.no_grad():
            got = pair.pm.level_coset_params(0, k, nchw(parent),
                                             *[nchw(p) for p in prev[:k]])
        want = jax.jit(lambda p, x, *c, k=k: pair.jm.apply(
            {"params": p}, 0, k, x, *c, method=method))(
            pair.params, jnp.asarray(parent), *[jnp.asarray(p)
                                                for p in prev[:k]])
        out.append((f"coset {k}", got, want))
    return out


def test_coding_parameter_passes_match_jax(pair):
    for name, (sigma, mu), (j_sigma, j_mu) in _param_passes(pair):
        idx = nhwc(pg.build_indexes(sigma))
        j_idx = np.asarray(jg.build_indexes(j_sigma))
        assert len(np.unique(j_idx)) > 3, name
        np.testing.assert_array_equal(idx, j_idx, err_msg=name)
        close(nhwc(mu), j_mu, MU_RTOL, f"{name} mu")


def test_encode_chain_matches_the_forward_passes(pair):
    """``encode_chain``'s CDF indexes and writebacks are the parameter
    passes' on the writeback of the level before (the decoder's view)."""
    L = pair.pcfg.dwtlevels
    con = nchw(np.round(pair.xo[L - 1]))
    xo = [nchw(t) for t in pair.xo]
    with torch.no_grad():
        syms, idxs, hats = pair.pm.encode_chain(xo[:-1], con)
        if pair.pcfg.entropy_layer == "onlyEZWT":
            sigma, mu = pair.pm.level_params_from_parent(L - 2, con)
            assert torch.equal(idxs[L - 2], pg.build_indexes(sigma))
            assert torch.equal(hats[L - 2], syms[L - 2].float() + mu)
            if L > 2:
                sigma, _ = pair.pm.level_params_from_parent(L - 3,
                                                            hats[L - 2])
                assert torch.equal(idxs[L - 3], pg.build_indexes(sigma))
        else:
            cosets = []
            for k in range(4):
                sigma, mu = pair.pm.level_coset_params(0, k, con, *cosets)
                assert torch.equal(idxs[0][k], pg.build_indexes(sigma))
                cosets.append(syms[0][k].float() + mu)
            assert torch.equal(hats[0], pem._interleave_cosets(*cosets))
            assert torch.equal(torch.stack(pem._cosets(hats[0])),
                               torch.stack(cosets))


def test_gradients_match_jax(pair, zero_noise):
    """Training forward with the noise pinned to zero: the summed
    information plus the aux loss, differentiated in both packages."""
    def j_loss(p, xe, xo):
        ixe, ixo, _, _ = pair.jm.apply({"params": p}, xe, xo, True,
                                       rngs={"noise": jax.random.PRNGKey(0)})
        aux = pair.jm.apply({"params": p}, method=type(pair.jm).aux_loss)
        return jnp.sum(ixe) + sum(jnp.sum(t) for t in ixo) + aux

    want = jax.jit(jax.grad(j_loss))(pair.params, jnp.asarray(pair.xe),
                                     [jnp.asarray(t) for t in pair.xo])
    want = weights.state_dict_from_flax(weights.flatten_params(want))
    pair.pm.zero_grad(set_to_none=True)
    ixe, ixo, _, _ = pair.pm(nchw(pair.xe), [nchw(t) for t in pair.xo], True,
                             torch.Generator().manual_seed(0))
    (ixe.sum() + sum(t.sum() for t in ixo) + pair.pm.aux_loss()).backward()
    got = {n: p.grad for n, p in pair.pm.named_parameters()}
    assert set(got) == set(want)
    moved = 0
    for name in sorted(want):
        w = want[name].numpy()
        assert got[name] is not None, name
        close(got[name].numpy(), w, GRAD_TOL, name)
        moved += bool(np.abs(w).max() > 0)
    assert moved == len(want)       # every parameter takes part


def test_noise_draws_follow_the_generator(pair):
    """Training draws: repeatable from the generator's seed, changed by
    another seed."""
    args = (nchw(pair.xe), [nchw(t) for t in pair.xo], True)
    with torch.no_grad():
        a = pair.pm(*args, torch.Generator().manual_seed(1))
        b = pair.pm(*args, torch.Generator().manual_seed(1))
        c = pair.pm(*args, torch.Generator().manual_seed(2))
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert not torch.equal(a[1][0], c[1][0])


# --- one Adam step of the whole codec ---------------------------------------

LR, LAM = 1e-4, 200.0
CODEC = dict(netType="CDF97", autoencoder="SubbandAutoEncoder", clrch=1,
             dwtlevels=2, lambda_=LAM, learning_rate=LR)


@pytest.mark.parametrize("case", ["ezwt_learned", "ztblock"])
def test_adam_train_step_matches_jax(case, zero_noise):
    el, up, _, _ = CASES[case]
    kw = dict(CODEC, entropy_layer=el, zt_upsample=up)
    jcfg = jconfig.Config(**kw)
    pcfg = pconfig.Config(**kw).validate()
    x = pdata.synthetic_natural_images(1, 32, seed=1)[0][None].astype(
        np.float32) / 255.0
    model = JCodec(jcfg)
    flat = draw(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), False))["params"], 3)
    params = tree(flat)

    # the JAX package's loss, differentiated, and its optimizer's update:
    # its train step's arithmetic, traced once (the step's own jit would
    # trace the codec a second time)
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

    pmodel = PCodec(pcfg)
    weights.load_flax_params(pmodel, flat)
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
        close(p.grad.numpy(), w, 1e-3, name)
        gm = np.abs(w)
        mask = (gm > 1e-2 * gm.max()) & (gm > 1e-5)
        d_got = (p.detach() - p0[name]).numpy()
        d_want = (j1[name] - p0[name]).numpy()
        assert np.abs(d_got).max() <= 1.01 * LR, name
        assert np.abs(d_got - d_want)[mask].max(initial=0.0) <= 0.02 * LR, name
        compared += int(mask.sum())
    # most of ZTBlock's dep-net entries have gradients under 1e-5
    assert compared > 0.1 * sum(p.numel() for p in p0.values())


# --- dtype, weights ---------------------------------------------------------

def test_bf16_config_keeps_the_ezwt_plc_stacks_in_fp32(monkeypatch):
    cfg = pconfig.flagship_config(entropy_layer="onlyEZWT", dtype="bfloat16",
                                  dwtlevels=2)
    model = PCodec(cfg, generator=torch.Generator().manual_seed(0))
    em = model.codecs[0].entropymodel
    assert all(layer.dtype is None for layer in em.plc[0].layers)
    seen = []
    real = pfc.conv3x3_halo

    def spy(x, w, dtype):
        seen.append((w.shape[0], dtype))
        return real(x, w, dtype)

    monkeypatch.setattr(pfc, "conv3x3_halo", spy)
    x = torch.rand(1, 3, 32, 32)
    with torch.no_grad():
        model(x)
    plc = [dt for cout, dt in seen if cout == 243]
    assert plc == [torch.float32] * 6              # 2 layers x 3 planes
    assert {dt for cout, dt in seen if cout != 243} == {torch.bfloat16}


def test_weights_round_trip_both_ways():
    pair = Pair("ezwt_learned", seed=4)
    sd = pair.pm.state_dict()
    flat = weights.flax_params_from_state_dict(sd)
    assert set(flat) == set(pair.flat)
    for k, v in pair.flat.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    key = "['ups_0']['Upscale_0']['ConvTranspose_0']['kernel']"
    assert pair.flat[key].shape == (2, 2, 3, 3)
    assert sd["ups_0.Upscale_0.ConvTranspose_0.weight"].shape == (3, 3, 2, 2)
    zt = Pair("ztblock", seed=6)
    names = set(zt.pm.state_dict())
    assert "dep_mu_2_3.Conv_4.weight" in names
    assert zt.pm.dep_sigma[2][1].layers[0].weight.shape == (32, 2, 3, 3)
    back = weights.state_dict_from_flax(
        weights.flax_params_from_state_dict(zt.pm.state_dict()))
    assert all(torch.equal(back[n], t) for n, t in zt.pm.state_dict().items())


def test_asymmetric_transposed_conv_taps_match_flax():
    """An asymmetric 2x2 kernel: the port's ConvTranspose, loaded through
    the weight carrier, gives flax's output, and the upscaler as a whole
    too."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    m = jup.ZeroTreePreviousLayer(3, 3)
    flat = draw(jax.eval_shape(lambda: m.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"], 8)
    k = flat["['Upscale_0']['ConvTranspose_0']['kernel']"]
    assert not np.allclose(k, k[::-1]) and not np.allclose(k, k[:, ::-1])
    want = m.apply({"params": tree(flat)}, jnp.asarray(x))
    port = pup.ZeroTreePreviousLayer(3, 3)
    weights.load_flax_params(port, flat)
    with torch.no_grad():
        got = port(nchw(x))
    close(nhwc(got), want, 1e-6, "ZeroTreePreviousLayer")
    # the transposed conv alone: one input pixel writes one 2x2 block
    ct = flat["['Upscale_0']['ConvTranspose_0']['kernel']"]
    one = np.zeros((1, 1, 1, 3), np.float32)
    one[0, 0, 0, 1] = 1.0
    with torch.no_grad():
        y = port.Upscale_0.ConvTranspose_0(nchw(one))
    y = nhwc(y)[0] - flat["['Upscale_0']['ConvTranspose_0']['bias']"]
    for a in range(2):
        for b in range(2):
            np.testing.assert_allclose(y[a, b], ct[1 - a, 1 - b, 1],
                                       rtol=1e-6)
