"""The port's other transforms against the JAX package's, on the CPU:
BasicWavelet (with and without ``linearity_flag``), AttentionWavelet and
AttentionWaveletPostProcessing, the CBAM head alone, ``dwt97_conv`` and
``ChannelIncrementalConv2d``; the weight carrier's new leaf kinds both
ways; and ``make_transform``'s dispatch. Inputs come from numpy with fixed
seeds; weights are drawn with numpy in the JAX package's shapes and carried
by ``tools/weights.py``.

Tolerance 1e-5 of max(1, max |value|): fp32 sums in another order.
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
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec, reset_conv_weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    cbam as pcbam, dwt97 as pdwt, dwt97_conv as pdc, fast_conv as pfc,
    masked_conv as pmc)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models import (
    transforms as jtr)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    cbam as jcbam, dwt97_conv as jdc, masked_conv as jmc)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

TOL = 1e-5
SIZE = 32


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def draw(mod, *args, seed):
    """Flat flax params of ``mod`` drawn from numpy: kernels with std
    1/sqrt(fan_in), GDN terms near their init and positive, GroupNorm
    scales near 1, every other leaf small."""
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in weights.flatten_params(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32),
            shapes["params"])).items():
        leaf = k.rsplit("['", 1)[1][:-2]
        n = rng.randn(*v.shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(v.shape[:-1]))
        elif leaf == "beta":
            v = 1.0 + 0.05 * np.abs(n)
        elif leaf == "gamma":
            v = np.sqrt(0.1) * np.eye(v.shape[0]) + 0.05 * np.abs(n)
        elif leaf == "scale":
            v = 1.0 + 0.1 * n
        else:
            v = 0.05 * n
        out[k] = np.asarray(v, np.float32)
    return out


def tree(flat):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  weights.unflatten_params(flat))


def close(got, want, what, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol} * {scale:.3g}"


# (netType, linearity_flag, clrch)
CASES = {"basic": ("BasicWavelet", 1, 3),
         "basic_linear": ("BasicWavelet", 0, 3),
         "attention": ("AttentionWavelet", 1, 3),
         "attention_gray": ("AttentionWavelet", 1, 1),
         "attention_post": ("AttentionWaveletPostProcessing", 1, 3)}


@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_jax(case):
    net, lf, c = CASES[case]
    kw = dict(netType=net, linearity_flag=lf, clrch=c, dwtlevels=2,
              autoencoder="SubbandAutoEncoder")
    jcfg, pcfg = jconfig.Config(**kw), pconfig.Config(**kw).validate()
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, c).astype(
        np.float32) - 0.5
    jm = jtr.make_transform(jcfg)
    flat = draw(jm, jnp.asarray(x), seed=2)
    params = tree(flat)
    pm = ptr.make_transform(pcfg)
    weights.load_flax_params(pm, flat)
    jxe, jxo = jax.jit(lambda p, v: jm.apply({"params": p}, v,
                                             method="encode"))(params,
                                                               jnp.asarray(x))
    with torch.no_grad():
        pxe, pxo = pm.encode(nchw(x))
    close(nhwc(pxe), jxe, f"{case} LL")
    for i, (a, b) in enumerate(zip(pxo, jxo)):
        assert a.shape[1] == 3 * c
        close(nhwc(a), b, f"{case} details {i}")
    want = jax.jit(lambda p, e, o: jm.apply({"params": p}, e, o,
                                            method="decode"))(params, jxe, jxo)
    with torch.no_grad():
        got = pm.decode(nchw(np.asarray(jxe)),
                        [nchw(np.asarray(t)) for t in jxo])
    close(nhwc(got), want, f"{case} synthesis")


def test_basic_wavelet_without_gdn_creates_no_unused_layers():
    cfg = pconfig.Config(netType="BasicWavelet", linearity_flag=0, clrch=3,
                         dwtlevels=2, autoencoder="none").validate()
    names = {n.split(".")[0] for n in ptr.make_transform(cfg).state_dict()}
    assert names == {"fwd_0_0", "fwd_1_0", "inv_0_1", "inv_1_1"}


def test_transposed_inv_kernel_is_mirrored_as_flax_applies_it():
    """BasicWavelet's ``inv_{i}_1`` with an asymmetric kernel: one input
    pixel through the port's transposed conv, loaded by the carrier, gives
    flax's 3x3 block (the kernel's taps mirrored), and the decode as a
    whole gives flax's output."""
    kw = dict(netType="BasicWavelet", linearity_flag=0, clrch=1, dwtlevels=1,
              autoencoder="none")
    jcfg, pcfg = jconfig.Config(**kw), pconfig.Config(**kw).validate()
    jm = jtr.make_transform(jcfg)
    flat = draw(jm, jnp.zeros((1, 8, 8, 1)), seed=5)
    key = "['inv_0_1']['kernel']"
    k = flat[key]
    assert k.shape == (3, 3, 4, 1)
    assert not np.allclose(k, k[::-1]) and not np.allclose(k, k[:, ::-1])
    pm = ptr.make_transform(pcfg)
    weights.load_flax_params(pm, flat)
    one = np.zeros((1, 4, 4, 4), np.float32)
    one[0, 1, 1, 2] = 1.0
    xe, xo = one[..., :1], [one[..., 1:]]
    want = jm.apply({"params": tree(flat)}, jnp.asarray(xe),
                    [jnp.asarray(xo[0])], method="decode")
    with torch.no_grad():
        got = pm.decode(nchw(xe), [nchw(xo[0])])
    close(nhwc(got), want, "decode of an impulse", 1e-6)
    # input pixel (1, 1) writes output rows and columns 2..4
    block = nhwc(got)[0, 2:5, 2:5, 0] - flat["['inv_0_1']['bias']"]
    np.testing.assert_allclose(block, k[::-1, ::-1, 2, 0], rtol=1e-6)


def test_strided_conv_pads_as_flax():
    """The stride-2 SAME conv on even and odd sides (flax pads (0, 1) on an
    even side, (1, 1) on an odd one)."""
    import flax.linen as fnn
    for hw in ((8, 8), (9, 7)):
        x = np.random.RandomState(3).randn(1, *hw, 2).astype(np.float32)
        m = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME")
        flat = draw(m, jnp.asarray(x), seed=4)
        want = m.apply({"params": tree(flat)}, jnp.asarray(x))
        port = pfc.StridedConv2d(2, 4)
        weights.load_flax_params(port, flat)
        with torch.no_grad():
            got = port(nchw(x))
        close(nhwc(got), want, f"stride-2 conv {hw}", 1e-6)


def test_cbam_head_matches_jax():
    x = np.random.RandomState(6).randn(2, 16, 16, 3).astype(np.float32)
    jm = jcbam.CBAMPostProcessing(clrch=3)
    flat = draw(jm, jnp.asarray(x), seed=7)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(tree(flat),
                                                            jnp.asarray(x))
    pm = pcbam.CBAMPostProcessing(3)
    weights.load_flax_params(pm, flat)
    with torch.no_grad():
        got = pm(nchw(x))
    close(nhwc(got), want, "CBAM head")
    assert pm.CBAM_0.ChannelGate_0.Dense_0.weight.shape == (12, 192)
    assert pm.res_weight.dim() == 0


def test_dwt97_conv_level_matches_jax_and_the_ladder():
    x = np.random.RandomState(8).randn(2, 16, 24, 3).astype(np.float32)
    jf = jdc.cdf97_filters()
    pf = pdc.cdf97_filters()
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want = jdc.dwt97_conv_level(jnp.asarray(x))
    got = pdc.dwt97_conv_level(nchw(x))
    for name, a, b in zip(("ll", "lh", "hl", "hh"), got, want):
        close(nhwc(a), b, f"dwt97_conv {name}")
    ll, pack = pdwt.level_analysis_plain(nchw(x))
    close(got[0].numpy(), ll.numpy(), "against the ladder: ll")
    close(pdwt.pack_details(*got[1:]).numpy(), pack.numpy(),
          "against the ladder: details")


@pytest.mark.parametrize("mask_type", ["A", "B"])
def test_channel_incremental_conv_matches_jax(mask_type):
    x = np.random.RandomState(9).randn(2, 6, 6, 6).astype(np.float32)
    jm = jmc.ChannelIncrementalConv2d(9, (3, 3), blocks=3,
                                      mask_type=mask_type)
    flat = draw(jm, jnp.asarray(x), seed=10)
    want = jm.apply({"params": tree(flat)}, jnp.asarray(x))
    pm = pmc.ChannelIncrementalConv2d(6, 9, (3, 3), blocks=3,
                                      mask_type=mask_type)
    weights.load_flax_params(pm, flat)
    with torch.no_grad():
        got = pm(nchw(x))
    close(nhwc(got), want, f"channel-incremental {mask_type}")
    in_blk = np.repeat(np.arange(3), 2)
    out_blk = np.repeat(np.arange(3), 3)
    jmask = (in_blk[:, None] < out_blk[None, :]) if mask_type == "A" \
        else (in_blk[:, None] <= out_blk[None, :])
    np.testing.assert_array_equal(pm.mask[:, :, 0, 0].numpy(),
                                  jmask.T.astype(np.float32))


def test_new_leaf_kinds_carry_both_ways():
    """Bias-free convs, the mirrored ``inv_{i}_1``, Dense kernels,
    GroupNorm ``scale`` and the 0-d ``res_weight``: flax -> port -> flax
    and port -> flax -> port unchanged, in the layouts each side uses."""
    for net, lf in (("BasicWavelet", 1), ("QuincunxLifting", 1),
                    ("AttentionWaveletPostProcessing", 1)):
        kw = dict(netType=net, linearity_flag=lf, clrch=3, dwtlevels=2,
                  entropy_layer="factorized", autoencoder="SubbandAutoEncoder")
        jcfg = jconfig.Config(**kw)
        jm = JCodec(jcfg)
        flat = draw(jm, jnp.zeros((1, SIZE, SIZE, 3)), False, seed=11)
        model = PCodec(pconfig.Config(**kw).validate())
        weights.load_flax_params(model, flat)
        back = weights.flax_params_from_state_dict(model.state_dict())
        assert set(back) == set(flat)
        for k, v in flat.items():
            assert back[k].shape == v.shape, k
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        sd = model.state_dict()
        again = weights.state_dict_from_flax(back)
        assert all(torch.equal(again[n], t) for n, t in sd.items())
    t = "codec.transform."
    assert sd[t + "postprocess.res_weight"].dim() == 0
    assert sd[t + "postprocess.CBAM_0.ChannelGate_0.Dense_1.weight"].shape \
        == (192, 12)
    assert sd[t + "postprocess.CBAM_0.SpatialGate_0.GroupNorm_0.scale"].shape \
        == (1,)
    assert t + "postprocess.CBAM_0.SpatialGate_0.Conv_0.bias" not in sd
    assert weights.TRANSPOSED.fullmatch(t + "inv_1_1.weight")
    assert not weights.TRANSPOSED.fullmatch(t + "inv_1_0.weight")
    assert not weights.TRANSPOSED.fullmatch(t + "yh_ae_0.inv_1_1.weight")
    with pytest.raises(ValueError, match="dense kernel must be 2-D"):
        weights.state_dict_from_flax(
            {"['a']['Dense_0']['kernel']": np.zeros((1, 1, 2, 3))})


@pytest.mark.parametrize("net", ["BasicWavelet", "AttentionWavelet",
                                 "AttentionWaveletPostProcessing",
                                 "QuincunxLifting"])
def test_parameter_counts_and_seeded_init(net):
    """The port's model has the JAX package's parameters, and its seeded
    init gives every weight lecun-normal spread, biases zero, GroupNorm at
    scale 1 and the CBAM skip at 0.1."""
    kw = dict(netType=net, clrch=3, dwtlevels=2, entropy_layer="factorized",
              autoencoder="SubbandAutoEncoder", lif_prec_bits=8)
    jm = JCodec(jconfig.Config(**kw))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), False))
    want = sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(shapes["params"]))
    model = PCodec(pconfig.Config(**kw).validate(),
                   generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == want
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2 and p.shape[1] > 1:
            fan = p[:, 0].numel() if weights.TRANSPOSED.fullmatch(name) \
                else p[0].numel()
            assert 0.5 < float(p.detach().std()) * fan ** 0.5 < 1.5, name
        elif leaf == "scale":
            assert torch.equal(p, torch.ones_like(p)), name
        elif leaf == "res_weight":
            assert float(p) == pytest.approx(0.1), name


@pytest.mark.parametrize("net", ["BasicWavelet",
                                 "AttentionWaveletPostProcessing"])
def test_eval_and_train_steps_run(net):
    cfg = pconfig.Config(netType=net, clrch=3, dwtlevels=2,
                         entropy_layer="factorized", lambda_=100.0).validate()
    model = PCodec(cfg, generator=torch.Generator().manual_seed(1))
    batch = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator()
                       .manual_seed(2))
    out, xhat = pstate.make_eval_step(cfg, model, "cpu")(batch)
    assert xhat.shape == batch.shape and torch.isfinite(out.loss)
    step = pstate.make_train_step(cfg, model,
                                  pstate.make_optimizer(cfg, model), "cpu")
    out, _ = step(batch, torch.Generator().manual_seed(3), 1e-4, 1.0)
    assert torch.isfinite(out.loss)
    assert all(p.grad is not None for p in model.parameters())


def test_make_transform_builds_all_six():
    cfg = pconfig.Config(clrch=3, dwtlevels=2, autoencoder="none").validate()
    kinds = {net: type(ptr.make_transform(dataclasses.replace(
        cfg, netType=net))).__name__ for net in pconfig.NET_TYPES}
    assert kinds == {
        "CDF97": "CDF97Transform",
        "LiftingBasedNeuralWaveletv4": "LearnedLiftingTransform",
        "BasicWavelet": "BasicWaveletTransform",
        "AttentionWavelet": "AttentionWaveletTransform",
        "AttentionWaveletPostProcessing": "AttentionWaveletTransform",
        "QuincunxLifting": "QuincunxLiftingTransform"}
    post = ptr.make_transform(dataclasses.replace(
        cfg, netType="AttentionWaveletPostProcessing"))
    assert isinstance(post.postprocess, pcbam.CBAMPostProcessing)
    model = ptr.make_transform(dataclasses.replace(cfg,
                                                   netType="BasicWavelet"))
    reset_conv_weights(model, torch.Generator().manual_seed(0))
    assert model.inv_0_1.weight.shape == (12, 3, 3, 3)
