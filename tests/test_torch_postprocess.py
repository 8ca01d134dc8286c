"""The port's restoration nets and post-processing stage against the JAX
package's, on the CPU.

- Each of the five nets (DnCNN, iwave, IRCNN, DIDN, DUDnCNN) with the same
  numpy-drawn variables in both packages, at 32x32: the eval forward (the
  running statistics) and the train forward (the batch's statistics) with
  the updated ``batch_stats``; 1e-5 of the largest value, the residual
  ``net(x) - x`` compared (the input itself would hide a wrong net).
- The weight carrier both ways over the flax ``variables`` tree.
- One post-processing train step of a 2-level flagship codec (clrch 1,
  Berk AEs, ZTsep) with iwave on a 32x32 image against
  ``train/postprocess_loop.py::make_postprocess_train_step``, the codec's
  noise pinned to zero in both: the loss terms at 1e-5, the restoration
  net's gradients at 1e-3 of a tensor's largest and its Adam update by the
  rule of ``tests/test_torch_train_step.py``.
- The agent's ``train_postprocess`` mode through the CLI, and the seeded
  init.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    cli as pcli, config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    gaussian as pg, models as pem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
    postprocess as ppp)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    math_utils as pmu)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    checkpoint as pckpt, data as pdata, postprocess_loop as ploop)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    gaussian as jg, models as jem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models import (
    postprocess as jpp)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    math_utils as jmu)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    postprocess_loop as jloop, state as jstate)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

KINDS = ("DnCNN", "iwave", "IRCNN", "DIDN", "DUDnCNN")
FWD_RTOL = 1e-5
RD_RTOL = 1e-5
GRAD_TOL = 1e-3
LR = ploop.LR
FLAGSHIP = dict(netType="LiftingBasedNeuralWaveletv4",
                entropy_layer="conditioned2ZTsepSubbands",
                autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=2,
                num_lifting_perlayer=2, filtersize=5, depth_scale=2,
                block_property="same", scale=0, linearity_flag=1,
                res_connection_weight=0.1, lambda_=200.0,
                postprocess="iwave", resnetlevel=2)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def random_variables(init, seed):
    """A flax ``variables`` dict drawn from numpy; only the shapes come
    from ``init``."""
    shapes = jax.eval_shape(init)
    rng = np.random.RandomState(seed)

    def draw(path, a):
        leaf = path[-1].key
        n = rng.randn(*a.shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf == "scale":
            v = 1.0 + 0.1 * n
        elif leaf == "var":
            v = 0.5 + np.abs(n)
        elif leaf == "negative_slope":
            v = 0.01 + 0.1 * np.abs(n)
        else:                           # bias, mean
            v = 0.05 * n
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def pp_config(kind):
    kw = dict(postprocess=kind, clrch=1, resnetlevel=6)
    return jconfig.Config(**kw), pconfig.Config(**kw).validate()


def port_net(pcfg, variables):
    net = ppp.make_postprocess(pcfg)
    net.load_state_dict(weights.state_dict_from_flax_variables(variables),
                        strict=True)
    return net


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


_NETS = {}


def _jax_net(kind):
    """(variables, jitted eval apply, jitted train apply) of one net,
    traced once per process."""
    if kind not in _NETS:
        jcfg, _ = pp_config(kind)
        model = jpp.make_postprocess(jcfg)
        x0 = jnp.zeros((2, 32, 32, 3))
        variables = random_variables(
            lambda: model.init(jax.random.PRNGKey(0), x0, True), 3)
        ev = jax.jit(lambda v, x: model.apply(v, x, False))
        tr = jax.jit(lambda v, x: model.apply(v, x, True,
                                              mutable=["batch_stats"]))
        _NETS[kind] = (variables, ev, tr)
    return _NETS[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_net_matches_flax_in_eval_and_train(kind):
    variables, ev, tr = _jax_net(kind)
    _, pcfg = pp_config(kind)
    net = port_net(pcfg, variables)
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(ev(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(net(nchw(x), False))
    assert rel(got - x, want - x) <= FWD_RTOL
    want_t, upd = tr(variables, jnp.asarray(x))
    with torch.no_grad():
        got_t = nhwc(net(nchw(x), True))
    assert rel(got_t - x, np.asarray(want_t) - x) <= FWD_RTOL
    stats = weights.flax_variables_from_state_dict(net.state_dict())
    flat_want = weights.flatten_params(jax.tree_util.tree_map(
        np.asarray, upd.get("batch_stats", {})))
    flat_got = weights.flatten_params(stats["batch_stats"])
    assert sorted(flat_got) == sorted(flat_want)
    assert (len(flat_got) > 0) == (kind in ("DnCNN", "DUDnCNN"))
    for k, v in flat_want.items():
        np.testing.assert_allclose(flat_got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_carrier_round_trips_the_flax_variables(kind):
    """flax -> port -> flax gives back every leaf of both collections, and
    the port's net holds exactly the flax tree's leaves."""
    variables, _, _ = _jax_net(kind)
    _, pcfg = pp_config(kind)
    back = weights.flax_variables_from_state_dict(
        port_net(pcfg, variables).state_dict())
    for col in ("params", "batch_stats"):
        want = weights.flatten_params(variables.get(col, {}))
        got = weights.flatten_params(back[col])
        assert sorted(got) == sorted(want), col
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_seeded_init_and_dispatch():
    _, pcfg = pp_config("DIDN")
    a = ppp.make_postprocess(pcfg, torch.Generator().manual_seed(3))
    b = ppp.make_postprocess(pcfg, torch.Generator().manual_seed(3))
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    prelu = a.get_submodule("_DIDNResidualBlock_0.PReLU_0")
    assert prelu.negative_slope.item() == pytest.approx(0.01)
    bn = ppp.make_postprocess(pp_config("DnCNN")[1]).BatchNorm_0
    assert bn.epsilon == 64.0 and bn.momentum == 0.99
    assert ppp.dudncnn_dilations(6) == [1, 1, 2, 4, 4, 2, 1, 1]
    with pytest.raises(ValueError, match="unknown postprocess"):
        ppp.make_postprocess(pconfig.Config(postprocess="none"))


@pytest.fixture
def zero_noise(monkeypatch):
    """Pin the training quantization noise to zero in both packages."""
    for mod in (jmu, jg, jem):
        monkeypatch.setattr(mod, "quantize_noise", lambda x, rng=None: x)
    for mod in (pmu, pg, pem):
        monkeypatch.setattr(mod, "quantize_noise",
                            lambda x, generator=None: x)


def test_postprocess_train_step_matches_the_jax_package(zero_noise):
    x = pdata.synthetic_natural_images(1, 32, seed=1)[0][None].astype(
        np.float32) / 255.0
    jcfg = jconfig.Config(**FLAGSHIP)
    pcfg = pconfig.Config(**FLAGSHIP).validate()
    codec = JCodec(jcfg)
    codec_params = jax.tree_util.tree_map(jnp.asarray, random_variables(
        lambda: codec.init(jax.random.PRNGKey(0), jnp.asarray(x), False),
        2)["params"])
    pp = jpp.make_postprocess(jcfg)
    pp_vars = random_variables(
        lambda: pp.init(jax.random.PRNGKey(0), jnp.asarray(x), True), 5)
    pp_vars = dict(pp_vars, batch_stats={})
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    opt_state = tx.init(pp_vars["params"])
    step = jloop.make_postprocess_train_step(jcfg, codec, pp, tx)

    @jax.jit
    def grads_and_step(codec_params, pp_vars, opt_state, batch):
        """The package's step, and its loss (the mse of the restored image)
        differentiated alone, traced into one program (one compile of the
        codec's forward)."""
        xs, xhat, _, _, _ = jstate.apply_color_forward(
            jcfg, codec, codec_params, batch, True, jax.random.PRNGKey(0))
        g = jax.grad(lambda p: jnp.mean((xs - (pp.apply(
            {"params": p}, xhat + 0.5, True) - 0.5)) ** 2))(pp_vars["params"])
        return g, step(codec_params, pp_vars, opt_state, batch,
                       jax.random.PRNGKey(0), jnp.asarray(LR))

    j_grads, (new_vars, _, j_out) = grads_and_step(
        codec_params, pp_vars, opt_state, jnp.asarray(x))

    model = PCodec(pcfg)
    weights.load_flax_params(model, weights.flatten_params(
        jax.tree_util.tree_map(np.asarray, codec_params)))
    net = port_net(pcfg, pp_vars)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    p_step = ploop.make_postprocess_train_step(pcfg, model, net, opt, "cpu")
    p_out = p_step(nchw(x), torch.Generator().manual_seed(0), LR)

    for name in ("loss", "mse", "rate1", "rate2"):
        np.testing.assert_allclose(float(getattr(p_out, name)),
                                   float(getattr(j_out, name)),
                                   rtol=RD_RTOL, err_msg=name)
    want_g = weights.state_dict_from_flax(weights.flatten_params(
        jax.tree_util.tree_map(np.asarray, j_grads)))
    got_g = {n: p.grad for n, p in net.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for n, w in want_g.items():
        w = w.numpy()
        assert np.abs(got_g[n].numpy() - w).max() <= GRAD_TOL * np.abs(
            w).max(), n
    # Adam's first step: every entry moves by at most lr, and where the
    # gradient stands clear of its error the two updates agree to 2 % of lr
    want_p = weights.state_dict_from_flax(weights.flatten_params(
        jax.tree_util.tree_map(np.asarray, new_vars["params"])))
    compared = 0
    for n, p in net.named_parameters():
        g = np.abs(want_g[n].numpy())
        mask = (g > 1e-2 * g.max()) & (g > 1e-5)
        d_got = (p.detach() - before[n]).numpy()
        d_want = want_p[n].numpy() - before[n].numpy()
        assert np.abs(d_got).max() <= 1.01 * LR, n
        assert np.abs(d_got - d_want)[mask].max(initial=0.0) <= 0.02 * LR, n
        compared += int(mask.sum())
    assert compared > 0.2 * sum(p.numel() for p in net.parameters())


def test_cli_runs_train_postprocess(tmp_path, monkeypatch):
    """``mode: train_postprocess`` through the CLI on a small CDF97 codec:
    one epoch of two steps and a validation with the net applied; the
    codec stays frozen at its seeded init, and the checkpoint holds the
    codec alone."""
    monkeypatch.chdir(tmp_path)
    images = str(tmp_path / "images")
    pdata.write_corpus(images, 2, 32, seed=5, kind="plain")
    raw = dict(netType="CDF97", entropy_layer="factorized", clrch=3,
               dwtlevels=2, exp_name="pp", batch_size=2, patch_size=32,
               val_patch_size=32, steps_per_epoch=2, max_epoch=1,
               lambda_=100.0, postprocess="iwave", resnetlevel=2,
               mode="train_postprocess", multi_agent=False,
               valid_data=images, test_data=images)
    with open("pp.json", "w") as fh:
        json.dump(raw, fh)
    assert pcli.main(["--device", "cpu", "pp.json"]) == 0
    cfg = pconfig.process_config("pp.json")
    saved = pckpt.load_checkpoint(cfg.checkpoint_dir)
    fresh = PCodec(cfg, generator=torch.Generator().manual_seed(cfg.seed))
    assert sorted(saved["model"]) == sorted(fresh.state_dict())
    for n, t in fresh.state_dict().items():
        assert torch.equal(saved["model"][n], t), n
