"""The port's CDF 9/7 + factorized codec against the JAX package's, on the
CPU: the 9/7 ladder (against the Pallas kernels of
``scripts/bench_pallas.py`` in interpret mode and the jnp ladder of
``ops/dwt97.py``), its autograd Functions (against ``jax.vjp``), the
transposed step lists the CUDA kernels run for the backward, the pointwise
``SubbandAutoEncoder``, the whole eval step and one Adam train step of
``configs/cdf97_factorized.json`` cut to 2 levels and 64x64 (weights
carried both ways by ``tools/weights.py``), and the CLI.

Tolerances: ladder values 1e-5 of max |reference| (fp32, the same
expressions; the port's inverse multiplies by 1/NL where the JAX one
divides by NL); the transposed ladders are adjoints to 1e-12 in float64;
AE outputs 1e-5 of max; RD terms 1e-4 relative; info maps 2e-4 bits and
xhat 1e-5 (fp32 through the whole codec); gradients 1e-3 of each tensor's
max |grad| with the training noise pinned to zero on both sides.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    cli as pcli, config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    bottleneck as pbn)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    dwt97 as pdwt, lift97, subband_ae as pae)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    checkpoint as pckpt, data as pdata, state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    bottleneck as jbn)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    dwt97 as jdwt, subband_ae as jae)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    loss as jloss, state as jstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.utils import (
    compile_cache)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "cdf97_factorized.json")
LADDER_TOL = 1e-5
RD_RTOL = 1e-4
INFO_ATOL = 2e-4
XHAT_ATOL = 1e-5
GRAD_TOL = 1e-3
LR = 1e-4
LEVELS, SIZE = 2, 64


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def cfgs(**kw):
    with open(CONFIG) as fh:
        raw = dict(json.load(fh), dwtlevels=LEVELS, **kw)
    return jconfig.config_from_dict(raw), pconfig.config_from_dict(raw)


@pytest.fixture(scope="module")
def bench_pallas(monkeypatch_module):
    """``scripts/bench_pallas.py`` loaded by path, with its import-time
    switch to a persistent compile cache left out."""
    monkeypatch_module.setattr(compile_cache, "enable_compile_cache",
                               lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "bench_pallas", os.path.join(ROOT, "scripts", "bench_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture
def zero_noise(monkeypatch):
    """Pin the training quantization noise to zero in both packages."""
    monkeypatch.setattr(jbn, "quantize_noise", lambda x, rng=None: x)
    monkeypatch.setattr(pbn, "quantize_noise", lambda x, generator=None: x)


# --- the ladder -------------------------------------------------------------

@pytest.mark.parametrize("rows,cols", [(64, 256), (12, 40)])
def test_ladder_matches_the_pallas_kernels(bench_pallas, rows, cols):
    """Along H of a (1, 1, rows, cols) tensor the port's ladder is the
    Pallas kernels' (H, C) row ladder."""
    x = np.random.RandomState(rows).randn(rows, cols).astype(np.float32)
    want_lo, want_hi = bench_pallas.lift97_rows_fused(jnp.asarray(x),
                                                      interpret=True)
    lo, hi = pdwt.lift97_1d(torch.from_numpy(x)[None, None], 2)
    assert rel_err(lo[0, 0], want_lo) <= LADDER_TOL
    assert rel_err(hi[0, 0], want_hi) <= LADDER_TOL
    want_x = bench_pallas.ilift97_rows_fused(want_lo, want_hi, interpret=True)
    back = pdwt.ilift97_1d(torch.tensor(np.asarray(want_lo))[None, None],
                           torch.tensor(np.asarray(want_hi))[None, None], 2)
    assert rel_err(back[0, 0], want_x) <= LADDER_TOL
    assert rel_err(pdwt.ilift97_1d(lo, hi, 2)[0, 0], x) <= LADDER_TOL


def test_ladder_and_levels_match_jax_along_both_dims():
    x = np.random.RandomState(1).randn(2, 16, 24, 3).astype(np.float32)
    xt = nchw(x)

    @jax.jit
    def jax_side(a):
        rows, cols = jdwt.lift97_1d(a, 1), jdwt.lift97_1d(a, 2)
        return (rows, jdwt.ilift97_1d(*rows, 1), cols,
                jdwt.ilift97_1d(*cols, 2), jdwt.dwt97_forward(a, LEVELS))

    rows, rows_back, cols, cols_back, (want_ll, want_highs) = jax_side(
        jnp.asarray(x))
    for dim, want, want_back in ((2, rows, rows_back), (3, cols, cols_back)):
        got = pdwt.lift97_1d(xt, dim)
        for g, w in zip(got, want):
            assert rel_err(nhwc(g), w) <= LADDER_TOL
        assert rel_err(nhwc(pdwt.ilift97_1d(*got, dim)), want_back) \
            <= LADDER_TOL
    ll, highs = pdwt.dwt97_forward(xt, LEVELS)
    assert rel_err(nhwc(ll), want_ll) <= LADDER_TOL
    for g, w in zip(highs, want_highs):
        assert rel_err(nhwc(g), w) <= LADDER_TOL
    assert rel_err(nhwc(pdwt.dwt97_inverse(ll, highs)), x) <= LADDER_TOL


def test_odd_lengths_raise():
    with pytest.raises(ValueError, match="even"):
        pdwt.lift97_1d(torch.zeros(1, 1, 6, 5), 3)
    with pytest.raises(ValueError, match="even"):
        pdwt.dwt97_forward(torch.zeros(1, 3, 12, 12), 3)   # 12 -> 6 -> 3
    with pytest.raises(ValueError, match="differ"):
        pdwt.ilift97_1d(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 4, 3), 3)


def test_ladder_gradients_match_jax_vjp():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 24, 3).astype(np.float32)

    def forward(a):
        return jdwt.dwt97_forward(a, LEVELS)

    @jax.jit
    def jax_side(a, g_fwd, g_inv):
        outs, vjp = jax.vjp(forward, a)
        _, vjp_inv = jax.vjp(jdwt.dwt97_inverse, *outs)
        return outs, vjp(g_fwd)[0], vjp_inv(g_inv)

    ll_s, highs_s = jax.eval_shape(forward, jnp.asarray(x))
    g_ll = rng.randn(*ll_s.shape).astype(np.float32)
    g_highs = [rng.randn(*h.shape).astype(np.float32) for h in highs_s]
    gy = rng.randn(*x.shape).astype(np.float32)
    (ll_w, highs_w), want_gx, (want_gll, want_gh) = jax_side(
        jnp.asarray(x), (jnp.asarray(g_ll), [jnp.asarray(g) for g in g_highs]),
        jnp.asarray(gy))

    xt = nchw(x).requires_grad_(True)
    ll, highs = pdwt.dwt97_forward(xt, LEVELS)
    torch.autograd.backward([ll, *highs],
                            [nchw(g_ll)] + [nchw(g) for g in g_highs])
    assert rel_err(nhwc(xt.grad), want_gx) <= LADDER_TOL
    llt = nchw(np.asarray(ll_w)).requires_grad_(True)
    hts = [nchw(np.asarray(h)).requires_grad_(True) for h in highs_w]
    pdwt.dwt97_inverse(llt, hts).backward(nchw(gy))
    assert rel_err(nhwc(llt.grad), want_gll) <= LADDER_TOL
    for g, w in zip(hts, want_gh):
        assert rel_err(nhwc(g.grad), w) <= LADDER_TOL


@pytest.mark.parametrize("dim", [2, 3])
def test_transposed_ladders_are_adjoints(dim):
    """<F x, y> = <x, F^T y> and <I z, w> = <z, I^T w> in float64, for the
    step lists the kernels run in the backward; and I inverts F."""
    rng = np.random.RandomState(dim)
    x = torch.from_numpy(rng.randn(2, 3, 8, 10))
    y = [torch.from_numpy(rng.randn(*s.shape))
         for s in lift97.analysis_plain(x, dim)]
    fx = lift97.analysis_plain(x, dim, lift97.FORWARD)
    fty = lift97.synthesis_plain(*y, dim, lift97.FORWARD_T)
    lhs = sum(float((a * b).sum()) for a, b in zip(fx, y))
    assert abs(lhs - float((x * fty).sum())) <= 1e-12 * abs(lhs)
    iz = lift97.synthesis_plain(*y, dim, lift97.INVERSE)
    itx = lift97.analysis_plain(x, dim, lift97.INVERSE_T)
    lhs = float((iz * x).sum())
    rhs = sum(float((a * b).sum()) for a, b in zip(y, itx))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    assert float((lift97.synthesis_plain(*fx, dim) - x).abs().max()) < 1e-12


# --- the scaling autoencoder -------------------------------------------------

def test_subband_autoencoder_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 12, 9).astype(np.float32)
    mod = jae.SubbandAutoEncoder(in_ch=9)
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x)))["params"]
    flat = {k: (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
                if k.endswith("['kernel']") else 0.1 * rng.randn(*v.shape)
                ).astype(np.float32)
            for k, v in weights.flatten_params(jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape), shapes)).items()}
    params = {"params": weights.unflatten_params(flat)}
    y = mod.apply(params, jnp.asarray(x), method=jae.SubbandAutoEncoder.encode)
    z = mod.apply(params, y, method=jae.SubbandAutoEncoder.decode)
    port = pae.make_subband_ae("SubbandAutoEncoder", 9)
    weights.load_flax_params(port, flat)
    assert sum(p.numel() for p in port.parameters()) == 2 * (
        9 * 32 + 32 * 288 * 2 + 32 * 9 + 3 * 288 + 9)
    with torch.no_grad():
        py = port.encode(nchw(x))
        pz = port.decode(nchw(np.asarray(y)))
    assert rel_err(nhwc(py), y) <= 1e-5
    assert rel_err(nhwc(pz), z) <= 1e-5


# --- the whole codec -----------------------------------------------------------

def codec_params(init, seed):
    """Flat flax params of the CDF97 codec drawn from numpy: conv kernels
    with std 1/sqrt(fan_in), bottlenecks near flax's init."""
    shapes = jax.eval_shape(init)["params"]
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in weights.flatten_params(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), shapes)).items():
        leaf = k.rsplit("['", 1)[1][:-2]
        n = rng.randn(*v.shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(v.shape[:-1]))
        elif leaf.startswith("matrix"):
            v = np.log(np.expm1(10 ** -0.2 / v.shape[1])) + 0.3 * n
        elif leaf == "quantiles":
            v = np.array([-10.0, 0.0, 10.0]) + 0.3 * n
        elif leaf == "bias":
            v = 0.05 * n
        else:                                   # bias_i, factor_i
            v = 0.3 * n
        out[k] = v.astype(np.float32)
    return out


def image(seed):
    img = pdata.synthetic_natural_images(1, SIZE, seed=seed)[0]
    return img[None].astype(np.float32) / 255.0


def unflatten(flat):
    return jax.tree_util.tree_map(jnp.asarray, weights.unflatten_params(flat))


def test_eval_step_matches_jax():
    """Weights flax -> port: random numpy params in the flax tree."""
    jcfg, pcfg = cfgs()
    x = image(1)
    jmodel = JCodec(jcfg)
    flat = codec_params(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(x), False), 7)
    params = unflatten(flat)
    want = jstate.make_eval_step(jcfg, jmodel)(params, jnp.asarray(x))
    _, j_xhat, j_ixe, j_ixo, _ = jax.jit(
        lambda p, xx: jstate.apply_color_forward(jcfg, jmodel, p, xx, False,
                                                 None))(params, jnp.asarray(x))
    model = PCodec(pcfg)
    weights.load_flax_params(model, flat)
    got, xhat = pstate.make_eval_step(pcfg, model, device="cpu")(nchw(x))
    for name in ("loss", "mse", "rate1", "rate2"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=RD_RTOL,
                                   err_msg=name)
    with torch.no_grad():
        _, p_xhat, p_ixe, p_ixo, _ = pstate.apply_color_forward(
            pcfg, model, nchw(x))
    np.testing.assert_allclose(nhwc(p_xhat), np.asarray(j_xhat), rtol=0,
                               atol=XHAT_ATOL)
    np.testing.assert_allclose(nhwc(p_ixe), np.asarray(j_ixe), rtol=0,
                               atol=INFO_ATOL)
    for g, w in zip(p_ixo, j_ixo):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0,
                                   atol=INFO_ATOL)
    assert tuple(xhat.shape) == (1, 3, SIZE, SIZE)
    assert float(xhat.abs().max()) <= 0.5


def test_adam_train_step_matches_jax(zero_noise):
    """Weights port -> flax: the port's own seeded init, exported to the
    flax tree. One Adam step on both sides: RD terms, every gradient and
    the update."""
    jcfg, pcfg = cfgs(learning_rate=LR)
    x = image(2)
    model = PCodec(pcfg, generator=torch.Generator().manual_seed(3))
    flat = weights.flax_params_from_state_dict(model.state_dict())
    params = unflatten(flat)
    assert sum(int(np.prod(v.shape)) for v in flat.values()) == 94059

    jmodel = JCodec(jcfg)
    tx = jstate.make_optimizer(jcfg)
    rng = jax.random.PRNGKey(0)

    def loss_fn(p):
        xs, xhat, ixe, ixo, aux = jstate.apply_color_forward(
            jcfg, jmodel, p, jnp.asarray(x), True, rng)
        out = jloss.rd_loss3(xs, xhat, ixe, ixo, jcfg.lambda_, 1.0)
        return out.loss + aux

    @jax.jit
    def jax_side(state):
        """The gradients, and the JAX package's train step (the body that
        ``make_train_step`` jits), compiled as one program."""
        return jax.grad(loss_fn)(state.params), jstate._one_train_step(
            jcfg, jmodel, tx, state, jnp.asarray(x), rng, jnp.float32(LR),
            jnp.float32(1.0), jnp.float32(jcfg.lambda_))

    grads, (j_state, j_out, j_aux) = jax_side(jstate.TrainState(
        params, tx.init(params), jnp.zeros((), jnp.int32)))
    j_grads = weights.state_dict_from_flax(weights.flatten_params(grads))
    j_after = weights.state_dict_from_flax(weights.flatten_params(
        j_state.params))

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = pstate.make_train_step(pcfg, model,
                                  pstate.make_optimizer(pcfg, model), "cpu")
    out, aux = step(nchw(x), torch.Generator().manual_seed(0), LR, 1.0)
    for name in ("loss", "mse", "rate1", "rate2"):
        np.testing.assert_allclose(float(getattr(out, name)),
                                   float(getattr(j_out, name)), rtol=RD_RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=RD_RTOL)
    compared = 0
    for name, p in model.named_parameters():
        g, want = p.grad.numpy(), j_grads[name].numpy()
        assert np.abs(g - want).max() <= GRAD_TOL * np.abs(want).max(), name
        # Adam's first step moves an entry by about lr * sign(g): compare
        # where |g| is clear of its error and of Adam's eps
        mask = np.abs(want) > max(1e-2 * np.abs(want).max(), 1e-5)
        d_got = (p.detach() - before[name]).numpy()
        d_want = (j_after[name] - before[name]).numpy()
        assert np.abs(d_got).max() <= 1.01 * LR, name
        assert np.abs(d_got - d_want)[mask].max(initial=0.0) <= 0.02 * LR, name
        compared += int(mask.sum())
    assert compared > 0.2 * sum(v.numel() for v in before.values())
    # the aux loss trains the quantiles, and only through its own term
    assert all(float(model.get_parameter(n).grad.abs().max()) > 0
               for n in before if n.endswith("quantiles"))


def test_cli_rehearsal_trains_validates_and_resumes(tmp_path, monkeypatch):
    """The CLI on the CDF97 config cut to 2 levels, 32x32 patches, 2 steps
    an epoch and 2 epochs, then --resume-training (which takes the saved
    last epoch again, as the JAX agent does)."""
    monkeypatch.chdir(tmp_path)
    with open(CONFIG) as fh:
        raw = json.load(fh)
    valid = str(tmp_path / "valid")
    pdata.write_corpus(valid, 2, 32, seed=5, kind="plain")
    raw.update(dwtlevels=LEVELS, batch_size=1, patch_size=32,
               val_patch_size=32, steps_per_epoch=2, max_epoch=2,
               valid_data=valid)
    with open("c.json", "w") as fh:
        json.dump(raw, fh)
    assert pcli.main(["--device", "cpu", "c.json"]) == 0
    ckpt_dir = os.path.join("experiments", raw["exp_name"], "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["checkpoint.pt", "model_best.pt"]
    one = pckpt.load_checkpoint(ckpt_dir)
    assert (one["epoch"], one["iteration"]) == (1, 4)
    assert "codec.entropymodel.eb_xe.quantiles" in one["model"]
    assert pcli.main(["--resume-training", "--device", "cpu", "c.json"]) == 0
    two = pckpt.load_checkpoint(ckpt_dir)
    assert (two["epoch"], two["iteration"]) == (1, 6)
    with open(os.path.join("experiments", raw["exp_name"], "summaries",
                           "metrics.jsonl")) as fh:
        rows = [json.loads(ln) for ln in fh]
    assert [r["typ"] for r in rows] == ["tr", "va"] * 3
    assert all(np.isfinite(r["rd"]) for r in rows)
