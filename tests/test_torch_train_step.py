"""One and two whole train steps of the port against the JAX package's, on
the CPU, at the flagship's widths (``clrch=1``, Berk AEs, ZTsep with
243-wide plc stacks; ``dwtlevels=2``, one 32x32 image, fp32).

The quantization noise is pinned to zero on both sides (the two frameworks
draw different numbers from one seed), the weights come from numpy and are
carried across by ``tools/weights.py``.

Tolerances: loss, mse and rates 1e-5 relative; every gradient tensor 1e-3
of its max |grad| (fp32 sums in another order through the whole graph).
Parameters after Adam: the first step moves each entry by about
``lr * g / (|g| + eps)``, which is +-lr whatever the gradient's size, so an
entry whose gradient is near Adam's eps (1e-8), or small enough beside the
gradient's error to change sign, may move the other way. Updates are
therefore compared only at entries where |g_jax| of that step is above
both 1e-2 of the tensor's max |grad| and 1e-5; there they must agree within
2 % of lr. Everywhere, no entry may move by more than 1.01 lr a step.
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
    gaussian as pg, models as pem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    math_utils as pmu)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    data as pdata, state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    gaussian as jg, models as jem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    math_utils as jmu)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    loss as jloss, state as jstate)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

LR = 1e-4
LAM = 200.0
RD_RTOL = 1e-5
GRAD_TOL = 1e-3
FLAGSHIP = dict(netType="LiftingBasedNeuralWaveletv4",
                entropy_layer="conditioned2ZTsepSubbands",
                autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=2,
                num_lifting_perlayer=2, filtersize=5, depth_scale=2,
                block_property="same", scale=0, linearity_flag=1,
                res_connection_weight=0.1, lambda_=LAM, learning_rate=LR)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def random_params(init, seed):
    """Flat flax params drawn from numpy; only the shapes come from
    ``init``."""
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
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  weights.unflatten_params(flat))


def to_port(tree):
    """A flax tree (params or gradients) in the port's state_dict layout."""
    return weights.state_dict_from_flax(weights.flatten_params(tree))


@pytest.fixture
def zero_noise(monkeypatch):
    """Pin the training quantization noise to zero in both packages."""
    for mod in (jmu, jg, jem):
        monkeypatch.setattr(mod, "quantize_noise", lambda x, rng=None: x)
    for mod in (pmu, pg, pem):
        monkeypatch.setattr(mod, "quantize_noise",
                            lambda x, generator=None: x)


@pytest.fixture(scope="module")
def setup():
    x = pdata.synthetic_natural_images(1, 32, seed=1)[0][None].astype(
        np.float32) / 255.0
    jcfg = jconfig.Config(**FLAGSHIP)
    flat = random_params(lambda: JCodec(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x), False), 2)
    return x, flat


_JAX_FNS = {}   # grad_acc_iters -> (tx, train_step, grads), compiled once


def _jax_fns(grad_acc_iters):
    """The JAX package's jitted train step and, for the gradients, its own
    loss function differentiated (``train/state.py::_one_train_step``'s).
    Traced with the noise pinned to zero (every caller pins it)."""
    if grad_acc_iters not in _JAX_FNS:
        cfg = jconfig.Config(**dict(FLAGSHIP, grad_acc_iters=grad_acc_iters))
        model = JCodec(cfg)
        tx = jstate.make_optimizer(cfg)
        scale = 1.0 / grad_acc_iters

        @jax.jit
        def grads(params, batch, rate_w, lam):
            def loss_fn(p):
                xs, xhat, ixe, ixo, aux = jstate.apply_color_forward(
                    cfg, model, p, batch, True, jax.random.PRNGKey(0))
                out = jloss.rd_loss3(xs, xhat, ixe, ixo, lam, rate_w)
                return (out.loss + aux) * scale
            return jax.grad(loss_fn)(params)

        _JAX_FNS[grad_acc_iters] = (
            tx, jstate.make_train_step(cfg, model, tx), grads)
    return _JAX_FNS[grad_acc_iters]


class JaxSide:
    def __init__(self, flat, grad_acc_iters=1):
        self.tx, self.train_step, self.grads = _jax_fns(grad_acc_iters)
        params = unflatten(flat)
        self.state = jstate.TrainState(params, self.tx.init(params),
                                       jnp.zeros((), jnp.int32))

    def step(self, x, rate_w, lam=LAM):
        g = self.grads(self.state.params, jnp.asarray(x),
                       jnp.float32(rate_w), jnp.float32(lam))
        self.state, out, _ = self.train_step(
            self.state, jnp.asarray(x), jax.random.PRNGKey(0),
            jnp.float32(LR), jnp.float32(rate_w), lam)
        return out, to_port(g), to_port(self.state.params)


class PortSide:
    def __init__(self, flat, **kw):
        self.cfg = pconfig.Config(**dict(FLAGSHIP, **kw)).validate()
        self.model = PCodec(self.cfg)
        weights.load_flax_params(self.model, flat)
        self.opt = pstate.make_optimizer(self.cfg, self.model)
        self.train_step = pstate.make_train_step(self.cfg, self.model,
                                                 self.opt, device="cpu")

    def params(self):
        return {n: p.detach().clone()
                for n, p in self.model.named_parameters()}

    def step(self, x, rate_w, lam=None, seed=0):
        out, _ = self.train_step(nchw(x), torch.Generator().manual_seed(seed),
                                 LR, rate_w, lam)
        grads = {n: p.grad.clone() for n, p in self.model.named_parameters()}
        return out, grads, self.params()


def check_rd(got, want):
    for name in ("loss", "mse", "rate1", "rate2"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=RD_RTOL,
                                   err_msg=name)


def check_grads(got, want):
    assert set(got) == set(want)
    for name in sorted(want):
        w = want[name].numpy()
        err = np.abs(got[name].numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), \
            f"{name}: {err:.3e} > {GRAD_TOL} * {np.abs(w).max():.3e}"


def check_update(before, got, want_before, want, jax_grads):
    """Adam's update, compared by the rule in the module docstring; returns
    the number of entries compared."""
    compared = 0
    for name in sorted(want):
        g = np.abs(jax_grads[name].numpy())
        mask = (g > 1e-2 * g.max()) & (g > 1e-5)
        d_got = (got[name] - before[name]).numpy()
        d_want = (want[name] - want_before[name]).numpy()
        assert np.abs(d_got).max() <= 1.01 * LR, name
        assert np.abs(d_got - d_want)[mask].max(initial=0.0) <= 0.02 * LR, name
        compared += int(mask.sum())
    return compared


def test_two_train_steps_match(setup, zero_noise):
    x, flat = setup
    jx, pt = JaxSide(flat), PortSide(flat)
    p0 = pt.params()
    j0 = to_port(jx.state.params)
    total = sum(v.numel() for v in p0.values())
    for _ in range(2):
        j_out, j_grads, j1 = jx.step(x, 1.0)
        p_out, p_grads, p1 = pt.step(x, 1.0)
        check_rd(p_out, j_out)
        check_grads(p_grads, j_grads)
        compared = check_update(p0, p1, j0, j1, j_grads)
        assert compared > 0.2 * total   # the rule leaves a real comparison
        p0, j0 = p1, j1
    assert int(jx.state.step) == 2


def test_rate_weight_zero_and_runtime_lambda(setup, zero_noise):
    """The D-only loss (rate_weight 0) still reports the rates, and lambda
    is a runtime value of the step."""
    x, flat = setup
    jx, pt = JaxSide(flat), PortSide(flat)
    j_out, j_grads, _ = jx.step(x, 0.0, lam=50.0)
    p_out, p_grads, _ = pt.step(x, 0.0, lam=50.0)
    check_rd(p_out, j_out)
    check_grads(p_grads, j_grads)
    assert float(p_out.rate1 + p_out.rate2) > 0
    np.testing.assert_allclose(float(p_out.loss), 50.0 * float(p_out.mse),
                               rtol=1e-6)
    # no rate term: the entropy model gets no gradient
    assert all(float(g.abs().max()) == 0 for n, g in p_grads.items()
               if ".entropymodel." in n)


def test_grad_acc_iters_scales_the_loss_not_the_report(setup, zero_noise):
    x, flat = setup
    jx, pt = JaxSide(flat, grad_acc_iters=2), PortSide(flat, grad_acc_iters=2)
    j_out, j_grads, j1 = jx.step(x, 1.0)
    p0 = pt.params()
    p_out, p_grads, p1 = pt.step(x, 1.0)
    check_rd(p_out, j_out)
    check_grads(p_grads, j_grads)
    check_update(p0, p1, to_port(unflatten(flat)), j1, j_grads)
    one = PortSide(flat)
    o_out, o_grads, _ = one.step(x, 1.0)
    assert float(o_out.loss) == float(p_out.loss)   # reported unscaled
    for name, g in o_grads.items():                 # gradients halved
        torch.testing.assert_close(p_grads[name], 0.5 * g, rtol=1e-6, atol=0)


def test_noisy_step_is_repeatable_from_the_generator_seed(setup):
    x, flat = setup
    a, b, c = PortSide(flat), PortSide(flat), PortSide(flat)
    a_out, _, a1 = a.step(x, 1.0, seed=11)
    b_out, _, b1 = b.step(x, 1.0, seed=11)
    c_out, _, _ = c.step(x, 1.0, seed=12)
    assert float(a_out.loss) == float(b_out.loss)
    assert all(torch.equal(a1[n], b1[n]) for n in a1)
    assert float(a_out.loss) != float(c_out.loss)
    assert np.isfinite(float(a_out.loss))
    # the optimizer holds the learning rate it was handed
    a.train_step(nchw(x), torch.Generator().manual_seed(0), 3e-5, 1.0)
    assert all(g["lr"] == 3e-5 for g in a.opt.param_groups)


def test_optimizer_defaults_are_optax_adams():
    cfg = pconfig.Config(**FLAGSHIP).validate()
    opt = pstate.make_optimizer(cfg, torch.nn.Linear(2, 2))
    d = opt.defaults
    assert (d["lr"], d["betas"], d["eps"], d["weight_decay"], d["amsgrad"]) \
        == (LR, (0.9, 0.999), 1e-8, 0, False)
    # one optax.adam step on a known gradient equals torch's
    g = np.array([1e-3, -2.0, 0.5, 0.0], np.float32)
    tx = optax.adam(LR)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.zeros(4)), jnp.zeros(4))
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.from_numpy(g)
    torch.optim.Adam([p], lr=LR).step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(upd), rtol=1e-5)
