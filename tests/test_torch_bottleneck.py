"""The port's EntropyBottleneck and FactorizedEntropy against the JAX
package's, on the CPU: the same numpy inputs and parameters (random, near
flax's init), carried into the port by ``tools/weights.py``.

Tolerances: quantized values exact (the same rounding of the same values
around the same medians); likelihoods 1e-5 relative and self-information
2e-5 bits (fp32 through a 5-layer per-channel MLP and a sigmoid
difference, in another order of sums); gradients 1e-4 of the tensor's max
|grad|. The training noise is pinned to zero on both sides (the two
frameworks draw different numbers from one seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    bottleneck as pbn, models as pem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    bottleneck as jbn, models as jem)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

LIK_RTOL = 1e-5
INFO_ATOL = 2e-5
GRAD_TOL = 1e-4


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def bottleneck_params(shapes, seed):
    """Flat flax params of bottlenecks: flax's init moved by seeded noise
    (so that medians, factors and biases all matter)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in weights.flatten_params(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), shapes)).items():
        leaf = k.rsplit("['", 1)[1][:-2]
        n = rng.randn(*v.shape)
        if leaf.startswith("matrix"):
            v = np.log(np.expm1(10 ** -0.2 / v.shape[1])) + 0.3 * n
        elif leaf == "quantiles":
            v = np.array([-10.0, 0.0, 10.0]) + 0.3 * n
        else:                               # bias_i, factor_i
            v = 0.3 * n
        out[k] = v.astype(np.float32)
    return out


def unflatten(flat):
    return jax.tree_util.tree_map(jnp.asarray, weights.unflatten_params(flat))


def port_grads(module):
    """Gradients by name; zeros where autograd left none (as jax.grad
    gives)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in module.named_parameters()}


def check_grads(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        err = np.abs(got[name].numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err)


@pytest.fixture
def zero_noise(monkeypatch):
    monkeypatch.setattr(jbn, "quantize_noise", lambda x, rng=None: x)
    monkeypatch.setattr(pbn, "quantize_noise", lambda x, generator=None: x)


@pytest.fixture(scope="module")
def one():
    """One 4-channel bottleneck, its params and an input with values on both
    sides of the medians."""
    x = (np.random.RandomState(0).randn(2, 6, 5, 4) * 4).astype(np.float32)
    mod = jbn.EntropyBottleneck(4)
    shapes = jax.eval_shape(lambda: mod.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), False))["params"]
    flat = bottleneck_params(shapes, 1)
    port = pbn.EntropyBottleneck(4)
    weights.load_flax_params(port, flat)
    return x, mod, flat, port


def test_bottleneck_eval_matches_jax(one):
    x, mod, flat, port = one
    jq, jlik = jax.jit(lambda p, xx: mod.apply({"params": p}, xx, False))(
        unflatten(flat), jnp.asarray(x))
    with torch.no_grad():
        pq, plik = port(nchw(x))
    np.testing.assert_array_equal(nhwc(pq), np.asarray(jq))
    np.testing.assert_allclose(nhwc(plik), np.asarray(jlik), rtol=LIK_RTOL,
                               atol=0)
    # rounding is around the medians, which are not integers here
    med = flat["['quantiles']"][:, 0, 1]
    assert np.abs(med - np.round(med)).min() > 0
    np.testing.assert_array_equal(port.medians().detach().numpy(), med)


def test_bottleneck_training_and_gradients_match_jax(one, zero_noise):
    """Training mode (noise pinned): the likelihood and the gradients of
    its total information in every parameter and in the input."""
    x, mod, flat, port = one

    def j_loss(params, xx):
        _, lik = mod.apply({"params": params}, xx, True,
                           rngs={"noise": jax.random.PRNGKey(0)})
        return -jnp.log2(lik).sum(), lik

    (_, jlik), (jg, jgx) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(unflatten(flat), jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    port.zero_grad()
    q, plik = port(xt, training=True)
    assert torch.equal(q, xt)
    (-torch.log2(plik)).sum().backward()
    np.testing.assert_allclose(nhwc(plik), np.asarray(jlik), rtol=LIK_RTOL,
                               atol=0)
    check_grads(port_grads(port), weights.state_dict_from_flax(
        weights.flatten_params(jg)))
    check_grads({"x": xt.grad}, {"x": nchw(np.asarray(jgx))})


def test_aux_loss_and_its_gradient_reach_only_quantiles(one):
    _, mod, flat, port = one
    jaux, jg = jax.jit(jax.value_and_grad(lambda p: mod.apply(
        {"params": p}, method=jbn.EntropyBottleneck.aux_loss)))(
            unflatten(flat))
    port.zero_grad()
    aux = port.aux_loss()
    aux.backward()
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert float(grads["quantiles"].abs().max()) > 0
    assert all(g is None for n, g in grads.items() if n != "quantiles")
    want = weights.state_dict_from_flax(weights.flatten_params(jg))
    assert all(float(want[n].abs().max()) == 0 for n in want
               if n != "quantiles")
    check_grads({"q": grads["quantiles"]}, {"q": want["quantiles"]})


def test_init_follows_flax():
    mod = jbn.EntropyBottleneck(3)
    x = jnp.zeros((1, 2, 2, 3))
    want = weights.state_dict_from_flax(weights.flatten_params(jax.jit(
        lambda k: mod.init({"params": k}, x, False))(jax.random.PRNGKey(0))
        ["params"]))
    a, b = pbn.EntropyBottleneck(3), pbn.EntropyBottleneck(3)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    got = a.state_dict()
    assert {n: tuple(t.shape) for n, t in got.items()} \
        == {n: tuple(t.shape) for n, t in want.items()}
    for n, t in got.items():
        assert torch.equal(t, b.state_dict()[n]), n     # seeded
        if n.startswith("bias"):                        # U(-0.5, 0.5)
            assert float(t.abs().max()) <= 0.5 and float(t.std()) > 0
        else:                                           # constants
            torch.testing.assert_close(t, want[n], rtol=1e-6, atol=0)


@pytest.mark.parametrize("training", [False, True])
def test_factorized_entropy_matches_jax(training, zero_noise):
    kw = dict(netType="CDF97", entropy_layer="factorized",
              autoencoder="SubbandAutoEncoder", clrch=3, dwtlevels=2)
    jcfg, pcfg = jconfig.Config(**kw), pconfig.Config(**kw).validate()
    rng = np.random.RandomState(3)
    xe = (rng.randn(2, 4, 4, 3) * 5).astype(np.float32)
    xo = [(rng.randn(2, s, s, 9) * 2).astype(np.float32) for s in (16, 8)]
    mod = jem.FactorizedEntropy(jcfg)
    args = (jnp.asarray(xe), [jnp.asarray(t) for t in xo], training)
    shapes = jax.eval_shape(lambda: mod.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        *args))["params"]
    flat = bottleneck_params(shapes, 4)
    params = unflatten(flat)

    @jax.jit
    def jax_side(p, xe, xo):
        return (mod.apply({"params": p}, xe, xo, training,
                          rngs={"noise": jax.random.PRNGKey(2)}),
                mod.apply({"params": p}, method=jem.FactorizedEntropy.aux_loss))

    (j_ixe, j_ixo, j_qe, j_qo), jaux = jax_side(params, *args[:2])
    model = pem.FactorizedEntropy(pcfg)
    weights.load_flax_params(model, flat)
    with torch.no_grad():
        p_ixe, p_ixo, p_qe, p_qo = model(nchw(xe), [nchw(t) for t in xo],
                                         training)
        paux = model.aux_loss()
    np.testing.assert_array_equal(nhwc(p_qe), np.asarray(j_qe))
    np.testing.assert_allclose(nhwc(p_ixe), np.asarray(j_ixe), rtol=0,
                               atol=INFO_ATOL)
    for i in range(2):
        np.testing.assert_array_equal(nhwc(p_qo[i]), np.asarray(j_qo[i]))
        np.testing.assert_allclose(nhwc(p_ixo[i]), np.asarray(j_ixo[i]),
                                   rtol=0, atol=INFO_ATOL)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-5)
