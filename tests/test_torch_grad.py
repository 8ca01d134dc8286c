"""Gradients of the port against ``jax.grad`` of the JAX package, on the
CPU: the bounds and straight-through rounding, GDN/IGDN, the masked conv,
one lifting stage, one Berk scaling AE, and the backward of the 3x3 conv
Function (dx and dk) against the Pallas kernel's ``custom_vjp`` run in
interpret mode, as ``tests/test_pallas_conv.py`` runs it.

Inputs, weights and the cotangent come from numpy with a fixed seed;
weights and gradient trees are carried across with ``tools/weights.py``.
Module gradients must agree within 1e-4 of that tensor's max |grad| (fp32
sums in another order).

``torch.autograd.gradcheck`` of the conv Function needs float64, and the
Function casts its operands to fp32 or bf16, so it cannot be used here.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv3x3_halo as port_conv, gdn as pgdn, lifting as plift,
    masked_conv as pmc, math_utils as pmu, subband_ae as pae)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    gdn as jgdn, lifting as jlift, masked_conv as jmc, math_utils as jmu,
    pallas_conv, subband_ae as jae)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

GRAD_TOL = 1e-4   # of max |grad| of the tensor compared


@pytest.fixture(autouse=True)
def _interpret():
    old = pallas_conv._INTERPRET
    pallas_conv._INTERPRET = True
    yield
    pallas_conv._INTERPRET = old


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def random_params(mod, *args, seed, scale=0.05):
    """Flat flax params of ``mod`` drawn from numpy (only the shapes come
    from flax): conv kernels with std 1/sqrt(fan_in), GDN terms near their
    init and positive, the rest N(0, scale)."""
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


def close(got, want, what, tol=GRAD_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want)))
    bound = tol * float(np.max(np.abs(want)))
    assert err <= bound, f"{what}: max abs err {err:.3e} > {bound:.3e}"


def check_module_grads(jax_loss, flat, x, module, port_loss):
    """d loss / d (params, x) on both sides. ``jax_loss(params, x)`` and
    ``port_loss(module, xt)`` return the scalar."""
    g_params, g_x = jax.grad(jax_loss, (0, 1))(unflatten(flat), jnp.asarray(x))
    want = weights.state_dict_from_flax(weights.flatten_params(g_params))
    weights.load_flax_params(module, flat)
    xt = nchw(x).requires_grad_(True)
    port_loss(module, xt).backward()
    close(nhwc(xt.grad), g_x, "d/dx")
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        assert got[name] is not None, name
        close(got[name].numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("name", ["lower_bound", "upper_bound"])
def test_bounds_gradient(name):
    rng = np.random.RandomState(5)
    x = rng.randn(256).astype(np.float32)
    g = rng.randn(256).astype(np.float32)
    jf, pf = getattr(jmu, name), getattr(pmu, name)
    want = np.asarray(jf(jnp.asarray(x), 0.1))
    want_grad = np.asarray(jax.grad(
        lambda v: jnp.sum(jf(v, 0.1) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pf(xt, 0.1)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)
    # both branches of the rule were taken
    assert 0 < np.count_nonzero(want_grad) < want_grad.size


def test_ste_round_gradient():
    rng = np.random.RandomState(6)
    x = (rng.randn(64) * 3).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    want_grad = np.asarray(jax.grad(
        lambda v: jnp.sum(jmu.ste_round(v) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pmu.ste_round(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jmu.ste_round(jnp.asarray(x))))
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)
    np.testing.assert_array_equal(want_grad, g)


def test_quantizers_match():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -3.7], np.float32)
    mu = np.array([0.25, -0.5, 0.0, 1.0, 0.5, -2.0, 0.0, 0.3], np.float32)
    for m in (None, mu):
        got = pmu.quantize_symbols(torch.from_numpy(v),
                                   None if m is None else torch.from_numpy(m))
        want = jmu.quantize_symbols(jnp.asarray(v),
                                    None if m is None else jnp.asarray(m))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.from_numpy(v)
    np.testing.assert_array_equal(pmu.lifting_round(x, 0).numpy(), v)
    np.testing.assert_allclose(
        pmu.lifting_round(x, 10).numpy(),
        np.asarray(jmu.lifting_round(jnp.asarray(v), 10)), rtol=1e-6)
    # noise: U(-0.5, 0.5) from the generator, the same for a fixed seed,
    # one grid step wide in lifting_round
    gen = torch.Generator().manual_seed(3)
    big = torch.zeros(4096)
    n1 = pmu.quantize_noise(big, gen)
    n2 = pmu.quantize_noise(big, torch.Generator().manual_seed(3))
    assert torch.equal(n1, n2)
    assert -0.5 <= float(n1.min()) < -0.45 and 0.45 < float(n1.max()) <= 0.5
    assert abs(float(n1.mean())) < 0.03
    step = 1.0 / (255.0 * 4.0)
    n3 = pmu.lifting_round(big, 10, torch.Generator().manual_seed(3))
    np.testing.assert_allclose(n3.numpy(), n1.numpy() * step, rtol=1e-6)
    with pytest.raises(ValueError):
        pmu.quantize_noise(big, None)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_gradients(inverse):
    c = 12
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 7, c).astype(np.float32)
    dy = rng.randn(2, 6, 7, c).astype(np.float32)
    mod = jgdn.GDN(c, inverse=inverse)
    flat = random_params(mod, jnp.asarray(x), seed=2)
    check_module_grads(
        lambda p, v: jnp.sum(mod.apply({"params": p}, v) * dy), flat, x,
        pgdn.GDN(c, inverse=inverse),
        lambda m, v: (m(v) * nchw(dy)).sum())


def test_masked_conv_gradients_and_masked_taps():
    rng = np.random.RandomState(3)
    cin, cout, k, groups = 3, 27, 5, 3
    x = rng.randn(2, 9, 10, cin).astype(np.float32)
    dy = rng.randn(2, 9, 10, cout).astype(np.float32)
    mod = jmc.MaskedConv2d(cout, (k, k), mask_type="A",
                           feature_group_count=groups)
    flat = random_params(mod, jnp.asarray(x), seed=4)
    layer = pmc.MaskedConv2d(cin, cout, k, mask_type="A", groups=groups)
    check_module_grads(
        lambda p, v: jnp.sum(mod.apply({"params": p}, v) * dy), flat, x,
        layer, lambda m, v: (m(v) * nchw(dy)).sum())
    hidden = pmc.causal_mask((k, k), "A") == 0
    assert hidden.sum() == 13
    g = layer.weight.grad.numpy()
    assert np.all(g[:, :, hidden] == 0) and np.any(g[:, :, ~hidden] != 0)


def test_lift_stage_gradients():
    rng = np.random.RandomState(0)
    L = rng.randn(2, 8, 12, 1).astype(np.float32)
    H = rng.randn(2, 8, 12, 1).astype(np.float32)
    dl = rng.randn(2, 8, 12, 1).astype(np.float32)
    dh = rng.randn(2, 8, 12, 1).astype(np.float32)
    kw = dict(channels=1, hidden=16, filtersize=5, num_pairs=2,
              nonlinear=True, res_weight=0.1, use_scale=True)
    mod = jlift.LiftStage(**kw)
    flat = random_params(mod, jnp.asarray(L), jnp.asarray(H), seed=1)

    def jax_loss(p, lh):
        lo, hi = mod.apply({"params": p}, lh[..., :1], lh[..., 1:],
                           method="forward")
        bl, bh = mod.apply({"params": p}, lo * 0.5, hi + 0.25,
                           method="inverse")
        return jnp.sum(lo * dl) + jnp.sum(hi * dh) + jnp.sum(bl * bh)

    def port_loss(m, lh):
        lo, hi = m(lh[:, :1], lh[:, 1:])
        bl, bh = m.inverse(lo * 0.5, hi + 0.25)
        return (lo * nchw(dl)).sum() + (hi * nchw(dh)).sum() + (bl * bh).sum()

    check_module_grads(jax_loss, flat, np.concatenate([L, H], -1),
                       plift.LiftStage(**kw), port_loss)


def test_berk_ae_gradients():
    """The AE's dense 3x3 convs run through the conv Function on the port's
    side (its plain backward) and through ``nn.Conv`` on the JAX side."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12, 10, 3).astype(np.float32)
    dy = rng.randn(2, 12, 10, 3).astype(np.float32)
    mod = jae.SubbandAutoEncoderBerk(in_ch=3)
    flat = random_params(mod, jnp.asarray(x), seed=7)

    def jax_loss(p, v):
        y = mod.apply({"params": p}, v, method="encode")
        return jnp.sum(mod.apply({"params": p}, y, method="decode") * dy)

    check_module_grads(jax_loss, flat, x, pae.SubbandAutoEncoderBerk(in_ch=3),
                       lambda m, v: (m.decode(m.encode(v)) * nchw(dy)).sum())


# --- the conv Function's backward against the Pallas kernel's custom_vjp --

def _conv_case(b, h, w, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    dy = rng.randn(b, h, w, cout).astype(np.float32)
    return x, k, dy


def _both_grads(x, k, dy, dtype):
    jdt = getattr(jnp, dtype)
    gx, gk = jax.grad(
        lambda a, b: jnp.sum(pallas_conv.conv3x3_halo(a, b, jdt) * dy),
        (0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = nchw(x).requires_grad_(True)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).clone().requires_grad_(True)
    port_conv.launches = 0
    y = port_conv.conv3x3_halo(xt, wt, getattr(torch, dtype))
    (y * nchw(dy)).sum().backward()
    assert port_conv.launches == 0   # a CPU call never launches the kernel
    assert xt.grad.dtype == torch.float32 and wt.grad.dtype == torch.float32
    return (nhwc(xt.grad), wt.grad.permute(2, 3, 1, 0).numpy(),
            np.asarray(gx), np.asarray(gk))


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 8, 16, 32, 36),    # the JAX package's own gradient case
    (1, 13, 11, 5, 12),    # ragged H and W, Cin != Cout
    (2, 6, 7, 12, 3),      # narrow out: dx is a 3 -> 12 conv
])
def test_conv_backward_fp32(b, h, w, cin, cout):
    """Tolerances of ``tests/test_pallas_conv.py::test_gradients_match_xla``."""
    px, pk, gx, gk = _both_grads(*_conv_case(b, h, w, cin, cout, 1), "float32")
    np.testing.assert_allclose(px, gx, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(pk, gk, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 8, 16, 32, 36),
    (1, 13, 11, 5, 12),
])
def test_conv_backward_bf16(b, h, w, cin, cout):
    """bf16 operands: both sides round x, the weight and dy to bf16 and sum
    the exact products in fp32, so they differ only by the order of fp32
    sums: the fp32 tolerances hold. Autograd through the plain forward,
    which never rounds dy, misses them by a wide margin."""
    x, k, dy = _conv_case(b, h, w, cin, cout, 2)
    px, pk, gx, gk = _both_grads(x, k, dy, "bfloat16")
    np.testing.assert_allclose(px, gx, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(pk, gk, rtol=2e-5, atol=2e-3)
    xt = nchw(x).requires_grad_(True)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).clone().requires_grad_(True)
    (port_conv.conv3x3_halo_plain(xt, wt, torch.bfloat16) * nchw(dy)
     ).sum().backward()
    assert np.abs(nhwc(xt.grad) - gx).max() > 10 * 2e-4


def test_conv_backward_plain_is_the_functions_backward():
    x, k, dy = _conv_case(2, 7, 9, 6, 10, 3)
    xt = nchw(x).requires_grad_(True)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).clone().requires_grad_(True)
    for dtype in (torch.float32, torch.bfloat16):
        xt.grad = wt.grad = None
        port_conv.conv3x3_halo(xt, wt, dtype).backward(nchw(dy))
        dx, dk = port_conv.conv3x3_halo_bwd_plain(xt.detach(), wt.detach(),
                                                  nchw(dy), dtype)
        assert torch.equal(xt.grad, dx) and torch.equal(wt.grad, dk)
    # only the asked gradients are computed
    y = port_conv.conv3x3_halo(xt.detach(), wt, torch.float32)
    (gw,) = torch.autograd.grad(y.sum(), wt)
    assert gw.shape == wt.shape


# ---- tools/grad_conditioning.py: the float64 reference step ----------------

def test_float64_reference_step_agrees_with_the_fp32_step(capsys):
    """The tool's float64 evaluation of one flagship train step (random
    weights, one 32x32 patch) and the port's fp32 step on the same weights,
    batch and noise: the loss within 1e-6 relative and every gradient tensor
    within 1e-4 of its max |grad|; the patches it needs are undone."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        fast_conv)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
        grad_conditioning as gc)
    before = (torch.Tensor.float, fast_conv.conv3x3_halo, pmu.uniform_noise)
    assert gc.main(["--device", "cpu", "--size", "32", "--batch", "1",
                    "--weights", "random"]) == 0
    assert before == (torch.Tensor.float, fast_conv.conv3x3_halo,
                      pmu.uniform_noise)
    (line,) = capsys.readouterr().out.strip().splitlines()
    res = json.loads(line)
    assert res["tensors"] > 700 and "card32_vs_f64" not in res
    assert abs(res["loss_cpu32"] - res["loss_f64"]) <= 1e-6 * res["loss_f64"]
    assert res["cpu32_vs_f64"]["worst_err"] <= GRAD_TOL


def test_grad_conditioning_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
        grad_conditioning as gc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gc.main(["--size", "32", "--batch", "1", "--weights", "random"])
