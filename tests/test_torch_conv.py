"""The port's 3x3 conv (``ops/conv3x3_halo.py``) against the JAX package's
Pallas kernel ``ops/pallas_conv.py::conv3x3_halo``.

On the CPU the port's wrapper computes its plain version; the Pallas kernel
runs in interpret mode, switched the way ``tests/test_pallas_conv.py``
does. The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda.py`` and, at the main path's shapes, by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    conv3x3_halo as port_conv)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops.fast_conv import (
    FastConv3x3)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    pallas_conv)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

# fp32 sums of at most 9*32 products in another order than XLA's
TOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret():
    old = pallas_conv._INTERPRET
    pallas_conv._INTERPRET = True
    yield
    pallas_conv._INTERPRET = old


def _inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    return x, k


def _to_port(x, k):
    """NHWC input and HWIO kernel -> NCHW input and OIHW weight."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(k).permute(3, 2, 0, 1))


@pytest.mark.parametrize("hw", [(16, 16), (13, 16)])
@pytest.mark.parametrize("cin,cout", [(3, 8), (32, 32), (8, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(hw, cin, cout, dtype):
    x, k = _inputs(2, *hw, cin, cout)
    want = np.asarray(pallas_conv.conv3x3_halo(
        jnp.asarray(x), jnp.asarray(k), getattr(jnp, dtype)))
    xt, wt = _to_port(x, k)
    port_conv.launches = 0
    got = port_conv.conv3x3_halo(xt, wt, getattr(torch, dtype))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=TOL)
    assert port_conv.launches == 0  # a CPU call never launches the kernel


def test_fast_conv3x3_matches_flax_conv():
    x, _ = _inputs(2, 13, 16, 8, 1, seed=1)
    conv = nn.Conv(12, (3, 3), padding="SAME")
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(2), a.shape),
        variables)
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    layer = FastConv3x3(8, 12)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            np.array(params["params"]["kernel"])).permute(3, 2, 0, 1))
        layer.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=TOL)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError):
        port_conv.conv3x3_halo(x, torch.zeros(5, 3, 3, 3))
    with pytest.raises(ValueError):
        port_conv.conv3x3_halo(x, torch.zeros(5, 4, 3, 3), torch.float16)
