"""The port's halo exchange and mesh tiling (``parallel/tiling.py``) on two
gloo ranks on the CPU, spawned once for the module (a ``FileStore`` under
``tmp_path``, no TCP port): the 9/7 row ladder, the 2-D DWT and the
learned-lifting ladder against the JAX package's shard_map functions on a
2-device mesh; ``make_halo_eval_step`` against the port's single-device
eval step for CDF97 (clrch 3 and 1), learned lifting + factorized, and the
flagship's widths with each entropy model (ZTsep, onlyEZWT, ZTBlock) at 2
levels, and ZTsep in bf16 on a 128x128 image, whose level-1 64x64 planes
take the matmul conv forms while a rank's extended row block of them
holds fewer than 4096 pixels (held against the single-device step with
the same fp32 ladder); the refusal of a height that does not divide or is too small;
``tiled_forward`` over the mesh against one device.

Tolerances: the ladders 1e-5 (JAX's own halo tests hold 1e-4 to 1e-5);
the RD terms as the JAX package's halo tests (mse 1e-4 relative and 1e-7
absolute, rates 1e-4 and 1e-5, loss 1e-4); xhat mean |diff| 1e-5 (a
quantization rounding that flips moves a few pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.parallel import (
    mesh as pmesh, tiling as ptiling)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.config import (
    Config as JConfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.transforms import (
    make_transform as jmake_transform)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.parallel import (
    mesh as jmesh, tiling as jtiling)

import test_torch_mesh_ranks as ranks
from test_torch_codec import random_params, unflatten

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

FLAGSHIP = dict(netType="LiftingBasedNeuralWaveletv4",
                entropy_layer="conditioned2ZTsepSubbands",
                autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=2,
                num_lifting_perlayer=2, filtersize=5, depth_scale=2,
                block_property="same", scale=0, linearity_flag=1,
                res_connection_weight=0.1, lambda_=117.3)
LIFT = dict(netType="LiftingBasedNeuralWaveletv4", entropy_layer="factorized",
            autoencoder="SubbandAutoEncoder", clrch=1, dwtlevels=2,
            num_lifting_perlayer=1, filtersize=3, depth_scale=1,
            block_property="same", scale=1, linearity_flag=1,
            res_connection_weight=0.1, dtype="float32", lambda_=100.0)
CDF97 = dict(netType="CDF97", entropy_layer="factorized",
             autoencoder="SubbandAutoEncoder", dwtlevels=2, lambda_=100.0)


def image(h, w, seed):
    return np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32)


def eval_cases():
    """name -> (config, model seed, NHWC image). The flagship cases take
    twice ``halo_min_height`` on 2 ranks, so that a rank's extended blocks
    hold only part of its neighbour's (at the least height they hold all
    of it, and a reach set too short would go unseen)."""
    return {
        "cdf97_clrch3": (dict(CDF97, clrch=3), 1, image(64, 32, 5)),
        "cdf97_clrch1": (dict(CDF97, clrch=1), 1, image(64, 32, 5)),
        "lifting_factorized": (LIFT, 2, image(64, 32, 7)),
        "flagship_ztsep": (FLAGSHIP, 3, image(160, 32, 8)),
        "flagship_onlyezwt": (dict(FLAGSHIP, entropy_layer="onlyEZWT"), 4,
                              image(192, 32, 9)),
        "flagship_ztblock": (dict(
            FLAGSHIP, entropy_layer="DWTConditioned2EntropyLayerZTBlock"), 5,
            image(224, 32, 10)),
        "flagship_ztsep_bf16": (dict(FLAGSHIP, dtype="bfloat16"), 6,
                                image(128, 128, 12)),
    }


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    """Every case on two spawned ranks; ``got[name]`` is the list of the
    ranks' results."""
    rng = np.random.RandomState(0)
    jcfg = JConfig(**dict(LIFT, clrch=3))
    x_lift = (rng.rand(1, 48, 32, 3) - 0.5).astype(np.float32)
    lift_params = random_params(lambda: jmake_transform(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x_lift)), 1)
    cases = {
        "x_rows": rng.randn(2, 32, 24, 3).astype(np.float32),
        "x_dwt": rng.randn(1, 64, 32, 3).astype(np.float32),
        "lift_cfg": dict(LIFT, clrch=3), "lift_params": lift_params,
        "x_lift": x_lift,
        "eval": eval_cases(),
        "bad_cfg": FLAGSHIP, "bad_heights": (36, 40),
        "tiled_cfg": dict(CDF97, clrch=1),
        "x_tiled": image(128, 32, 11),
    }
    out = tmp_path_factory.mktemp("halo")
    pmesh.spawn(ranks.halo_ranks, 2, "cpu", (str(out), cases),
                rendezvous_dir=str(out))
    res = {}
    for f in sorted(out.glob("*_rank*.pt")):
        name = f.name.rsplit("_rank", 1)[0]
        res.setdefault(name, []).append(torch.load(f, weights_only=False))
    res["cases"] = cases
    return res


def nhwc_cat(blocks):
    """Row blocks (NCHW tensors, rank order) -> the NHWC array."""
    return np.transpose(torch.cat(blocks, dim=2).numpy(), (0, 2, 3, 1))


def test_halo_lift97_rows_matches_jax(got):
    x = jnp.asarray(got["cases"]["x_rows"])
    mesh = jmesh.make_mesh(2)
    low, high = jax.jit(lambda v: jtiling.halo_lift97_rows(v, mesh))(x)
    for i, want in enumerate((low, high)):
        np.testing.assert_allclose(
            nhwc_cat([r[i] for r in got["lift97_rows"]]), np.asarray(want),
            rtol=0, atol=1e-5)


def test_halo_dwt97_2d_matches_jax(got):
    x = got["cases"]["x_dwt"]
    mesh = jmesh.make_mesh(2)
    ll, highs = jax.jit(lambda v: jtiling.halo_dwt97_2d(v, mesh, 2))(
        jnp.asarray(x))
    ranks_out = got["dwt97_2d"]
    np.testing.assert_allclose(nhwc_cat([r[0] for r in ranks_out]),
                               np.asarray(ll), rtol=0, atol=1e-5)
    for lv in range(2):
        np.testing.assert_allclose(nhwc_cat([r[1][lv] for r in ranks_out]),
                                   np.asarray(highs[lv]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nhwc_cat([r[2] for r in ranks_out]), x,
                               rtol=0, atol=1e-5)


def test_halo_lift2d_matches_jax(got):
    cases = got["cases"]
    jcfg = JConfig(**cases["lift_cfg"])
    mesh = jmesh.make_mesh(2)
    transform = jmake_transform(jcfg)
    ll, highs = jax.jit(lambda p, v: jtiling.halo_lift2d_forward(
        jcfg, transform, [p], v, mesh))(unflatten(cases["lift_params"]),
                                        jnp.asarray(cases["x_lift"]))
    ranks_out = got["lift2d"]
    np.testing.assert_allclose(nhwc_cat([r[0] for r in ranks_out]),
                               np.asarray(ll), rtol=0, atol=1e-5)
    for lv in range(2):
        np.testing.assert_allclose(nhwc_cat([r[1][lv] for r in ranks_out]),
                                   np.asarray(highs[lv]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nhwc_cat([r[2] for r in ranks_out]),
                               cases["x_lift"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(eval_cases()))
def test_halo_eval_step_matches_single_device(got, name):
    kw, seed, x = got["cases"]["eval"][name]
    cfg = pconfig.Config(**kw).validate()
    want, want_xhat = pstate.make_eval_step(
        cfg, ranks.halo_reference_codec(cfg, seed), device="cpu")(
            ranks.nchw(x))
    outs = got[f"eval_{name}"]
    for out, _ in outs:           # every rank reports the global terms
        for i, (rtol, atol) in enumerate(((1e-4, 0), (1e-4, 1e-7),
                                          (1e-4, 1e-5), (1e-4, 1e-5))):
            np.testing.assert_allclose(float(out[i]), float(want[i]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name} term {i}")
    xhat = torch.cat([r[1] for r in outs], dim=2)
    assert (xhat - want_xhat).abs().mean() <= 1e-5


def test_halo_eval_step_refuses_bad_heights(got):
    for msgs in got["refused"]:
        assert len(msgs) == 2
        assert "divide" in msgs[0]            # 36 rows: not a multiple of 8
        cfg = pconfig.Config(**FLAGSHIP).validate()
        h_min = ptiling.halo_min_height(cfg, 2)
        assert h_min == 80 and f"at least {h_min}" in msgs[1]   # 40 rows


def test_tiled_forward_over_the_mesh_matches_one_device(got):
    cfg = pconfig.Config(**got["cases"]["tiled_cfg"]).validate()
    want = ptiling.tiled_forward(cfg, ranks.seeded_codec(cfg, 3),
                                 got["cases"]["x_tiled"], 4, device="cpu")
    for g in got["tiled"]:
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)
