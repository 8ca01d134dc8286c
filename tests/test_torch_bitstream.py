"""The port's real bitstream against the JAX package's, on the CPU: the
flagship codec (ZTsep entropy model, per-plane YCbCr) at 2 levels and
64x64, fp32, with seeded random weights carried into both packages.

Both packages compile the same C++ context walkers and rANS with the same
flags on this host, so the same subbands and weights must give the same
bytes (every walk kind: LL, coarsest details, finer level), equal ``meta``
(the build fingerprint ``ctx_fp`` included), and each package must decode
the other's streams to the encoder's writeback bit for bit. A whole image
through each package's transforms gives subbands that differ in the last
ulps (another conv implementation), so there the streams are identical
where the decoded subbands are, and the rates and PSNRs agree within 1 %
and 0.01 dB. The C++ level walker's CDF indexes must equal
``build_indexes`` of the port's own ``level_params`` on the decoded planes
at >= 99.9 % of positions (they may differ where an fp32 sigma sits on a
table entry, computed in another order). Every test that builds the
context walkers lives in this file, so one worker pays for the build.

``python tests/test_torch_bitstream.py --write-targets`` writes
``results/port_bitstream_targets.json``: the JAX package's real bitstream
on the committed lambda=2000 snapshot over the 19 dead-leaves images of
the held-out set, the targets of ``chip_smoke.py``'s ``bitstream`` phase.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":      # run as a script from the repository root
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (  # noqa: E402
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
    codec_coder as pcc, wavefront as pwf)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    gaussian as pg, models as pem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    color as pcolor)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    data as pdata)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.coding import (
    codec_coder as jcc, native_ctx as jnative, rans as jrans, wavefront as jwf)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.ops import (
    color as jcolor)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

SNAPSHOT = os.path.join(ROOT, "results", "ckpt_snapshots",
                        "flagship_lam2000.npz")
TARGETS = os.path.join(ROOT, "results", "port_bitstream_targets.json")
FLAGSHIP = dict(netType="LiftingBasedNeuralWaveletv4",
                entropy_layer="conditioned2ZTsepSubbands",
                autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=4,
                num_lifting_perlayer=2, filtersize=5, depth_scale=2,
                block_property="same", scale=0, linearity_flag=1,
                res_connection_weight=0.1)
TARGET_IMAGES = (19, 256, 9999)   # synthetic_natural_images(n, size, seed)


LEVELS, SIZE = 2, 64
BPP_RTOL = 1e-2      # whole image, each package's own transforms
PSNR_TOL = 0.01      # dB
INDEX_AGREE = 0.999  # C++ walker's CDF indexes vs build_indexes(sigma)
MODULES_WITH_BUILDS = ((jrans, "librans.so"),
                       (jnative, "libwavefront_ctx.so"))


@pytest.fixture(scope="module", autouse=True)
def private_jax_builds(tmp_path_factory):
    """The JAX package builds its C++ next to its sources at first use, and
    another test worker may be writing those files at this moment: where
    this process has not loaded them yet, build them into a directory of
    its own (the JAX package's build, flags and all)."""
    mp = pytest.MonkeyPatch()
    out = tmp_path_factory.mktemp("jax_coding_build")
    for mod, name in MODULES_WITH_BUILDS:
        if mod._lib is None:
            mp.setattr(mod, "_LIB", str(out / name))
    yield
    mp.undo()


def cfgs(**kw):
    base = dict(FLAGSHIP, dwtlevels=LEVELS, lambda_=2000.0, **kw)
    return jconfig.Config(**base), pconfig.Config(**base).validate()


def random_params(jcfg, seed):
    """Flat flax params drawn from numpy (conv kernels with std
    1/sqrt(fan_in), GDN terms near their init and positive, small biases,
    random skip taps); only the shapes come from the JAX init."""
    x = jnp.zeros((1, SIZE, SIZE, 3))
    shapes = jax.eval_shape(lambda: JCodec(jcfg).init(
        jax.random.PRNGKey(0), x, False))["params"]
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


@pytest.fixture(scope="module")
def coders():
    """(JAX CodecCoder, port CodecCoder on the CPU, port model) with the
    same weights."""
    jcfg, pcfg = cfgs()
    flat = random_params(jcfg, 7)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    weights.unflatten_params(flat))
    model = PCodec(pcfg)
    weights.load_flax_params(model, flat)
    return (jcc.CodecCoder(jcfg, JCodec(jcfg), params),
            pcc.CodecCoder(pcfg, model, device="cpu"), model)


def subbands(seed):
    """One plane's pyramid, NHWC: LL (1,16,16,1), details (1,32,32,3) and
    (1,16,16,3), spread over a few quantization bins."""
    rng = np.random.RandomState(seed)
    xe = (rng.randn(1, 16, 16, 1) * 4).astype(np.float32)
    xo = [(rng.randn(1, SIZE >> (i + 1), SIZE >> (i + 1), 3)
           * (2.0 + i)).astype(np.float32) for i in range(LEVELS)]
    return xe, xo


def test_same_subbands_give_the_same_bytes_and_cross_decode(coders):
    jcoder, pcoder, _ = coders
    xe, xo = subbands(0)
    for plane in (0, 2):
        js, jxo, jxe, _ = jwf.compress_ztsep(jcoder, plane, xe, xo)
        ps, pxo, pxe, _ = pwf.compress_ztsep(pcoder, plane, xe, xo)
        assert ps.xe == js.xe                  # LL: the xe PixelCNN walk
        assert ps.xo[LEVELS - 1] == js.xo[LEVELS - 1]   # coarsest details
        assert ps.xo[:LEVELS - 1] == js.xo[:LEVELS - 1]  # finer levels
        assert ps.meta == js.meta and "ctx_fp" in ps.meta
        assert min(len(ps.xe), *map(len, ps.xo)) > 0
        np.testing.assert_array_equal(pxe, jxe)
        for a, b in zip(pxo, jxo):
            np.testing.assert_array_equal(a, b)
        shapes = (xe.shape, [t.shape for t in xo])
        # the port decodes the JAX package's streams, and the other way
        for dec, streams, (want_xe, want_xo) in (
                (lambda *a: pwf.decompress_ztsep(pcoder, *a), js, (jxe, jxo)),
                (lambda *a: jwf.decompress_ztsep(jcoder, *a), ps, (pxe, pxo))):
            got_xe, got_xo = dec(plane, streams, *shapes)
            np.testing.assert_array_equal(got_xe, want_xe)
            for a, b in zip(got_xo, want_xo):
                np.testing.assert_array_equal(a, b)


def test_whole_image_round_trip_matches_the_jax_package(coders):
    jcoder, pcoder, _ = coders
    img = pdata.synthetic_natural_images(1, SIZE, seed=11)[0]
    batch = img[None].astype(np.float32) / 255.0
    want = jcoder.compress_decompress(batch)
    got = pcoder.compress_decompress(batch)
    assert got.xhat.shape == batch.shape and got.xhat.dtype == np.float32
    assert 0.0 <= got.xhat.min() and got.xhat.max() <= 1.0
    assert abs(got.bpp - want.bpp) <= BPP_RTOL * want.bpp
    assert abs(got.psnr - want.psnr) <= PSNR_TOL
    assert set(pcoder.last_timing) == {
        "analysis_ms", "synthesis_ms", "encode_host_ms", "decode_host_ms",
        "host_wall_ms"}
    # where a plane's decoded subbands agree, its streams are the same (the
    # JAX side reuses the analysis its round trip compiled)
    y = pcolor.shift_ycbcr(pcolor.rgb_to_ycbcr(
        torch.from_numpy(batch).permute(0, 3, 1, 2)))
    jy = jcolor.shift_ycbcr(jcolor.rgb_to_ycbcr(jnp.asarray(batch)))
    jsub = jcoder._analysis_all()(jy[..., p:p + 1] for p in range(3))
    agreed = 0
    for plane in range(3):
        ps, _, pxe, pxo = pcoder.compress_plane(plane, y[:, plane:plane + 1])
        js, _, jxe, jxo = jcoder._compress_entropy(plane, *jsub[plane])
        if np.array_equal(pxe, jxe) and all(
                np.array_equal(a, b) for a, b in zip(pxo, jxo)):
            agreed += 1
            assert ps.xe == js.xe and ps.xo == js.xo and ps.meta == js.meta
    assert agreed >= 1


def test_walker_indexes_match_build_indexes_of_level_params(coders):
    _, pcoder, model = coders
    xe, xo = subbands(1)
    walker = pwf.ZTSepPlaneCoder(pcoder, 1)
    parent, _, _ = walker.code("coarsest", None, xo[1], None, None)
    hat, syms, idxs = walker.code("level", 0, xo[0], None, None, con=parent)
    em = model.codecs[1].entropymodel

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)

    with torch.no_grad():
        sigma, mu = em.level_params(0, nchw(hat), pem.upsample2(nchw(parent)))
    want = pg.build_indexes(sigma).permute(0, 2, 3, 1).numpy()[0]
    coords = np.concatenate(pwf.diagonal_order(*hat.shape[1:3], 3))
    want = want[coords[:, 0], coords[:, 1]].ravel()
    assert idxs.shape == want.shape and len(np.unique(want)) > 5
    assert np.mean(idxs == want) >= INDEX_AGREE
    # and the symbols are the writeback's: round(x - mu)
    mu = mu.permute(0, 2, 3, 1).numpy()[0][coords[:, 0], coords[:, 1]]
    x = xo[0][0][coords[:, 0], coords[:, 1]]
    assert np.mean(syms == np.round(x - mu).ravel()) >= INDEX_AGREE


def test_streams_of_another_evaluator_or_build_are_refused(coders):
    _, pcoder, _ = coders
    xe, xo = subbands(2)
    streams, _, _, _ = pwf.compress_ztsep(pcoder, 0, xe, xo)
    shapes = (xe.shape, [t.shape for t in xo])
    for key, value, match in (("evaluator_l0", "jax", "native"),
                              ("plc_backend_l0", "tpu", "native"),
                              ("ctx_fp", "0" * 16, "fingerprint")):
        bad = pcc.PlaneStreams(streams.xe, streams.xo,
                               dict(streams.meta, **{key: value}))
        with pytest.raises(RuntimeError, match=match):
            pwf.decompress_ztsep(pcoder, 0, bad, *shapes)
    bad = pcc.PlaneStreams(streams.xe, streams.xo,
                           {k: "jax" for k in streams.meta if k != "ctx_fp"})
    with pytest.raises(RuntimeError, match="native"):
        pwf.decompress_ztsep(pcoder, 0, bad, *shapes)


def test_tiled_coding_raises(coders):
    """It no longer raises: as the JAX package's, the codec coder codes the
    whole image whatever ``tile_size`` says (the agent's ``test`` routes to
    ``coding/tiled_coder.py``, ``tests/test_torch_tiling.py``)."""
    _, pcoder, model = coders
    batch = pdata.synthetic_natural_images(1, SIZE, seed=3)[0][None].astype(
        np.float32) / 255.0
    tiled = pcc.CodecCoder(pconfig.Config(**{**pcoder.cfg.__dict__,
                                            "tile_size": 32}),
                           model, device="cpu")
    got, want = tiled.compress_decompress(batch), pcoder.compress_decompress(
        batch)
    assert [(s.xe, s.xo) for s in got.streams] == [
        (s.xe, s.xo) for s in want.streams]


def test_cdf97_factorized_round_trip_matches_the_jax_package():
    """The factorized branch: the CDF 9/7 codec (joint RGB) at 2 levels."""
    with open(os.path.join(ROOT, "configs", "cdf97_factorized.json")) as fh:
        raw = dict(json.load(fh), dwtlevels=LEVELS)
    jcfg, pcfg = jconfig.config_from_dict(raw), pconfig.config_from_dict(raw)
    model = PCodec(pcfg, generator=torch.Generator().manual_seed(0))
    flat = weights.flax_params_from_state_dict(model.state_dict())
    params = jax.tree_util.tree_map(jnp.asarray,
                                    weights.unflatten_params(flat))
    img = pdata.synthetic_natural_images(1, SIZE, seed=12)[0]
    batch = img[None].astype(np.float32) / 255.0
    want = jcc.CodecCoder(jcfg, JCodec(jcfg), params).compress_decompress(
        batch)
    coder = pcc.CodecCoder(pcfg, model, device="cpu")
    got = coder.compress_decompress(batch)
    assert abs(got.bpp - want.bpp) <= BPP_RTOL * want.bpp
    assert abs(got.psnr - want.psnr) <= PSNR_TOL
    # lossless: the decoded subbands are the encoder's quantized ones
    xe, xo = coder.analysis(0, torch.from_numpy(batch).permute(0, 3, 1, 2)
                            - 0.5)
    streams, _, xe_hat, xo_hats = coder._compress_entropy(0, xe, xo)
    dxe, dxo = coder._decompress_entropy(0, streams, xe_hat.shape,
                                         [t.shape for t in xo_hats])
    np.testing.assert_array_equal(dxe, xe_hat)
    for a, b in zip(dxo, xo_hats):
        np.testing.assert_array_equal(a, b)


def test_targets_file_lists_the_19_images():
    with open(TARGETS) as fh:
        t = json.load(fh)
    assert [r["image"] for r in t["per_image"]] == [
        f"natural_9999_{k:04d}" for k in range(19)]
    assert t["command"] == ("python tests/test_torch_bitstream.py "
                            "--write-targets")
    assert all(1.0 < r["bpp"] < 3.0 and 28.0 < r["psnr"] < 32.0
               for r in t["per_image"])



def write_targets(path=TARGETS):
    """The JAX package's real bitstream on the lambda=2000 snapshot, fp32,
    over the 19 dead-leaves images of the held-out set, one at a time (as
    its ``test`` mode feeds them): per image bpp and PSNR."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.coding import (
        native_ctx)

    cfg = jconfig.Config(**dict(FLAGSHIP, lambda_=2000.0, dtype="float32"))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32),
        weights.unflatten_params(weights.load_npz(SNAPSHOT)))
    coder = jcc.CodecCoder(cfg, JCodec(cfg), params)
    n, size, seed = TARGET_IMAGES
    rows = []
    for k, img in enumerate(pdata.synthetic_natural_images(n, size, seed)):
        t0 = time.perf_counter()
        res = coder.compress_decompress(img[None].astype(np.float32) / 255.0)
        rows.append({"image": f"natural_{seed}_{k:04d}", "bpp": res.bpp,
                     "psnr": res.psnr,
                     "bytes": sum(s.nbytes() for s in res.streams),
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    out = {
        "what": "the JAX package's real bitstream (CodecCoder."
                "compress_decompress) on results/ckpt_snapshots/"
                "flagship_lam2000.npz, configs/flagship_lifting_ztsep.json's "
                "codec in float32, lambda 2000, one image at a time",
        "images": f"synthetic_natural_images({n}, {size}, seed={seed}): "
                  "natural_9999_0000 .. _0018 of the held-out set",
        "command": "python tests/test_torch_bitstream.py --write-targets",
        "host": "CPU, JAX's CPU backend; the context walkers built by the "
                "JAX package's coding/native_ctx.py",
        "ctx_fp": native_ctx.ctx_fingerprint(),
        "mean_bpp": float(np.mean([r["bpp"] for r in rows])),
        "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
        "per_image": rows}
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    return out


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-targets"]:
        sys.exit("usage: python tests/test_torch_bitstream.py --write-targets")
    jax.config.update("jax_platforms", "cpu")
    write_targets()
