"""Tiled coding and the port's entry-point settings, on the CPU.

- ``parallel/tiling.py``: ``tile_image``, ``untile_image`` and
  ``reconstruction_margin`` equal the JAX package's exactly.
- ``coding/tiled_coder.py``: a 128x64 image in two tiles of 64 rows
  (``tile_size`` 64) through the flagship codec at 2 levels (ZTsep, seeded
  random weights in both packages): the port's streams are the JAX
  package's byte for byte, each package decodes the other's, the thread
  pool and sequential tiles give the same bytes, and the agent's ``test``
  routes such an image to the tiled coder; ``tiled_forward`` is the eval
  forward of each margin-padded tile.
- The entry points run fp32 at full precision: the agent, ``CodecCoder``
  and the CLI turn TF32 off (the flags can be read on a CPU build).
- An unknown autoencoder kind raises ``ValueError``, as in the JAX package.
- The committed ``results/heldout_photos.npz`` holds the crops of the
  photographs that matplotlib, scikit-learn and pygame ship (skipped where
  those packages are missing).

``python tests/test_torch_tiling.py --write-targets`` writes
``results/port_tiled_targets.json``: the JAX package's tiled coding on the
CPU of the 1024x1024 image of ``chip_smoke.py``'s ``tiled_bitstream``
phase with the lambda=2000 snapshot, ``tile_size`` 256.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":      # run as a script from the repository root
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (  # noqa: E402
    cli as pcli, config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (  # noqa: E402
    codec_coder as pcc, tiled_coder as ptc)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (  # noqa: E402
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (  # noqa: E402
    subband_ae as pae)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.parallel import (  # noqa: E402
    tiling as ptiling)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (  # noqa: E402
    rd_heldout, weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (  # noqa: E402
    data as pdata, loop as ploop)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (  # noqa: E402
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.coding import (  # noqa: E402
    native_ctx as jnative, rans as jrans, tiled_coder as jtc)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (  # noqa: E402
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.parallel import (  # noqa: E402
    tiling as jtiling)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

RESULTS = os.path.join(ROOT, "results")
TILED_TARGETS = os.path.join(RESULTS, "port_tiled_targets.json")
FLAGSHIP = dict(rd_heldout.FLAGSHIP, lambda_=2000.0)
LEVELS, H, W, TILE = 2, 128, 64, 64
# chip_smoke.py's tiled_bitstream image: synthetic_natural_images(1, 1024,
# seed), tile_size 256, the lambda=2000 snapshot
TARGET_IMAGE = (1024, 3, 256)
# reconstructions: the same decoded subbands through each package's own
# synthesis (fp32 convs summed in another order; the seeded random weights
# amplify it far more than trained ones)
XHAT_ATOL = 1e-3
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


def image(seed=3):
    """A 128x64 RGB image in [0, 1], NHWC."""
    img = pdata.synthetic_natural_images(1, H, seed=seed)[0][:, :W]
    return img[None].astype(np.float32) / 255.0


def test_tile_and_untile_equal_the_jax_package():
    x = np.random.RandomState(0).rand(1, 96, 40, 3).astype(np.float32)
    for n, overlap in ((1, 0), (3, 8), (4, 16)):
        got, meta = ptiling.tile_image(x, n, overlap)
        want, jmeta = jtiling.tile_image(x, n, overlap)
        np.testing.assert_array_equal(got, want)
        assert tuple(meta) == tuple(jmeta)
        np.testing.assert_array_equal(ptiling.untile_image(got, meta), x)
        np.testing.assert_array_equal(
            ptiling.untile_image(got, meta), jtiling.untile_image(want, jmeta))
    for levels, fs in ((2, 5), (4, 5), (3, 3)):
        kw = dict(dwtlevels=levels, filtersize=fs)
        assert ptiling.reconstruction_margin(pconfig.Config(**kw)) \
            == jtiling.reconstruction_margin(jconfig.Config(**kw))
    with pytest.raises(ValueError, match="divide"):
        ptiling.tile_image(x, 5, 0)


def random_params(jcfg, seed):
    """Flat flax params drawn from numpy; only the shapes come from the JAX
    init (GDN terms near their init and positive)."""
    shapes = jax.eval_shape(lambda: JCodec(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False))["params"]
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
def codecs():
    """(JAX config, JAX codec, its params, port config, port model) with
    the same weights, 2 levels, ``tile_size`` 64."""
    kw = dict(FLAGSHIP, dwtlevels=LEVELS, tile_size=TILE)
    jcfg, pcfg = jconfig.Config(**kw), pconfig.Config(**kw).validate()
    flat = random_params(jcfg, 7)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    weights.unflatten_params(flat))
    model = PCodec(pcfg)
    weights.load_flax_params(model, flat)
    return jcfg, JCodec(jcfg), params, pcfg, model


def stream_bytes(ts):
    return [[(p.xe, p.xo, p.meta) for p in t] for t in ts.tiles]


def test_tiled_streams_equal_the_jax_package_and_cross_decode(codecs):
    jcfg, jmodel, params, pcfg, model = codecs
    x = image()
    jcoder = jtc.TiledCodecCoder(jcfg, jmodel, params, n_tiles=H // TILE,
                                 parallel=False)
    pcoder = ptc.TiledCodecCoder(pcfg, model, H // TILE, parallel=False,
                                 device="cpu")
    jts, jxhat = jcoder.compress(x)
    pts, pxhat = pcoder.compress(x)
    assert tuple(pts.meta) == tuple(jts.meta) and pts.meta.n_tiles == 2
    assert stream_bytes(pts) == stream_bytes(jts)
    assert (pts.xe_shape, [tuple(s) for s in pts.xo_shapes]) == (
        tuple(jts.xe_shape), [tuple(s) for s in jts.xo_shapes])
    np.testing.assert_allclose(pxhat, jxhat, atol=XHAT_ATOL)
    assert len(pcoder.last_tile_timing) == 2 and all(
        t["encode_host_ms"] > 0 for t in pcoder.last_tile_timing)
    # each package decodes the other's streams to its own reconstruction
    np.testing.assert_array_equal(pcoder.decompress(jts), pxhat)
    np.testing.assert_array_equal(jcoder.decompress(pts), jxhat)
    # the pool codes the same bytes, and the round trip reports them
    pool = ptc.TiledCodecCoder(pcfg, model, H // TILE, parallel=True,
                               device="cpu")
    res = pool.compress_decompress(x)
    assert [(s.xe, s.xo) for s in res.streams] == [
        (p.xe, p.xo) for t in pts.tiles for p in t]
    want = jcoder.compress_decompress(x)
    assert res.bpp == want.bpp and abs(res.psnr - want.psnr) < 1e-3


def test_tiled_forward_is_the_eval_forward_of_each_tile(codecs):
    """The surrogate tiled forward: each tile (the image padded by the
    margin, edge rows repeated) through the eval forward, the interiors
    stitched; here one tile, then two."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
        state as pstate)
    _, _, _, pcfg, model = codecs
    x = image()
    o = ptiling.reconstruction_margin(pcfg)
    padded = np.pad(x, ((0, 0), (o, o), (0, 0), (0, 0)), mode="edge")
    with torch.inference_mode():
        _, xhat, _, _, _ = pstate.apply_color_forward(
            pcfg, model.eval(), torch.from_numpy(padded).permute(0, 3, 1, 2))
    want = (torch.clamp(xhat, -0.5, 0.5) + 0.5).permute(0, 2, 3, 1).numpy()
    got = ptiling.tiled_forward(pcfg, model, x, 1, device="cpu")
    np.testing.assert_array_equal(got, want[:, o:o + H])
    two = ptiling.tiled_forward(pcfg, model, x, 2, device="cpu")
    assert two.shape == x.shape and np.isfinite(two).all()


def test_agent_test_mode_codes_in_tiles(codecs, tmp_path, monkeypatch):
    """The agent's ``test`` with ``tile_size`` 64 on a 128x64 test image:
    the tiled coder's result, logged as a test image."""
    _, _, _, pcfg, model = codecs
    x = image(seed=4)
    got = []
    real = ptc.TiledCodecCoder.compress_decompress

    def spy(self, img):
        got.append(real(self, img))
        return got[-1]

    monkeypatch.setattr(ptc.TiledCodecCoder, "compress_decompress", spy)
    agent = ploop.LiftingDWTAgent.__new__(ploop.LiftingDWTAgent)
    agent.cfg, agent.model, agent.device = pcfg, model, torch.device("cpu")
    agent.data = type("Data", (), {"test_batches": lambda self: iter([x])})()
    agent.heartbeat = type("Beat", (), {"beat": lambda self: None})()
    agent.test_logger = lambda *a: None
    agent.logger = ploop.setup_logging("")
    psnr, bpp = agent.test()
    assert len(got) == 1 and (psnr, bpp) == (got[0].psnr, got[0].bpp)
    whole = pcc.CodecCoder(pcfg, model, "cpu").compress_decompress(x)
    assert whole.bpp != bpp        # a whole-image stream is another stream


def test_entry_points_turn_tf32_off(codecs, tmp_path, monkeypatch):
    _, _, _, pcfg, model = codecs

    def tf32_on():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    def tf32_off():
        return not (torch.backends.cudnn.allow_tf32
                    or torch.backends.cuda.matmul.allow_tf32)

    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    try:
        tf32_on()
        pcc.CodecCoder(pcfg, model, "cpu")
        assert tf32_off()
        tf32_on()
        monkeypatch.chdir(tmp_path)
        cfg = pconfig._attach_dirs(pconfig.Config(
            **dict(FLAGSHIP, dwtlevels=LEVELS)).validate(),
            str(tmp_path / "experiments"))
        ploop.LiftingDWTAgent(cfg, device="cpu")
        assert tf32_off()
        tf32_on()
        assert pcli.main(["--device", "cpu"]) == 2    # usage, after the flags
        assert tf32_off()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def test_unknown_autoencoder_raises_value_error():
    with pytest.raises(ValueError, match="unknown autoencoder kind 'nope'"):
        pae.make_subband_ae("nope", 3)


PHOTOS = ("grace_hopper", "pg_background", "pg_camera", "sk_china",
          "sk_flower")


def test_committed_photos_are_the_packages_crops():
    crops = dict(rd_heldout.package_photos())
    if sorted(crops) != sorted(PHOTOS):
        pytest.skip("needs matplotlib, scikit-learn, pygame and PIL")
    with np.load(rd_heldout.PHOTOS_NPZ) as f:
        assert sorted(f.files) == sorted(PHOTOS)
        for name in PHOTOS:
            assert f[name].dtype == np.uint8
            np.testing.assert_array_equal(f[name], crops[name], err_msg=name)


def write_targets(path=TILED_TARGETS):
    """The JAX package's tiled coding on the CPU (fp32, the thread pool, as
    its agent runs it) of ``chip_smoke.py``'s tiled image."""
    size, seed, tile = TARGET_IMAGE
    jcfg = jconfig.Config(**dict(FLAGSHIP, tile_size=tile, dtype="float32"))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32),
        weights.unflatten_params(weights.load_npz(os.path.join(
            RESULTS, "ckpt_snapshots", "flagship_lam2000.npz"))))
    coder = jtc.TiledCodecCoder(jcfg, JCodec(jcfg), params,
                                n_tiles=size // tile)
    img = pdata.synthetic_natural_images(1, size, seed=seed)[0]
    t0 = time.perf_counter()
    res = coder.compress_decompress(img[None].astype(np.float32) / 255.0)
    out = {"what": "the JAX package's tiled real bitstream "
                   "(coding/tiled_coder.py::TiledCodecCoder."
                   "compress_decompress, float32, a thread pool over tiles) "
                   "with the lambda=2000 flagship snapshot",
           "command": "python tests/test_torch_tiling.py --write-targets",
           "host": "CPU, JAX's CPU backend; the C++ coding built by the JAX "
                   "package",
           "ctx_fp": jnative.ctx_fingerprint(),
           "image": f"synthetic_natural_images(1, {size}, seed={seed})",
           "tile_size": tile, "n_tiles": size // tile,
           "overlap": jtiling.reconstruction_margin(jcfg),
           "bpp": res.bpp, "psnr": res.psnr,
           "bytes": sum(s.nbytes() for s in res.streams),
           "sha256": chip_smoke.streams_sha256(res.streams),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-targets"]:
        sys.exit("usage: python tests/test_torch_tiling.py --write-targets")
    jax.config.update("jax_platforms", "cpu")
    write_targets()
