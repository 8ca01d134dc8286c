"""The quincunx codec's real bitstream in the port against the JAX
package's, on the CPU, and the rate-distortion record of the held-out set.

- A factorized stream of the lambda=400 snapshot through both packages'
  coders at 64x64: each decodes losslessly (the coder raises otherwise),
  and their bpp and PSNR agree (the bottleneck tables come from each
  package's own fp32 ``pmf_table``, whose transcendentals differ by an ulp:
  a stream crosses packages only from shared tables);
- one held-out image coded by the port against the JAX package's target
  (0.5 % bpp, 0.02 dB: as ``chip_smoke.py`` gates the card);
- the committed ``results/port_rd_heldout.json`` (written by
  ``tools/rd_heldout.py``) holds every image of the set within those
  gates of the JAX package's CPU coding where a targets file has it;
- the CLI on a tiny quincunx config: train, resume, ``mode: test``.

``python tests/test_torch_quincunx_coding.py --write-targets`` writes the
JAX package's fp32 CPU coding (bpp, PSNR a image) of the 19 dead-leaves
images under both quincunx snapshots (``results/port_quincunx_targets.json``,
``chip_smoke.py``'s ``quincunx_bitstream`` targets) and of the 5
photographs under those and the lambda=2000 flagship snapshot
(``results/port_photo_targets.json``); a few minutes. With
``--write-targets flagship_lam6000`` it writes the JAX package's coding of
all 24 held-out images under the lambda=6000 flagship snapshot
(``results/port_flagship6000_targets.json``, ``chip_smoke.py``'s
``bitstream`` targets for that snapshot) and nothing else.
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
    cli as pcli)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (  # noqa: E402
    rd_heldout, weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (  # noqa: E402
    checkpoint as pckpt, data as pdata)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (  # noqa: E402
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.coding import (  # noqa: E402
    codec_coder as jcc, native_ctx as jnative, rans as jrans)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (  # noqa: E402
    CodecWrapper as JCodec)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

RESULTS = os.path.join(ROOT, "results")
TARGETS = os.path.join(RESULTS, "port_quincunx_targets.json")
PHOTO_TARGETS = os.path.join(RESULTS, rd_heldout.PHOTO_TARGETS)
HELDOUT = os.path.join(RESULTS, "port_rd_heldout.json")
FLAGSHIP6000_TARGETS = os.path.join(RESULTS,
                                    "port_flagship6000_targets.json")
QUINCUNX_POINTS = ("quincunx_lam400", "quincunx_lam1600")
PHOTOS = ("grace_hopper", "pg_background", "pg_camera", "sk_china",
          "sk_flower")
TARGET_BPP_RTOL = 5e-3
TARGET_PSNR_TOL = 0.02   # dB
CROSS_BPP_RTOL = 1e-3    # whole image, each package's own tables
CROSS_PSNR_TOL = 1e-3    # dB
MODULES_WITH_BUILDS = ((jrans, "librans.so"),
                       (jnative, "libwavefront_ctx.so"))


@pytest.fixture(scope="module")
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


def jax_coder(name):
    """The JAX package's CodecCoder of point ``name`` in fp32."""
    cfg, snap, lam, _, _ = rd_heldout.POINTS[name]
    jcfg = jconfig.Config(**dict(cfg, lambda_=float(lam), dtype="float32"))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32),
        weights.unflatten_params(weights.load_npz(
            os.path.join(RESULTS, "ckpt_snapshots", snap))))
    return jcc.CodecCoder(jcfg, JCodec(jcfg), params)


def test_stream_round_trip_matches_the_jax_package(private_jax_builds):
    img = pdata.synthetic_natural_images(1, 64, seed=12)[0]
    batch = img[None].astype(np.float32) / 255.0
    want = jax_coder("quincunx_lam400").compress_decompress(batch)
    coder = rd_heldout.load_point("quincunx_lam400", "cpu")
    got = coder.compress_decompress(batch)
    assert abs(got.bpp - want.bpp) <= CROSS_BPP_RTOL * want.bpp
    assert abs(got.psnr - want.psnr) <= CROSS_PSNR_TOL
    # lossless: the decoded subbands are the encoder's quantized ones
    streams, _, xe_hat, xo_hats = coder.compress_plane(
        0, torch.from_numpy(batch).permute(0, 3, 1, 2) - 0.5)
    dxe, dxo = coder._decompress_entropy(0, streams, xe_hat.shape,
                                         [t.shape for t in xo_hats])
    np.testing.assert_array_equal(dxe, xe_hat)
    for a, b in zip(dxo, xo_hats):
        np.testing.assert_array_equal(a, b)
    # two decodes of one stream give the same bits
    again = coder.decompress_plane(0, streams, xe_hat.shape,
                                   [t.shape for t in xo_hats])
    np.testing.assert_array_equal(again, coder.decompress_plane(
        0, streams, xe_hat.shape, [t.shape for t in xo_hats]))


def test_a_heldout_image_codes_as_the_jax_package_did():
    with open(TARGETS) as fh:
        target = json.load(fh)["points"]["quincunx_lam1600"]["per_image"][3]
    n, size, seed = rd_heldout.DEAD_LEAVES
    img = pdata.synthetic_natural_images(4, size, seed=seed)[3]
    got = rd_heldout.load_point("quincunx_lam1600", "cpu").compress_decompress(
        img[None].astype(np.float32) / 255.0)
    assert target["image"] == f"natural_{seed}_0003"
    assert abs(got.bpp - target["bpp"]) <= TARGET_BPP_RTOL * target["bpp"]
    assert abs(got.psnr - target["psnr"]) <= TARGET_PSNR_TOL


def test_targets_files_list_their_images():
    with open(TARGETS) as fh:
        t = json.load(fh)
    assert t["command"] == ("python tests/test_torch_quincunx_coding.py "
                            "--write-targets")
    n, _, seed = rd_heldout.DEAD_LEAVES
    assert sorted(t["points"]) == sorted(QUINCUNX_POINTS)
    for name in QUINCUNX_POINTS:
        assert [r["image"] for r in t["points"][name]["per_image"]] == [
            f"natural_{seed}_{k:04d}" for k in range(n)]
    with open(PHOTO_TARGETS) as fh:
        p = json.load(fh)
    assert sorted(p["points"]) == sorted(rd_heldout.POINTS)
    for rows in p["points"].values():
        assert [r["image"] for r in rows["per_image"]] == list(PHOTOS)
    with open(FLAGSHIP6000_TARGETS) as fh:
        f = json.load(fh)
    assert f["command"].endswith("--write-targets flagship_lam6000")
    with open(os.path.join(RESULTS, "rd_flagship.json")) as fh:
        eval_set = [n[:-4] for n in sorted(json.load(fh)["eval_set"])]
    assert [r["image"] for r in f["points"]["flagship_lam6000"][
        "per_image"]] == eval_set == f["images"]


def test_heldout_record_holds_every_image_to_the_jax_package():
    """The committed record: all 24 images under the three points, each
    within 0.5 % bpp and 0.02 dB of the JAX package's CPU coding, the
    means beside the committed JAX points."""
    with open(HELDOUT) as fh:
        rec = json.load(fh)
    with open(os.path.join(RESULTS, "rd_quincunx.json")) as fh:
        eval_set = [n[:-4] for n in sorted(json.load(fh)["eval_set"])]
    assert rec["images"] == eval_set and not rec["photos_missing"]
    assert sorted(rec["points"]) == sorted(rd_heldout.POINTS)
    for name, point in rec["points"].items():
        rows = point["per_image"]
        assert [r["image"] for r in rows] == eval_set
        assert all(abs(r["jax_cpu_bpp_rel_gap"]) <= TARGET_BPP_RTOL
                   and abs(r["jax_cpu_psnr_gap_db"]) <= TARGET_PSNR_TOL
                   for r in rows), name
        assert point["mean_bpp"] == pytest.approx(
            np.mean([r["bpp"] for r in rows]))
        assert abs(point["gap_to_jax_point"]["bpp_rel"]) < 0.05, name


def test_heldout_set_is_rd_sweeps():
    images = rd_heldout.heldout_images()
    with open(os.path.join(RESULTS, "rd_quincunx.json")) as fh:
        assert list(images) == [n[:-4] for n in sorted(
            json.load(fh)["eval_set"])]
    assert all(img.shape[0] % 64 == 0 and img.shape[1] % 64 == 0
               for img in images.values())


def test_cli_trains_resumes_and_codes_the_quincunx_codec(tmp_path,
                                                         monkeypatch):
    """The CLI on the quincunx preset cut to 2 levels and 32x32 patches:
    a one-step epoch, a resumed epoch, then ``mode: test`` codes the two
    test images."""
    monkeypatch.chdir(tmp_path)
    images = str(tmp_path / "images")
    pdata.write_corpus(images, 2, 32, seed=5, kind="plain")
    raw = dict(rd_heldout.QUINCUNX, dwtlevels=2, exp_name="qx",
               batch_size=1, patch_size=32, val_patch_size=32,
               steps_per_epoch=1, max_epoch=1, lambda_=400.0,
               valid_data=images, test_data=images, test_patch_size=32)
    ckpt_dir = os.path.join("experiments", "qx", "checkpoints")
    for mode, argv, epochs in (("train", [], 1),
                               ("train", ["--resume-training"], 2),
                               ("test", [], 2)):
        with open("qx.json", "w") as fh:
            json.dump(dict(raw, mode=mode, max_epoch=epochs), fh)
        assert pcli.main(["--device", "cpu", *argv, "qx.json"]) == 0
    saved = pckpt.load_checkpoint(ckpt_dir)
    assert (saved["epoch"], saved["iteration"]) == (1, 3)
    assert any(k.startswith("codec.transform.layers_1.lift_ver2")
               for k in saved["model"])


def _code(name, images, coder=None):
    coder = coder or jax_coder(name)
    rows = []
    for img_name, img in images.items():
        t0 = time.perf_counter()
        res = coder.compress_decompress(img[None].astype(np.float32) / 255.0)
        rows.append({"image": img_name, "bpp": res.bpp, "psnr": res.psnr,
                     "bytes": sum(s.nbytes() for s in res.streams),
                     "seconds": time.perf_counter() - t0})
        print(json.dumps({"point": name, **rows[-1]}), flush=True)
    return {"mean_bpp": float(np.mean([r["bpp"] for r in rows])),
            "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
            "per_image": rows}


def write_targets():
    """The JAX package's real bitstream, fp32, one image at a time: the 19
    dead-leaves images under both quincunx snapshots, the 5 photographs
    under those and the lambda=2000 flagship snapshot."""
    images = rd_heldout.heldout_images()
    dead = {k: v for k, v in images.items() if k.startswith("natural_")}
    photos = {k: v for k, v in images.items() if k not in dead}
    common = {
        "command": "python tests/test_torch_quincunx_coding.py "
                   "--write-targets",
        "host": "CPU, JAX's CPU backend; the C++ coding built by the JAX "
                "package",
        "ctx_fp": jnative.ctx_fingerprint()}
    n, size, seed = rd_heldout.DEAD_LEAVES
    out = {"what": "the JAX package's real bitstream (CodecCoder."
                   "compress_decompress) on the quincunx snapshots "
                   "(scripts/rd_sweep.py's quincunx preset) in float32, one "
                   "image at a time",
           "images": f"synthetic_natural_images({n}, {size}, seed={seed}): "
                     "natural_9999_0000 .. _0018 of the held-out set",
           **common,
           "points": {name: _code(name, dead) for name in QUINCUNX_POINTS}}
    photo = {"what": "the JAX package's real bitstream (CodecCoder."
                     "compress_decompress) of the held-out set's "
                     "photographs (cropped to multiples of 64 as "
                     "scripts/rd_sweep.py crops them) in float32, one image "
                     "at a time",
             "images": list(photos), **common,
             "points": {name: _code(name, photos)
                        for name in rd_heldout.POINTS}}
    for path, obj in ((TARGETS, out), (PHOTO_TARGETS, photo)):
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=1)
            fh.write("\n")


def write_flagship6000_targets(path=FLAGSHIP6000_TARGETS):
    """The JAX package's real bitstream, fp32, one image at a time, of all
    24 held-out images under the lambda=6000 flagship snapshot."""
    jcfg = jconfig.Config(**dict(rd_heldout.FLAGSHIP, lambda_=6000.0,
                                 dtype="float32"))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32),
        weights.unflatten_params(weights.load_npz(
            os.path.join(RESULTS, "ckpt_snapshots", "flagship_lam6000.npz"))))
    images = rd_heldout.heldout_images()
    t0 = time.perf_counter()
    point = _code("flagship_lam6000", images,
                  jcc.CodecCoder(jcfg, JCodec(jcfg), params))
    out = {"what": "the JAX package's real bitstream (CodecCoder."
                   "compress_decompress) of the held-out set under the "
                   "lambda=6000 flagship snapshot in float32, one image at a "
                   "time",
           "images": list(images),
           "command": "python tests/test_torch_quincunx_coding.py "
                      "--write-targets flagship_lam6000",
           "host": "CPU, JAX's CPU backend; the C++ coding built by the JAX "
                   "package",
           "ctx_fp": jnative.ctx_fingerprint(),
           "seconds": time.perf_counter() - t0,
           "points": {"flagship_lam6000": point}}
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["--write-targets"]:
        write_targets()
    elif sys.argv[1:] == ["--write-targets", "flagship_lam6000"]:
        write_flagship6000_targets()
    else:
        sys.exit("usage: python tests/test_torch_quincunx_coding.py "
                 "--write-targets [flagship_lam6000]")
