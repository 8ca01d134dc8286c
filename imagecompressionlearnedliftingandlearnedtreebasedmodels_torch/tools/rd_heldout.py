"""The port's real-bitstream rate-distortion points on the 24-image
held-out set.

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.rd_heldout --device cpu

Codes every image of the held-out set of ``scripts/rd_sweep.py`` one at a
time through ``coding/codec_coder.py`` (as the agent's ``test`` mode feeds
them) with each committed snapshot of :data:`POINTS`, in fp32, and writes
``results/port_rd_heldout.json``: per point the means and a row per image
(bpp, PSNR, bytes, seconds; every plane decodes to the encoder's writeback
bit for bit, or the coder raises), and beside them

- the gap of the means to the committed JAX points
  (``results/rd_quincunx.json``, ``results/rd_flagship.json``: runs of the
  JAX package on another backend, whose fp32 convs may round otherwise, so
  a gap is reported, not gated);
- each image's gap to the JAX package's own fp32 CPU coding of the same
  image and snapshot, where a targets file has it (the dead-leaves images
  in ``results/port_quincunx_targets.json`` and
  ``results/port_bitstream_targets.json``, the photographs in
  ``results/port_photo_targets.json``; ``python
  tests/test_torch_quincunx_coding.py --write-targets`` writes the first
  and the last).

The held-out set: the 19 dead-leaves images
``synthetic_natural_images(19, 256, seed=9999)`` and the 5 photographs
that matplotlib, scikit-learn and pygame install, cropped to multiples of
64 as ``scripts/rd_sweep.py::build_dirs`` crops them. Where a package (or
PIL) is missing, its photographs come from ``results/heldout_photos.npz``
(uint8 HWC, one key a name), which

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.rd_heldout --write-photos

writes from the packages' crops; a photograph found in neither is left
out (and listed). Names sort as in ``rd_*.json``'s ``eval_set``. It runs
on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import config as config_mod
from ..coding.codec_coder import CodecCoder
from ..models.codec import CodecWrapper
from ..train import data
from . import weights

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS = os.path.join(_REPO, "results")
OUT = os.path.join(RESULTS, "port_rd_heldout.json")
DEAD_LEAVES = (19, 256, 9999)       # synthetic_natural_images(n, size, seed)
# scripts/rd_sweep.py's quincunx preset
QUINCUNX = dict(netType="QuincunxLifting", entropy_layer="factorized",
                autoencoder="SubbandAutoEncoder", clrch=3, dwtlevels=3,
                split_mode="hv", lif_prec_bits=8, num_lifting_perlayer=2)
FLAGSHIP = dict(netType="LiftingBasedNeuralWaveletv4",
                entropy_layer="conditioned2ZTsepSubbands",
                autoencoder="SubbandAutoEncoderBerk", clrch=1, dwtlevels=4,
                num_lifting_perlayer=2, filtersize=5, depth_scale=2,
                block_property="same", scale=0, linearity_flag=1,
                res_connection_weight=0.1)
PHOTO_TARGETS = "port_photo_targets.json"
PHOTOS_NPZ = os.path.join(RESULTS, "heldout_photos.npz")
# name -> (config, snapshot, lambda, the JAX point's file, the files of the
# JAX package's CPU coding of the same images)
POINTS = {
    "quincunx_lam400": (QUINCUNX, "quincunx_lam400.npz", 400,
                        "rd_quincunx.json",
                        ("port_quincunx_targets.json", PHOTO_TARGETS)),
    "quincunx_lam1600": (QUINCUNX, "quincunx_lam1600.npz", 1600,
                         "rd_quincunx.json",
                         ("port_quincunx_targets.json", PHOTO_TARGETS)),
    "flagship_lam2000": (FLAGSHIP, "flagship_lam2000.npz", 2000,
                         "rd_flagship.json",
                         ("port_bitstream_targets.json", PHOTO_TARGETS)),
}


def jax_cpu_targets(name: str) -> Dict[str, dict]:
    """``{image: row}`` of the JAX package's CPU coding of point ``name``
    from the targets files that exist (a file of one point holds
    ``per_image``, one of several ``points[name]["per_image"]``)."""
    out = {}
    for f in POINTS[name][4]:
        path = os.path.join(RESULTS, f)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            t = json.load(fh)
        rows = (t["points"].get(name, {}).get("per_image", [])
                if "points" in t else t["per_image"])
        out.update({r["image"]: dict(r, file=f"results/{f}") for r in rows})
    return out


def photo_sources() -> List[Tuple[str, str]]:
    """(name, path) of every photograph the installed packages ship (the
    list of ``scripts/rd_sweep.py``)."""
    cands = []
    try:
        import matplotlib
        mpl = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                           "sample_data")
        cands.append(("grace_hopper", os.path.join(mpl, "grace_hopper.jpg")))
    except ImportError:
        pass
    try:
        import sklearn
        skd = os.path.join(os.path.dirname(sklearn.__file__), "datasets",
                           "images")
        cands += [("sk_china", os.path.join(skd, "china.jpg")),
                  ("sk_flower", os.path.join(skd, "flower.jpg"))]
    except ImportError:
        pass
    try:
        os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
        import pygame
        pgd = os.path.join(os.path.dirname(pygame.__file__), "docs",
                           "generated", "_images")
        cands += [("pg_camera", os.path.join(pgd, "camera_rgb.jpg")),
                  ("pg_background", os.path.join(pgd,
                                                 "camera_background.jpg"))]
    except ImportError:
        pass
    return [(n, p) for n, p in cands if os.path.exists(p)]


def package_photos() -> Dict[str, np.ndarray]:
    """``{name: uint8 HWC}`` of the photographs the installed packages ship,
    each cropped to multiples of 64 from its top left corner (none without
    PIL)."""
    try:
        from PIL import Image
    except ImportError:
        return {}
    out = {}
    for name, path in photo_sources():
        img = np.asarray(Image.open(path).convert("RGB"))
        h, w, _ = img.shape
        out[name] = np.ascontiguousarray(img[:h - h % 64, :w - w % 64])
    return out


def heldout_images() -> Dict[str, np.ndarray]:
    """The held-out set as ``{name: uint8 HWC}``, names sorted as in
    ``rd_*.json``'s ``eval_set`` (without the ``.png``): the photographs
    from their packages, or else from :data:`PHOTOS_NPZ`."""
    n, size, seed = DEAD_LEAVES
    out = {f"natural_{seed}_{k:04d}": img for k, img in enumerate(
        data.synthetic_natural_images(n, size, seed=seed))}
    out.update(package_photos())
    if os.path.exists(PHOTOS_NPZ):
        with np.load(PHOTOS_NPZ) as committed:
            for name in committed.files:
                out.setdefault(name, committed[name])
    return dict(sorted(out.items()))


def write_photos(path: str = PHOTOS_NPZ) -> Dict[str, np.ndarray]:
    """Write the packages' crops of the photographs to ``path``
    (``np.savez_compressed``, uint8 HWC, one key a name)."""
    photos = package_photos()
    missing = {"grace_hopper", "sk_china", "sk_flower", "pg_camera",
               "pg_background"} - set(photos)
    if missing:
        raise RuntimeError(f"photographs {sorted(missing)} not found: "
                           "--write-photos needs matplotlib, scikit-learn, "
                           "pygame and PIL")
    np.savez_compressed(path, **photos)
    return photos


def point_config(name: str) -> config_mod.Config:
    cfg, _, lam, _, _ = POINTS[name]
    return config_mod.Config(**dict(cfg, lambda_=float(lam),
                                    dtype="float32")).validate()


def load_point(name: str, device=None) -> CodecCoder:
    """The coder of one point: its config and its snapshot's weights."""
    model = CodecWrapper(point_config(name))
    weights.load_flax_params(model, weights.load_npz(
        os.path.join(RESULTS, "ckpt_snapshots", POINTS[name][1])))
    return CodecCoder(model.cfg, model, device)


def _mean(rows, key):
    return float(np.mean([r[key] for r in rows]))


def code_point(name: str, images: Dict[str, np.ndarray], device) -> dict:
    coder = load_point(name, device)
    rows = []
    for img_name, img in images.items():
        t0 = time.perf_counter()
        res = coder.compress_decompress(img[None].astype(np.float32) / 255.0)
        rows.append({"image": img_name, "shape": list(img.shape[:2]),
                     "bpp": res.bpp, "psnr": res.psnr,
                     "bytes": sum(s.nbytes() for s in res.streams),
                     "seconds": time.perf_counter() - t0})
        print(json.dumps({"point": name, **rows[-1]}), flush=True)
    _, _, lam, rd_file, _ = POINTS[name]
    out = {"config": {k: v for k, v in point_config(name).__dict__.items()
                      if k in ("netType", "entropy_layer", "autoencoder",
                               "clrch", "dwtlevels", "split_mode",
                               "lif_prec_bits", "lambda_", "dtype")},
           "snapshot": f"results/ckpt_snapshots/{POINTS[name][1]}",
           "mean_bpp": _mean(rows, "bpp"), "mean_psnr": _mean(rows, "psnr"),
           "per_image": rows}
    with open(os.path.join(RESULTS, rd_file)) as fh:
        rd = json.load(fh)
    point = rd["points"][str(lam)]
    jax_rows = dict(zip([n[:-4] for n in sorted(rd["eval_set"])],
                        point["per_image"]))
    out["jax_point"] = {"file": f"results/{rd_file}", "bpp": point["bpp"],
                        "psnr": point["psnr"],
                        "images": len(point["per_image"])}
    same = [r for r in rows if r["image"] in jax_rows]
    out["gap_to_jax_point"] = {
        "images": len(same),
        "bpp_rel": _mean(same, "bpp") / float(np.mean(
            [jax_rows[r["image"]]["bpp"] for r in same])) - 1.0,
        "psnr_db": _mean(same, "psnr") - float(np.mean(
            [jax_rows[r["image"]]["psnr"] for r in same])),
        "max_image_bpp_rel": max(abs(r["bpp"] / jax_rows[r["image"]]["bpp"]
                                     - 1.0) for r in same),
        "max_image_psnr_db": max(abs(r["psnr"] - jax_rows[r["image"]]["psnr"])
                                 for r in same)}
    targets = jax_cpu_targets(name)
    for r in rows:
        t = targets.get(r["image"])
        if t is not None:
            r["jax_cpu_bpp_rel_gap"] = r["bpp"] / t["bpp"] - 1.0
            r["jax_cpu_psnr_gap_db"] = r["psnr"] - t["psnr"]
    gapped = [r for r in rows if "jax_cpu_bpp_rel_gap" in r]
    if gapped:
        out["gap_to_jax_cpu"] = {
            "files": sorted({targets[r["image"]]["file"] for r in gapped}),
            "images": len(gapped),
            "max_bpp_rel": max(abs(r["jax_cpu_bpp_rel_gap"])
                               for r in gapped),
            "max_psnr_db": max(abs(r["jax_cpu_psnr_gap_db"])
                               for r in gapped)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (cuda) when not given")
    ap.add_argument("--write-photos", action="store_true",
                    help="write results/heldout_photos.npz from the "
                         "packages' photographs and stop")
    args = ap.parse_args(argv)
    if args.write_photos:
        photos = write_photos()
        print(json.dumps({"wrote": os.path.relpath(PHOTOS_NPZ, _REPO),
                          "photos": {k: list(v.shape)
                                     for k, v in photos.items()}}))
        return 0
    device = str(config_mod.resolve_device(args.device))
    config_mod.full_fp32()
    images = heldout_images()
    missing = sorted({"grace_hopper", "sk_china", "sk_flower", "pg_camera",
                      "pg_background"} - set(images))
    result = {"what": "the port's real bitstream (CodecCoder."
                      "compress_decompress, fp32, one image at a time) over "
                      "the held-out set of scripts/rd_sweep.py",
              "command": "python -m imagecompressionlearnedliftingandlearned"
                         "treebasedmodels_torch.tools.rd_heldout --device "
                         + device,
              "device": device, "torch": torch.__version__,
              "threads": torch.get_num_threads(),
              "images": list(images), "photos_missing": missing,
              "points": {}}
    for name in POINTS:
        result["points"][name] = code_point(name, images, device)
    with open(OUT, "w") as fh:
        json.dump(result, fh, indent=1)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
