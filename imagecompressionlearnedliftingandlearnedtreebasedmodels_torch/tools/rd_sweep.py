"""Multi-lambda rate-distortion sweep with real-bitstream evaluation.

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.rd_sweep --preset flagship --lambdas 400,2000 --steps 8000
    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.rd_sweep --preset cdf97 --lambdas 50,400,2000 --steps 4000 --device cpu

For each lambda it trains the preset's codec (bf16, B=8 patches of 64x64,
500 steps an epoch; ``--steps`` rounds down to whole epochs, one at
least), saves a checkpoint and a params snapshot, codes every held-out
image through the real bitstream, and rewrites
``<root>/results/port_rd_<preset>.json`` (the fields of the JAX package's
``results/rd_<preset>.json``) after every lambda, so an interrupted sweep
keeps what it finished. ``--resume`` continues each lambda from its
checkpoint; ``--retest-only`` codes the held-out set again from the
checkpoint, or else from the snapshot: the port's where there is one,
the committed ``results/ckpt_snapshots/<preset>_lam<lambda>.npz``
otherwise.

- Training corpus: ``synthetic_natural_images(1600, 256, seed=0)``, the
  pixels the JAX package's sweep writes as PNGs, held in memory (no image
  file is read or written, so neither PIL nor matplotlib is needed).
- Held-out set: the 24 images of ``tools/rd_heldout.py::heldout_images``
  (``eval_set`` lists them as ``<name>.png``).
- Anchors: JPEG and JPEG2000 with PIL on the same images, as the JAX
  package's sweep makes them; without PIL they are taken from the
  committed ``results/rd_<preset>.json`` when its ``eval_set`` is this
  one, and left out otherwise (``anchor_source`` says which). BD-rates
  against them once three points stand on this eval set.
- Snapshots: ``<root>/results/ckpt_snapshots/port_<preset>_lam<lambda>.npz``
  in the JAX package's layout (flax keystrs, float leaves as f16, an
  ``__iteration__`` entry), so either package loads the other's.
  Checkpoints and logs go to ``<root>/experiments/rd_sweep/port_<preset>/``.
  Nothing here overwrites a committed file of the JAX package.

It runs on the card unless ``--device cpu`` asks for the CPU, and never
falls back to the CPU on its own. ``--root`` defaults to the repository.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import config as config_mod
from ..train import data
from ..train.loop import LiftingDWTAgent
from . import rd_heldout, rd_plot, weights

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMMITTED = os.path.join(REPO, "results")   # the JAX package's sweep results
PRESETS = ("cdf97", "flagship", "quincunx")
CORPUS = (1600, 256, 0)          # synthetic_natural_images(n, size, seed)
STEPS_PER_EPOCH = 500
JPEG_QUALITIES = (5, 10, 15, 20, 30, 40, 50, 60, 70, 80, 90, 95)
JPEG2000_RATES = (160, 96, 64, 48, 32, 24, 16, 12, 8, 6, 4, 3)
BD_FIELDS = (("jpeg_anchor", "bd_rate_vs_jpeg_pct"),
             ("jpeg2000_anchor", "bd_rate_vs_jpeg2000_pct"))


# --- anchors -----------------------------------------------------------------

def _anchor_points(images: Sequence[np.ndarray], encode) -> Tuple[float, float]:
    """(bpp, psnr) averaged over ``images`` (uint8 HWC) for one setting of
    a PIL codec; ``encode(img) -> (nbytes, decoded)``."""
    bpps, psnrs = [], []
    for img in images:
        nbytes, dec = encode(img)
        h, w, _ = img.shape
        bpps.append(nbytes * 8.0 / (h * w))
        mse = np.mean((img.astype(np.float64) / 255
                       - dec.astype(np.float64) / 255) ** 2)
        psnrs.append(-10 * np.log10(max(mse, 1e-12)))
    return float(np.mean(bpps)), float(np.mean(psnrs))


def _pil_codec(fmt: str, **save_kw):
    from PIL import Image

    def enc(img):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt, **save_kw)
        return len(buf.getvalue()), np.asarray(Image.open(buf).convert("RGB"))
    return enc


def jpeg_anchor(images: Sequence[np.ndarray]) -> List[Tuple[float, float]]:
    """(bpp, psnr) over the images at each JPEG quality (needs PIL)."""
    return [_anchor_points(images, _pil_codec("JPEG", quality=q))
            for q in JPEG_QUALITIES]


def jpeg2000_anchor(images: Sequence[np.ndarray]
                    ) -> Optional[List[Tuple[float, float]]]:
    """(bpp, psnr) at each JPEG2000 compression ratio through PIL's
    OpenJPEG binding (the irreversible 9/7 path); None where PIL was built
    without it."""
    from PIL import features

    if not features.check("jpg_2000"):
        return None
    return [_anchor_points(images, _pil_codec(
        "JPEG2000", quality_mode="rates", quality_layers=[r],
        irreversible=True)) for r in JPEG2000_RATES]


def anchors(preset: str, images: Dict[str, np.ndarray]) -> Tuple[dict, str]:
    """The JPEG and JPEG2000 anchors of the eval set ``images`` and where
    they come from: PIL on these images, or else the committed
    ``results/rd_<preset>.json`` when its ``eval_set`` is this one, or else
    none (the reason in the returned source)."""
    try:
        import PIL
    except ImportError:
        PIL = None
    if PIL is not None:
        imgs = list(images.values())
        return ({"jpeg_anchor": jpeg_anchor(imgs),
                 "jpeg2000_anchor": jpeg2000_anchor(imgs)},
                f"PIL {PIL.__version__} on this eval set")
    name = f"rd_{preset}.json"
    path = os.path.join(COMMITTED, name)
    if os.path.exists(path):
        with open(path) as fh:
            committed = json.load(fh)
        if committed.get("eval_set") == eval_set(images):
            return ({k: committed.get(k) for k, _ in BD_FIELDS},
                    f"results/{name} (PIL is missing here; the same "
                    "eval_set)")
        return {}, (f"none: PIL is missing here and results/{name}'s "
                    "eval_set is not this one")
    return {}, f"none: PIL is missing here and there is no results/{name}"


def eval_set(images: Dict[str, np.ndarray]) -> List[str]:
    return sorted(f"{name}.png" for name in images)


def refresh_bd_rates(results: dict) -> None:
    """The BD-rate fields from the points that are not stale, against each
    anchor that is present, once there are three such points."""
    pts = sorted((v["bpp"], v["psnr"]) for v in results["points"].values()
                 if not v.get("stale_eval_set"))
    if len(pts) < 3:
        return
    for anchor, field in BD_FIELDS:
        if not results.get(anchor):
            continue
        ref = sorted(results[anchor])
        results[field] = rd_plot.bd_rate(
            [p[0] for p in ref], [p[1] for p in ref],
            [p[0] for p in pts], [p[1] for p in pts])


# --- configs, snapshots, the agent --------------------------------------------

def make_cfg(preset: str, lam: float, steps: int, train_dir: str,
             eval_dir: str, root: str) -> config_mod.Config:
    """The preset's config at ``lam`` (the JAX package's sweep's, but for
    the experiment directory, ``experiments/rd_sweep/port_<preset>/``).
    Its ``steps_per_call`` of 10 trains in chunks of 10 steps: one CUDA
    graph replay a chunk on a card (``train/state.py::GraphChain``)."""
    exp = os.path.join(root, "experiments", "rd_sweep", f"port_{preset}",
                       f"lam_{lam:g}")
    common = dict(
        lambda_=lam, learning_rate=1e-4, batch_size=8, patch_size=64,
        steps_per_epoch=STEPS_PER_EPOCH,
        max_epoch=max(1, steps // STEPS_PER_EPOCH),
        validate_every=10 ** 9,  # no mid-run validation; test at the end
        save_every_epochs=5, loss_prnt_iters=250, training_loss_switch=1,
        steps_per_call=10, train_data_1=train_dir, test_data=eval_dir,
        valid_data=eval_dir, test_patch_size=0, val_patch_size=256,
        dtype="bfloat16")
    if preset == "flagship":
        cfg = config_mod.flagship_config(**common)
    elif preset == "cdf97":
        cfg = config_mod.Config(netType="CDF97", entropy_layer="factorized",
                                autoencoder="SubbandAutoEncoder", clrch=3,
                                dwtlevels=4, **common).validate()
    elif preset == "quincunx":
        # integer lifting: the quincunx split with the 8-bit eval-time grid;
        # the pointwise AEs scale the details above the quantization bin
        cfg = config_mod.Config(netType="QuincunxLifting",
                                entropy_layer="factorized",
                                autoencoder="SubbandAutoEncoder", clrch=3,
                                dwtlevels=3, split_mode="hv", lif_prec_bits=8,
                                **common).validate()
    else:
        raise ValueError(preset)
    cfg.checkpoint_dir = os.path.join(exp, "checkpoints")
    cfg.log_dir = os.path.join(exp, "logs")
    cfg.summary_dir = os.path.join(exp, "summaries")
    for d in (cfg.checkpoint_dir, cfg.log_dir, cfg.summary_dir):
        os.makedirs(d, exist_ok=True)
    return cfg


def snapshot_path(preset: str, lam: float, root: str, port: bool = True
                  ) -> str:
    """The port's snapshot under ``root``, or (``port=False``) the JAX
    package's committed one."""
    if port:
        return os.path.join(root, "results", "ckpt_snapshots",
                            f"port_{preset}_lam{lam:g}.npz")
    return os.path.join(COMMITTED, "ckpt_snapshots", f"{preset}_lam{lam:g}.npz")


def save_params_snapshot(preset: str, lam: float, agent, root: str) -> str:
    """Write the agent's parameters as the JAX package's sweep writes its
    snapshots: flax keystrs in the flax tree's order, float leaves as f16,
    the iteration as ``__iteration__``; through a temporary file and
    ``os.replace``, so a reader never sees half a file."""
    flat = weights.flax_params_from_state_dict(agent.model.state_dict())
    arrs = {k: (v.astype(np.float16) if np.issubdtype(v.dtype, np.floating)
                else v) for k, v in sorted(flat.items())}
    arrs["__iteration__"] = np.asarray(int(agent.current_iteration))
    out = snapshot_path(preset, lam, root)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrs)
    os.replace(tmp, out)
    return out


def load_params_snapshot(preset: str, lam: float, agent, root: str) -> int:
    """Load the port's snapshot of the point, or else the committed one,
    into the agent's model (every parameter, strictly) and set its
    iteration. Returns that iteration, or 0 when neither file exists."""
    for port in (True, False):
        path = snapshot_path(preset, lam, root, port)
        if os.path.exists(path):
            break
    else:
        return 0
    weights.load_flax_params(agent.model, weights.load_npz(path))
    with np.load(path) as snap:
        agent.current_iteration = int(snap["__iteration__"])
    return agent.current_iteration


class _ArrayLoader(data.ImageDataLoader):
    """The agent's loader over images held in memory: training patches
    drawn from ``train_images`` as the loader draws them from a sorted
    directory of those images, validation and test from ``eval_images``
    (uint8 HWC), cropped as the loader crops files."""

    def __init__(self, cfg, train_images: Sequence[np.ndarray],
                 eval_images: Sequence[np.ndarray]):
        super().__init__(cfg, synthetic_fallback=False)
        self._train_images = train_images
        self._eval_images = list(eval_images)

    def _draw_train_image(self, rng) -> np.ndarray:
        return self._train_images[rng.randint(len(self._train_images))]

    def _eval_batches(self, files, patch):
        for img in self._eval_images:
            yield data._center_crop(img, patch)[None].astype(np.float32) \
                / 255.0


def sweep_agent(cfg, train_images: Sequence[np.ndarray],
                eval_images: Dict[str, np.ndarray], device=None
                ) -> LiftingDWTAgent:
    """The port's agent of ``cfg`` on ``device`` (the card unless named),
    its data the arrays given (``train_images`` may be empty where it does
    not train)."""
    agent = LiftingDWTAgent(cfg, device=device)
    agent.data = _ArrayLoader(cfg, train_images, eval_images.values())
    return agent


def _write_atomic_json(obj, path: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".json")
    with os.fdopen(fd, "w") as fh:
        json.dump(obj, fh, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, required=True)
    ap.add_argument("--lambdas", type=str, required=True)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--resume", action="store_true",
                    help="continue each lambda from its saved checkpoint "
                         "(trains up to --steps total iterations)")
    ap.add_argument("--retest-only", action="store_true",
                    help="skip training: restore each lambda's checkpoint "
                         "or snapshot and code the held-out set again")
    ap.add_argument("--root", default=REPO,
                    help="where results/ and experiments/ are written "
                         "(default: the repository)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (cuda) when not given")
    args = ap.parse_args(argv)

    device = str(config_mod.resolve_device(args.device))
    images = rd_heldout.heldout_images()
    os.makedirs(os.path.join(args.root, "results"), exist_ok=True)
    out_path = os.path.join(args.root, "results",
                            f"port_rd_{args.preset}.json")
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as fh:
            results = json.load(fh)

    # anchors and points of another eval set are not comparable: anchors
    # are made again, points are stale until re-tested
    cur_eval = eval_set(images)
    if results.get("eval_set") != cur_eval:
        for k, _ in BD_FIELDS:
            results.pop(k, None)
        for v in results.get("points", {}).values():
            v["stale_eval_set"] = True
    if any(k not in results for k, _ in BD_FIELDS):
        found, results["anchor_source"] = anchors(args.preset, images)
        for k, v in found.items():
            results.setdefault(k, v)
    results.setdefault("points", {})
    results["eval_set"] = cur_eval
    results["steps"] = args.steps
    results["device"] = device

    corpus: Sequence[np.ndarray] = []
    if not args.retest_only:       # ~45 ms an image on one host core
        corpus = data.synthetic_natural_images(*CORPUS)
    for lam in (float(v) for v in args.lambdas.split(",")):
        t0 = time.time()
        cfg = make_cfg(args.preset, lam, args.steps, "", "", args.root)
        cfg.resume_training = bool(args.resume or args.retest_only)
        agent = sweep_agent(cfg, corpus, images, device)
        if args.retest_only:
            if agent.current_iteration == 0:
                if load_params_snapshot(args.preset, lam, agent, args.root):
                    print(f"lambda={lam:g}: restored from params snapshot "
                          f"(it={agent.current_iteration})")
                else:
                    print(f"lambda={lam:g}: no checkpoint: skipping retest")
                    continue
        else:
            agent.run()
            agent.save_checkpoint(is_best=True)
            save_params_snapshot(args.preset, lam, agent, args.root)
        psnr, bpp = agent.test()         # the real bitstream, both ways
        results["points"][f"{lam:g}"] = {
            "bpp": bpp, "psnr": psnr,
            "iterations": int(agent.current_iteration),
            "per_image": agent.last_test_per_image,
            "train_minutes": round((time.time() - t0) / 60, 1)}
        refresh_bd_rates(results)
        _write_atomic_json(results, out_path)
        print(f"lambda={lam:g}: {bpp:.4f} bpp @ {psnr:.2f} dB "
              f"({results['points'][f'{lam:g}']['train_minutes']} min)")
        for _, field in BD_FIELDS:
            if field in results:
                print(f"  {field}: {results[field]:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
