"""Reconstruction comparison montage: one image's reconstructions across
rate points in a labelled grid, each with its PSNR and bpp (needs PIL).

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.figure_montage IMAGE CONFIG [CONFIG ...]

codes ``IMAGE`` with the ``model_best`` checkpoint of each experiment
config through the real bitstream, on the card.
"""

from __future__ import annotations

import sys
from typing import List, Sequence

import numpy as np


def montage(images: Sequence[np.ndarray], labels: Sequence[str],
            cols: int = 3, out_path: str = "montage.png") -> str:
    """Arrange HWC [0, 1] images in a labelled grid and save it."""
    from PIL import Image, ImageDraw

    assert len(images) == len(labels)
    h, w = images[0].shape[:2]
    rows = (len(images) + cols - 1) // cols
    pad = 24
    canvas = Image.new("RGB", (cols * w, rows * (h + pad)), "white")
    draw = ImageDraw.Draw(canvas)
    for i, (img, label) in enumerate(zip(images, labels)):
        r, c = divmod(i, cols)
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        canvas.paste(Image.fromarray(arr), (c * w, r * (h + pad) + pad))
        draw.text((c * w + 4, r * (h + pad) + 4), label, fill="black")
    canvas.save(out_path)
    return out_path


def codec_rate_sweep_montage(cfg_paths: List[str], image_path: str,
                             out_path: str = "montage.png",
                             device=None) -> str:
    """Code one image with the trained codec of each experiment config
    (its ``model_best``) and montage the original with the
    reconstructions, labelled with PSNR and bpp. ``device``: the card
    unless the caller names another."""
    from ..coding.codec_coder import CodecCoder
    from ..config import process_config
    from ..train.data import _load_rgb
    from ..train.loop import LiftingDWTAgent

    img = _load_rgb(image_path).astype(np.float32) / 255.0
    h, w = img.shape[:2]
    img = img[: h - h % 64 or h, : w - w % 64 or w][None]
    images = [img[0]]
    labels = ["original"]
    for path in cfg_paths:
        cfg = process_config(path)
        cfg.mode = "test"
        agent = LiftingDWTAgent(cfg, device=device)
        res = CodecCoder(cfg, agent.model, agent.device).compress_decompress(
            img)
        images.append(res.xhat[0])
        labels.append(f"{res.psnr:.2f} dB @ {res.bpp:.3f} bpp")
    return montage(images, labels, out_path=out_path)


if __name__ == "__main__":
    print(codec_rate_sweep_montage(sys.argv[2:], sys.argv[1]))
