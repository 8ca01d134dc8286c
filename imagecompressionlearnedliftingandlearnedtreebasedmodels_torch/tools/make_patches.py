"""Offline dataset patch pre-cropping: random-crop N patches from every
source image into one flat training directory (needs PIL).

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.make_patches SRC_DIR DST_DIR
"""

from __future__ import annotations

import os
import sys

import numpy as np


def save_patches_from_imgs(src_dir: str, dst_dir: str,
                           patches_per_image: int = 8, patch: int = 256,
                           seed: int = 0) -> int:
    """Write ``patches_per_image`` random ``patch`` x ``patch`` crops of
    every image of ``src_dir`` (sorted by name, one seeded generator) as
    ``<stem>_p<k>.png``; returns how many."""
    from PIL import Image

    from ..train.data import IMG_EXTS, _load_rgb, _random_patch

    os.makedirs(dst_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    count = 0
    for name in sorted(os.listdir(src_dir)):
        if not name.lower().endswith(IMG_EXTS):
            continue
        img = _load_rgb(os.path.join(src_dir, name))
        stem = os.path.splitext(name)[0]
        for k in range(patches_per_image):
            crop = _random_patch(img, patch, rng)
            Image.fromarray(crop).save(
                os.path.join(dst_dir, f"{stem}_p{k:03d}.png"))
            count += 1
    return count


if __name__ == "__main__":
    n = save_patches_from_imgs(sys.argv[1], sys.argv[2])
    print(f"wrote {n} patches")
