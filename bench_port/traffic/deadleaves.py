"""Dead-leaves + 1/f-noise images: the benchmark's frozen stand-in for
photographs (a copy of the program's ``synthetic_natural_images``, kept
here so that no change to the program changes the traffic).

The dead-leaves model (occluding disks with power-law radii) reproduces the
scale-invariant edge and region statistics of natural images; low-octave
1/f noise adds smooth illumination structure. The same seed gives the same
bytes.
"""

from __future__ import annotations

from typing import List

import numpy as np


def dead_leaves(n: int, size: int, seed: int = 0) -> List[np.ndarray]:
    """``n`` uint8 RGB images of ``size`` x ``size``."""
    rng = np.random.RandomState(seed)
    imgs = []
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(n):
        img = np.empty((size, size, 3), np.float32)
        img[:] = rng.uniform(0.2, 0.8, 3)[None, None]
        # power-law radii: p(r) ~ r^-3 on [rmin, rmax]
        rmin, rmax = 4.0, size / 2.0
        n_disks = 220
        u = rng.uniform(0, 1, n_disks)
        radii = rmin * (1 - u * (1 - (rmin / rmax) ** 2)) ** -0.5
        for r in radii:
            cy, cx = rng.uniform(0, size, 2)
            color = rng.uniform(0, 1, 3)
            y0, y1 = max(0, int(cy - r)), min(size, int(cy + r) + 1)
            x0, x1 = max(0, int(cx - r)), min(size, int(cx + r) + 1)
            if y0 >= y1 or x0 >= x1:
                continue
            mask = ((yy[y0:y1, x0:x1] - cy) ** 2
                    + (xx[y0:y1, x0:x1] - cx) ** 2) <= r * r
            # slight per-disk gradient so regions aren't flat
            grad = (yy[y0:y1, x0:x1] - cy) / (2.5 * r)
            for c in range(3):
                region = img[y0:y1, x0:x1, c]
                region[mask] = np.clip(color[c] + grad[mask] * 0.15, 0, 1)
        # 1/f noise per channel (shared spectrum shape, independent phases)
        f = np.fft.fftfreq(size)
        rad = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
        rad[0, 0] = 1.0
        for c in range(3):
            spec = (rng.normal(size=(size, size))
                    + 1j * rng.normal(size=(size, size))) / rad
            noise = np.real(np.fft.ifft2(spec))
            noise *= 0.06 / (noise.std() + 1e-8)
            img[..., c] = np.clip(img[..., c] + noise, 0, 1)
        imgs.append((img * 255).astype(np.uint8))
    return imgs
