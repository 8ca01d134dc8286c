"""Image data pipeline (numpy and PIL only; the port's own copy of the JAX
package's ``train/data.py``, so the same seed gives the same batches).

Lists png/jpg files from up to ``num_train_dirs`` directories, random-crops
training patches (upscaling undersized images), center-crops validation
patches, and yields NHWC float32 numpy batches in [0, 1] with
background-thread prefetch. With no data directory a seeded synthetic
dataset stands in, so training and tests run with nothing on disk.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..config import Config

IMG_EXTS = (".png", ".jpg", ".jpeg")


def list_images(dirs: Sequence[str]) -> List[str]:
    files: List[str] = []
    for d in dirs:
        if d and os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if name.lower().endswith(IMG_EXTS):
                    files.append(os.path.join(d, name))
    return files


def _load_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _random_patch(img: np.ndarray, patch: int, rng: np.random.RandomState):
    h, w, _ = img.shape
    if h < patch or w < patch:
        from PIL import Image
        im = Image.fromarray(img)
        scale = max(patch / h, patch / w)
        im = im.resize((max(patch, int(w * scale + 0.5)),
                        max(patch, int(h * scale + 0.5))))
        img = np.asarray(im)
        h, w, _ = img.shape
    i = rng.randint(0, h - patch + 1)
    j = rng.randint(0, w - patch + 1)
    return img[i:i + patch, j:j + patch]


def _center_crop(img: np.ndarray, patch: int) -> np.ndarray:
    if patch <= 0:
        # full image, cropped so that H and W divide by 64
        h, w, _ = img.shape
        return img[: h - h % 64 if h % 64 else h, : w - w % 64 if w % 64 else w]
    h, w, _ = img.shape
    i, j = max(0, (h - patch) // 2), max(0, (w - patch) // 2)
    out = img[i:i + patch, j:j + patch]
    if out.shape[0] < patch or out.shape[1] < patch:
        out = np.pad(out, ((0, patch - out.shape[0]),
                           (0, patch - out.shape[1]), (0, 0)), mode="edge")
    return out


def synthetic_images(n: int, size: int, seed: int = 0) -> List[np.ndarray]:
    """Deterministic gradient+sinusoid+noise images (uint8 RGB)."""
    rng = np.random.RandomState(seed)
    imgs = []
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for k in range(n):
        f1, f2 = rng.uniform(2, 12, 2)
        phase = rng.uniform(0, np.pi * 2, 3)
        base = np.stack([
            0.5 + 0.4 * np.sin(2 * np.pi * f1 * yy + phase[c])
            * np.cos(2 * np.pi * f2 * xx)
            + 0.1 * (yy + xx) for c in range(3)], axis=-1)
        base += rng.normal(0, 0.02, base.shape)
        imgs.append((np.clip(base, 0, 1) * 255).astype(np.uint8))
    return imgs


def synthetic_natural_images(n: int, size: int, seed: int = 0
                             ) -> List[np.ndarray]:
    """Dead-leaves + 1/f-noise images (uint8 RGB, ``size`` x ``size``).

    The dead-leaves model (occluding disks with power-law radii) reproduces
    the scale-invariant edge/region statistics of natural images; low-octave
    1/f noise adds smooth illumination structure.
    """
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


def write_corpus(out_dir: str, n: int, size: int, seed: int = 0,
                 kind: str = "natural") -> List[str]:
    """Materialize a synthetic corpus as PNGs (idempotent)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    gen = (synthetic_natural_images if kind == "natural"
           else synthetic_images)
    want = [os.path.join(out_dir, f"{kind}_{seed}_{i:04d}.png")
            for i in range(n)]
    if all(os.path.exists(p) for p in want):
        return want
    for p, img in zip(want, gen(n, size, seed)):
        Image.fromarray(img).save(p)
    return want


class ImageDataLoader:
    """Train/valid/test loaders (valid and test read ``valid_data`` /
    ``test_data`` at batch 1)."""

    # decoded-image cache: patch sampling decodes the same files again and
    # again. Bounded by bytes so a corpus of large images cannot exhaust RAM.
    _CACHE_BYTES = 512 * 1024 * 1024

    def __init__(self, cfg: Config, synthetic_fallback: bool = True):
        self.cfg = cfg
        train_dirs = [getattr(cfg, f"train_data_{i + 1}")
                      for i in range(cfg.num_train_dirs)]
        self.train_files = list_images(train_dirs)
        self.valid_files = list_images([cfg.valid_data])
        self.test_files = list_images([cfg.test_data])
        self._img_cache: dict = {}
        self._img_cache_bytes = 0
        self._synth: Optional[List[np.ndarray]] = None
        if synthetic_fallback and not self.train_files:
            self._synth = synthetic_images(
                32, max(cfg.patch_size, 64), seed=cfg.seed)

    # --- train ----------------------------------------------------------
    def train_batches(self, steps: int, seed: int = 0, chunk: int = 1
                      ) -> Iterator[np.ndarray]:
        """``steps`` random-patch batches ``(B, P, P, 3)`` float32 in [0, 1],
        prefetched on a worker thread.

        ``chunk > 1`` yields ``steps / chunk`` stacked uint8 arrays
        ``(chunk, B, P, P, 3)`` for the ``steps_per_call`` chained train step
        (``train/state.py::make_chained_train_step``, which turns them into
        floats on the device, bit for bit as here). The patches are drawn in
        the same order either way, so the per-step batches are the same."""
        cfg = self.cfg
        if chunk > 1 and steps % chunk:
            raise ValueError(f"steps ({steps}) not divisible by chunk "
                             f"({chunk})")

        def produce(q: "queue.Queue"):
            rng = np.random.RandomState(cfg.seed + seed)
            for _ in range(steps // chunk):
                arr = np.empty((chunk, cfg.batch_size, cfg.patch_size,
                                cfg.patch_size, 3), np.uint8)
                for c in range(chunk):
                    for b in range(cfg.batch_size):
                        img = self._draw_train_image(rng)
                        arr[c, b] = _random_patch(img, cfg.patch_size, rng)
                q.put(arr if chunk > 1
                      else arr[0].astype(np.float32) / 255.0)
            q.put(None)

        q: "queue.Queue" = queue.Queue(maxsize=4)
        threading.Thread(target=produce, args=(q,), daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    def _draw_train_image(self, rng) -> np.ndarray:
        if self.train_files:
            path = self.train_files[rng.randint(len(self.train_files))]
            img = self._img_cache.get(path)
            if img is None:
                img = _load_rgb(path)
                if self._img_cache_bytes + img.nbytes <= self._CACHE_BYTES:
                    self._img_cache[path] = img
                    self._img_cache_bytes += img.nbytes
            return img
        if self._synth is None:
            raise RuntimeError("no training data and no synthetic fallback")
        return self._synth[rng.randint(len(self._synth))]

    # --- eval -----------------------------------------------------------
    def _eval_batches(self, files: List[str], patch: int
                      ) -> Iterator[np.ndarray]:
        if files:
            for path in files:
                img = _center_crop(_load_rgb(path), patch)
                yield img[None].astype(np.float32) / 255.0
        else:
            size = patch if patch > 0 else 256
            for img in (self._synth or synthetic_images(4, size)):
                yield _center_crop(img, patch)[None].astype(np.float32) / 255.0

    def valid_batches(self):
        return self._eval_batches(self.valid_files, self.cfg.val_patch_size)

    def test_batches(self):
        return self._eval_batches(self.test_files, self.cfg.test_patch_size)

    def steps_per_epoch(self) -> int:
        if self.cfg.steps_per_epoch > 0:
            return self.cfg.steps_per_epoch
        n = len(self.train_files) or len(self._synth or [])
        return max(1, n // self.cfg.batch_size)
