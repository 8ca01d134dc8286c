"""The one traffic generator: it reads a cell's ``traffic`` parameters and
its seed, and nothing else.

A pool of ``pool`` dead-leaves images of ``pool_size``^2 is made on the
host at set-up, and requests are drawn from it:

- ``kind: "eval_batches"``: ``batch`` images, each a random pool image cut
  to ``rows`` x ``cols`` at a random offset, flipped left-right with
  probability 1/2; float32 NCHW RGB in [0, 1] on the host (uint8 / 255 in
  IEEE float32, as the program's loader converts). ``EVAL_RING`` such
  batches are drawn at set-up and handed in turn, so that drawing them
  takes no host time inside the window (the program keeps nothing from
  one batch to the next).
- ``kind: "train_chunks"``: each request a fresh draw of
  ``steps_per_call`` batches of ``batch`` random ``patch`` x ``patch``
  crops, flipped alike; uint8 ``(k, B, P, P, 3)``, the chunk form the
  chained train step takes.

Every seed gives the same sizes and the same number of requests a second;
only the pixels differ.
"""

from __future__ import annotations

import numpy as np

from .deadleaves import dead_leaves

EVAL_RING = 8       # eval batches drawn at set-up and handed in turn

# independent streams drawn from one seed
STREAMS = {"weights": 0, "pool": 1, "draws": 2, "noise": 3, "sample": 4}


def stream_seed(seed: int, stream: str, bits: int = 32) -> int:
    """A seed for one purpose, derived from the run's ``--seed`` (any whole
    number)."""
    words = np.random.SeedSequence([abs(int(seed)), int(seed < 0),
                                    STREAMS[stream]]).generate_state(2)
    value = (int(words[0]) << 32) | int(words[1])
    return value % (1 << bits) if bits < 64 else value


def make_pool(params: dict, seed: int) -> np.ndarray:
    imgs = dead_leaves(params["pool"], params["pool_size"],
                       stream_seed(seed, "pool"))
    return np.stack(imgs)


class Traffic:
    """``next()`` gives the next request of the cell's mix."""

    def __init__(self, params: dict, seed: int):
        self.p = dict(params)
        self.pool = make_pool(self.p, seed)
        if self.p["kind"] == "eval_batches":
            # converted once: a batch is then one copy of its crops
            self.pool = np.ascontiguousarray(self.pool.transpose(
                0, 3, 1, 2), dtype=np.float32) / np.float32(255)
        self.rng = np.random.RandomState(stream_seed(seed, "draws"))
        kind = self.p["kind"]
        if kind not in ("eval_batches", "train_chunks"):
            raise ValueError(f"unknown traffic kind {kind!r}")
        self.kind = kind
        self.ring, self.turn = None, 0
        if kind == "eval_batches":
            self.ring = [self._draw() for _ in range(EVAL_RING)]

    def _crop(self, rows: int, cols: int, nchw: bool) -> np.ndarray:
        img = self.pool[self.rng.randint(len(self.pool))]
        h, w = img.shape[1:3] if nchw else img.shape[:2]
        i = self.rng.randint(0, h - rows + 1)
        j = self.rng.randint(0, w - cols + 1)
        if nchw:
            out = img[:, i:i + rows, j:j + cols]
            return out[:, :, ::-1] if self.rng.randint(2) else out
        out = img[i:i + rows, j:j + cols]
        return out[:, ::-1] if self.rng.randint(2) else out

    def _draw(self) -> np.ndarray:
        p = self.p
        return np.stack([self._crop(p["rows"], p["cols"], True)
                         for _ in range(p["batch"])])

    def next(self) -> np.ndarray:
        p = self.p
        if self.ring is not None:
            self.turn += 1
            return self.ring[(self.turn - 1) % len(self.ring)]
        k, b, s = p["steps_per_call"], p["batch"], p["patch"]
        return np.stack([np.stack([self._crop(s, s, False) for _ in range(b)])
                         for _ in range(k)])

    def pixels(self) -> int:
        """Pixels a request carries (per image plane)."""
        p = self.p
        if self.kind == "eval_batches":
            return p["batch"] * p["rows"] * p["cols"]
        return p["steps_per_call"] * p["batch"] * p["patch"] ** 2
