"""Tiled bitstream coding of a high-resolution image.

Counterpart of the JAX package's ``coding/tiled_coder.py``: the image is
split along H into tiles with a reconstruction margin
(``parallel/tiling.py``), every tile is coded as independent streams (every
entropy model), and the decoder stitches the tiles' interiors. The cost is
the margin's re-encode and the context lost across tiles; the gain is that
tiles decode independently and the wavefront's sequential span is one
tile's height.

Each tile's planes go through the port's :class:`CodecCoder`
(``compress_plane`` / ``decompress_plane``: the transforms on the device,
the entropy coding in host C++), with its colour policy
(``CodecCoder.planes`` / ``rgb``). Tiles run on a pool
of threads (``parallel=True``, as in the JAX package) or one after another;
both give the same bytes, and the pool is the faster on the H100's host
(the C++ walkers release the GIL; ``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config
from ..parallel.tiling import TileMeta, reconstruction_margin, tile_image
from .codec_coder import CodecCoder, CodecResult, PlaneStreams


@dataclasses.dataclass
class TiledStreams:
    """One tiled image: per tile, per plane byte streams."""
    meta: TileMeta
    tiles: List[List[PlaneStreams]]
    xe_shape: Tuple[int, ...]
    xo_shapes: List[Tuple[int, ...]]

    def nbytes(self) -> int:
        return sum(p.nbytes() for t in self.tiles for p in t)


class TiledCodecCoder:
    """Per-tile compress and decompress around one :class:`CodecCoder`
    (``device``: the card unless the caller names another).
    ``last_tile_timing`` holds, per tile of the last ``compress``, the host
    clock's milliseconds of the transforms on the
    device (``analysis_ms``, ``synthesis_ms``: each ends in the copy of its
    result to the host) and of the host's entropy coding
    (``encode_host_ms``, ``decode_host_ms``), summed over the planes."""

    def __init__(self, cfg: Config, model, n_tiles: int,
                 parallel: bool = True, device=None):
        self.cfg = cfg
        self.coder = CodecCoder(cfg, model, device)
        self.n_tiles = n_tiles
        self.parallel = parallel
        self.last_tile_timing: List[Dict[str, float]] = []

    # -- one tile ----------------------------------------------------------
    def _code_tile(self, tile: np.ndarray):
        timing = dict.fromkeys(("analysis_ms", "encode_host_ms",
                                "decode_host_ms", "synthesis_ms"), 0.0)
        streams, yhats, shapes = [], [], None

        def timed(key, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            timing[key] += (time.perf_counter() - t0) * 1e3
            return out

        for p, y in enumerate(self.coder.planes(tile[None])):
            xe, xo_list = timed("analysis_ms", self.coder.analysis, p, y)
            ps, _, xe_hat, xo_hats = timed(
                "encode_host_ms", self.coder._compress_entropy, p, xe,
                xo_list)
            shapes = (xe_hat.shape, [t.shape for t in xo_hats])
            dxe, dxo = timed("decode_host_ms", self.coder._decompress_entropy,
                             p, ps, *shapes)
            streams.append(ps)
            yhats.append(timed("synthesis_ms", self.coder.synthesis, p, dxe,
                               dxo))
        return streams, self.coder.rgb(yhats)[0], shapes, timing

    def _decode_tile(self, streams: List[PlaneStreams], xe_shape, xo_shapes):
        yhats = [self.coder.decompress_plane(p, ps, xe_shape, xo_shapes)
                 for p, ps in enumerate(streams)]
        return self.coder.rgb(yhats)[0]

    def _map_tiles(self, fn, items):
        if self.parallel and len(items) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(items))) as pool:
                return list(pool.map(fn, items))
        return [fn(it) for it in items]

    # -- public API --------------------------------------------------------
    def compress(self, x: np.ndarray) -> Tuple[TiledStreams, np.ndarray]:
        """NHWC ``(1, H, W, 3)`` RGB in [0, 1] -> (streams, the encoder's
        stitched reconstruction). H must divide into ``n_tiles``."""
        tiles, meta = tile_image(np.asarray(x, np.float32), self.n_tiles,
                                 reconstruction_margin(self.cfg))
        results = self._map_tiles(self._code_tile, list(tiles))
        self.last_tile_timing = [r[3] for r in results]
        xe_shape, xo_shapes = results[0][2]
        xhat = self._stitch([r[1] for r in results], meta)
        return (TiledStreams(meta, [r[0] for r in results], xe_shape,
                             xo_shapes), xhat)

    def decompress(self, ts: TiledStreams) -> np.ndarray:
        tiles = self._map_tiles(
            lambda s: self._decode_tile(s, ts.xe_shape, ts.xo_shapes),
            ts.tiles)
        return self._stitch(tiles, ts.meta)

    @staticmethod
    def _stitch(tiles: List[np.ndarray], meta: TileMeta) -> np.ndarray:
        o = meta.overlap
        return np.concatenate([t[o: o + meta.tile_h] for t in tiles],
                              axis=0)[None]

    def compress_decompress(self, x: np.ndarray) -> CodecResult:
        """Round trip of one image: the stitched reconstruction, the real
        bits per pixel of all tiles' streams and the PSNR. ``compress``
        already decodes each tile from its streams; decoding them again
        (as the JAX package's round trip does) gives the same bits, so it
        is not repeated."""
        ts, xhat = self.compress(x)
        bpp = ts.nbytes() * 8.0 / (ts.meta.height * ts.meta.width)
        mse = float(np.mean((x - xhat) ** 2))
        psnr = float(-10.0 * np.log10(max(mse, 1e-12)))
        return CodecResult(xhat, bpp, psnr, [s for t in ts.tiles for s in t])
