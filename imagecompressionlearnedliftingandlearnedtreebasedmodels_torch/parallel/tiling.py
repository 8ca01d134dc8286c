"""Overlapped tiling of a high-resolution image, on one device.

Counterpart of the single-device part of the JAX package's
``parallel/tiling.py``: the image is split along H into tiles that each
carry a reconstruction margin sized by the transform's reach; the tiles run
as one batch and their interiors are stitched back. The coding path's
counterpart is ``coding/tiled_coder.py``. The mesh functions of the JAX
package (``make_tiled_eval_step``, ``make_halo_eval_step`` and the halo
lifting) wait for more than one device (ROADMAP Queue A item 13).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import Config, full_fp32, resolve_device


class TileMeta(NamedTuple):
    n_tiles: int
    tile_h: int      # interior rows per tile
    overlap: int     # margin rows on each side (multiple of 2^levels)
    height: int
    width: int


def reconstruction_margin(cfg: Config) -> int:
    """Rows of context a tile needs so its interior reconstruction matches
    the untiled transform: ``2^levels * (filtersize + 4)``, a multiple of
    ``2^levels``."""
    unit = 2 ** cfg.dwtlevels
    need = unit * (cfg.filtersize + 4)
    return ((need + unit - 1) // unit) * unit


def tile_image(x: np.ndarray, n_tiles: int, overlap: int
               ) -> Tuple[np.ndarray, TileMeta]:
    """NHWC ``(1, H, W, C)`` -> ``(n_tiles, tile_h + 2*overlap, W, C)``, the
    outer borders padded by repeating the edge row. H must divide by
    ``n_tiles``."""
    _, h, w, _ = x.shape
    if h % n_tiles:
        raise ValueError(f"H={h} must divide into {n_tiles} tiles")
    tile_h = h // n_tiles
    padded = np.pad(x, ((0, 0), (overlap, overlap), (0, 0), (0, 0)),
                    mode="edge")
    tiles = np.stack([
        padded[0, i * tile_h: i * tile_h + tile_h + 2 * overlap]
        for i in range(n_tiles)])
    return tiles, TileMeta(n_tiles, tile_h, overlap, h, w)


def untile_image(tiles: np.ndarray, meta: TileMeta) -> np.ndarray:
    """Drop the margins and stitch the interiors back to ``(1, H, W, C)``."""
    o = meta.overlap
    parts = [tiles[i, o: o + meta.tile_h] for i in range(meta.n_tiles)]
    return np.concatenate(parts, axis=0)[None]


@torch.inference_mode()
def tiled_forward(cfg: Config, model, x: np.ndarray, n_tiles: int,
                  device=None) -> np.ndarray:
    """The eval forward (surrogate encode and decode) of one NHWC RGB image
    in [0, 1] as a batch of ``n_tiles`` overlapped tiles on one device (the
    card unless the caller names another); returns the stitched
    reconstruction in [0, 1]."""
    from ..train.state import apply_color_forward

    dev = resolve_device(device)
    full_fp32()
    model.to(dev).eval()
    tiles, meta = tile_image(np.asarray(x, np.float32), n_tiles,
                             reconstruction_margin(cfg))
    batch = torch.from_numpy(tiles).permute(0, 3, 1, 2).to(dev)
    _, xhat, _, _, _ = apply_color_forward(cfg, model, batch)
    out = (torch.clamp(xhat, -0.5, 0.5) + 0.5).permute(0, 2, 3, 1)
    return untile_image(out.cpu().numpy(), meta)
