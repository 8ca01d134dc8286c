"""Spatially tiled high-resolution eval and halo-exchange lifting.

Counterpart of the JAX package's ``parallel/tiling.py``:

1. **Overlapped tiling** (:func:`tile_image` / :func:`untile_image` /
   :func:`tiled_forward` / :func:`make_tiled_eval_step`): the image is
   split along H into tiles that each carry a reconstruction margin sized
   by the transform's reach; the tiles run as a batch, on one device or
   spread over the ranks of a mesh, and their interiors are stitched back.
   The coding path's counterpart is ``coding/tiled_coder.py``.
2. **Halo exchange** (:func:`make_halo_eval_step`): one image H-sharded
   over the ranks, exact (no tiles, no seams). The transform exchanges
   boundary rows with the neighbour ranks (:func:`halo_dwt97_2d`, the ring
   exchange of the 9/7 ladder, which is its periodization;
   :func:`halo_lift2d_forward`, the learned lifting with zero rows and
   edge masks at the image's ends). Where the JAX package leaves the
   subband AEs and the entropy model to XLA's partitioner, every rank here
   gathers, at each level, the neighbour rows that the subband stage's
   convs reach (:func:`subband_reach`), runs the stage on the extended
   blocks, crops, and the rate and distortion sums are all-reduced.

Exchanges are ``all_gather``s of boundary slabs (``mesh.neighbour_rows``),
which gloo runs on CUDA tensors as NCCL does.
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config, full_fp32, resolve_device
from ..ops import dwt97
from ..ops.fast_conv import sharded_planes
from ..ops.lifting import _merge_rows, _split_rows
from ..train.loss import RDLossOutput
from . import mesh as mesh_lib
from .mesh import Mesh


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
                  device=None, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The eval forward (surrogate encode and decode) of one NHWC RGB image
    in [0, 1] as ``n_tiles`` overlapped tiles; returns the stitched
    reconstruction in [0, 1]. Without a mesh the tiles run as one batch on
    ``device`` (the card unless the caller names another); with one, each
    rank runs its share of the tiles (``n_tiles`` must divide by the mesh)
    on its device and every rank returns the whole stitched image."""
    from ..train.state import apply_color_forward

    dev = mesh.device if mesh is not None else resolve_device(device)
    full_fp32()
    model.to(dev).eval()
    tiles, meta = tile_image(np.asarray(x, np.float32), n_tiles,
                             reconstruction_margin(cfg))
    batch = torch.from_numpy(tiles).permute(0, 3, 1, 2)
    if mesh is not None:
        batch = mesh_lib.shard_batch(mesh, batch)
    _, xhat, _, _, _ = apply_color_forward(cfg, model, batch.to(dev))
    out = (torch.clamp(xhat, -0.5, 0.5) + 0.5).permute(0, 2, 3, 1)
    if mesh is not None:
        out = torch.cat(mesh_lib.all_gather(mesh, out.contiguous()))
    return untile_image(out.cpu().numpy(), meta)


def make_tiled_eval_step(cfg: Config, model, mesh: Mesh):
    """``tiled_step(tiles, lam=None) -> (RDLossOutput, xhat)``: the eval
    step over a tile batch (NCHW) spread over the mesh; the RD terms are
    the tile batch's (the ranks' means averaged), ``xhat`` this rank's
    tiles."""
    from .dp import mean_over_ranks
    from ..train.state import make_eval_step

    base = make_eval_step(cfg, model, mesh.device)

    def tiled_step(tiles: torch.Tensor, lam: Optional[float] = None):
        out, xhat = base(mesh_lib.shard_batch(mesh, tiles), lam)
        return RDLossOutput(*mean_over_ranks(mesh, out)), xhat

    return tiled_step


# --- halo exchange ----------------------------------------------------------

LADDER_REACH = 2   # row pairs of context a 9/7 level needs on each side


def _ring_extended(mesh: Mesh, t: torch.Tensor, r: int) -> torch.Tensor:
    """``t`` with ``r`` rows (dim 2) of each ring neighbour around it."""
    prev, nxt = mesh_lib.neighbour_rows(mesh, t, r, 2, wrap=True)
    return torch.cat([prev, t, nxt], dim=2)


def halo_lift97_rows(x: torch.Tensor, mesh: Mesh):
    """The 9/7 analysis ladder along the rows (dim 2) of this rank's block
    of an H-sharded NCHW array -> (low, high), each with half the block's
    rows. The block is extended by the ladder's reach of ring neighbour
    rows (the ring closing is the ladder's periodization), lifted by the
    one-axis ladder (kernel 2 on the card), and cropped."""
    e = 2 * LADDER_REACH
    low, high = dwt97.lift97_1d(_ring_extended(mesh, x, e), 2)
    n = x.shape[2] // 2
    return (low[:, :, LADDER_REACH:LADDER_REACH + n],
            high[:, :, LADDER_REACH:LADDER_REACH + n])


def halo_dwt97_2d(x: torch.Tensor, mesh: Mesh, levels: int):
    """Multi-level 9/7 DWT of this rank's block of an H-sharded NCHW array
    -> ``(ll, highs)``, each this rank's block of the single-device
    ``dwt97_forward``'s. Per level the block is extended by the ladder's
    reach through the ring exchange, the level kernel runs on it (kernel 2
    on the card, rows and columns in one launch) and the outputs are
    cropped; the recursion continues on the still H-sharded LL. The block's
    rows must stay even at every level: H must divide by ``n_ranks *
    2^levels``."""
    r = LADDER_REACH
    highs = []
    ll = x
    for _ in range(levels):
        n = ll.shape[2] // 2
        ll, pack = dwt97.dwt97_level(_ring_extended(mesh, ll, 2 * r))
        ll, pack = ll[:, :, r:r + n], pack[:, :, r:r + n]
        highs.append(pack)
    return ll, highs


def halo_idwt97_2d(ll: torch.Tensor, highs: List[torch.Tensor],
                   mesh: Mesh) -> torch.Tensor:
    """Exact inverse of :func:`halo_dwt97_2d` (same sharding): kernel 3 on
    the ring-extended LL and pack of each level, cropped."""
    r = LADDER_REACH
    for pack in reversed(highs):
        n = ll.shape[2]
        x = dwt97.idwt97_level(_ring_extended(mesh, ll, r),
                               _ring_extended(mesh, pack, r))
        ll = x[:, :, 2 * r:2 * (r + n)]
    return ll


def _ext_axis(mesh: Mesh, t: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """``t`` with ``r`` neighbour rows on each side of the sharded ``dim``;
    the image's first and last blocks get zeros there (the learned
    ladder's zero padding)."""
    prev, nxt = mesh_lib.neighbour_rows(mesh, t, r, dim, wrap=False)
    return torch.cat([prev, t, nxt], dim=dim)


def _edge_mask(mesh: Mesh, n_loc: int, r: int, dim: int,
               device) -> torch.Tensor:
    """0/1 over an ``r``-extended sharded axis: zero on rows outside the
    image (only the first and last blocks have such rows)."""
    g = torch.arange(n_loc + 2 * r, device=device) - r + mesh.rank * n_loc
    m = ((g >= 0) & (g < mesh.size * n_loc)).float()
    shape = [1, 1, 1, 1]
    shape[dim] = n_loc + 2 * r
    return m.reshape(shape)


def _halo_lift_level_fwd(stage, x: torch.Tensor, mesh: Mesh):
    """One sharded 2-D learned-lifting level (the single-device
    ``lift_level_forward``, its column passes batched the same way)."""
    r = stage.halo_radius
    R = r + 1
    L, H = _split_rows(x)
    n1 = L.shape[2]
    if n1 < R:
        raise ValueError(
            f"halo lifting needs local rows >= {R} at every level "
            f"(got {n1}); increase H or reduce ranks/levels")
    L, H = stage.forward_halo_rows(
        L, H, lambda t: _ext_axis(mesh, t, R, 2), _edge_mask(
            mesh, n1, R, 2, x.device), R)
    b = x.shape[0]
    T = torch.cat([L.transpose(2, 3), H.transpose(2, 3)], dim=0)
    Ls, Hs = _split_rows(T)          # splits dim 2 == W: rank-local
    n2 = Ls.shape[3]
    lo_t, hi_t = stage.forward_halo_cols(
        Ls, Hs, lambda t: _ext_axis(mesh, t, r, 3), _edge_mask(
            mesh, n2, r, 3, x.device), r)
    ll = lo_t[:b].transpose(2, 3)
    hl = hi_t[:b].transpose(2, 3)
    lh = lo_t[b:].transpose(2, 3)
    hh = hi_t[b:].transpose(2, 3)
    return ll, lh, hl, hh


def _halo_lift_level_inv(stage, ll, lh, hl, hh, mesh: Mesh):
    """Exact inverse of :func:`_halo_lift_level_fwd`."""
    r = stage.halo_radius
    R = r + 1
    b = ll.shape[0]
    lo_t = torch.cat([ll.transpose(2, 3), lh.transpose(2, 3)], dim=0)
    hi_t = torch.cat([hl.transpose(2, 3), hh.transpose(2, 3)], dim=0)
    n2 = lo_t.shape[3]
    merged = _merge_rows(*stage.inverse_halo_cols(
        lo_t, hi_t, lambda t: _ext_axis(mesh, t, r, 3), _edge_mask(
            mesh, n2, r, 3, ll.device), r))
    L = merged[:b].transpose(2, 3)
    H = merged[b:].transpose(2, 3)
    n1 = L.shape[2]
    return _merge_rows(*stage.inverse_halo_rows(
        L, H, lambda t: _ext_axis(mesh, t, R, 2), _edge_mask(
            mesh, n1, R, 2, ll.device), R))


def halo_lift2d_forward(cfg: Config, transforms, y: torch.Tensor,
                        mesh: Mesh):
    """Multi-level learned-lifting analysis of this rank's block of an
    H-sharded NCHW array. ``transforms``: one ``LearnedLiftingTransform``
    per plane (1 for joint RGB, 3 for YCbCr); returns ``(ll, highs)``
    concatenated over the planes' channels, this rank's blocks."""
    cpp = y.shape[1] // len(transforms)
    lls, packs = [], []
    for i, tr in enumerate(transforms):
        ll = y[:, i * cpp:(i + 1) * cpp]
        plane = []
        for lvl in range(cfg.dwtlevels):
            ll, lh, hl, hh = _halo_lift_level_fwd(tr._stage(lvl), ll, mesh)
            plane.append(dwt97.pack_details(lh, hl, hh))
        lls.append(ll)
        packs.append(plane)
    return torch.cat(lls, dim=1), [
        torch.cat([p[lv] for p in packs], dim=1)
        for lv in range(cfg.dwtlevels)]


def halo_lift2d_inverse(cfg: Config, transforms, ll: torch.Tensor, highs,
                        mesh: Mesh) -> torch.Tensor:
    """Exact inverse of :func:`halo_lift2d_forward`."""
    cpp = ll.shape[1] // len(transforms)
    outs = []
    for i, tr in enumerate(transforms):
        y = ll[:, i * cpp:(i + 1) * cpp]
        for lvl in range(cfg.dwtlevels - 1, -1, -1):
            lh, hl, hh = dwt97.unpack_details(
                highs[lvl][:, 3 * cpp * i:3 * cpp * (i + 1)])
            y = _halo_lift_level_inv(tr._stage(lvl), y, lh, hl, hh, mesh)
        outs.append(y)
    return torch.cat(outs, dim=1)


def subband_reach(cfg: Config) -> int:
    """Rows, at a level's own resolution, over which the subband stage (AE
    encode, the entropy model, AE decode) of that level reaches: a row of
    its output depends on input rows no farther away. The Berk AE's four
    SAME 3x3 convs reach ``a = 4`` rows each way; ZTsep's parent context
    (the parent level's quantized AE output, upsampled x2) through the plc
    3x3 pair reaches ``2a + 2``, its csc 5x5 ``a + 2``, the PixelCNNs of
    the coarsest details and LL ``a + 5``; onlyEZWT's plc ``2a + 2`` (its
    learned upsampler two rows more); ZTBlock's dep-nets on the parent and
    the cosets before ``2a + 6`` at most; decoding the quantized subbands
    ``2a``."""
    a = 4 if cfg.autoencoder == "SubbandAutoEncoderBerk" else 0
    el = cfg.entropy_layer
    if el == "conditioned2ZTsepSubbands":
        ent = max(2 * a + 2, a + 5)
    elif el == "onlyEZWT":
        ent = 2 * a + 4
    elif el == "DWTConditioned2EntropyLayerZTBlock":
        ent = 2 * a + 6
    else:
        ent = a
    return max(ent, 2 * a)


def _subband_extension(cfg: Config) -> int:
    """Rows of extension at the coarsest level (even, so the extended
    blocks keep their row parity); level l gets ``2^(L-1-l)`` times
    that."""
    e = subband_reach(cfg)
    return e + e % 2


def _extended_rows(mesh: Mesh, t: torch.Tensor, e: int):
    """``(t with e rows of each neighbour block around it, top, bottom)``:
    the image's first and last blocks get none on their outer side."""
    if e == 0:
        return t, 0, 0
    prev, nxt = mesh_lib.neighbour_rows(mesh, t, e, 2, wrap=False)
    top = e if mesh.rank > 0 else 0
    bottom = e if mesh.rank < mesh.size - 1 else 0
    return torch.cat([prev[:, :, e - top:], t, nxt[:, :, :bottom]], dim=2), \
        top, bottom


def _crop(t: torch.Tensor, top: int, n: int) -> torch.Tensor:
    return t[:, :, top:top + n]


def _subband_stage(cfg: Config, codecs, ll: torch.Tensor, highs,
                   mesh: Mesh, e_c: int):
    """The AE encode, entropy model and AE decode of each plane's codec on
    this rank's subband blocks, extended at level l by ``e_c *
    2^(L-1-l)`` neighbour rows and cropped back. The bf16 convs pick their
    form by the level's global plane (``fast_conv.sharded_planes``), as
    the unsharded step does. Returns (the info sums of LL and of the
    details, ll_hat, highs_hat)."""
    with sharded_planes({t.shape[3]: t.shape[2] * mesh.size * t.shape[3]
                         for t in [ll, *highs]}):
        return _subband_stage_blocks(cfg, codecs, ll, highs, mesh, e_c)


def _subband_stage_blocks(cfg: Config, codecs, ll: torch.Tensor, highs,
                          mesh: Mesh, e_c: int):
    levels = cfg.dwtlevels
    ext = [e_c * 2 ** (levels - 1 - lv) for lv in range(levels)]
    ll_x, top_c, _ = _extended_rows(mesh, ll, e_c)
    hx = [_extended_rows(mesh, h, e)[0] for h, e in zip(highs, ext)]
    tops = [e if mesh.rank > 0 else 0 for e in ext]
    cpp = ll.shape[1] // len(codecs)
    info_xe = info_xo = 0.0
    lls, hhs = [], []
    for i, codec in enumerate(codecs):
        tr, em = codec.transform, codec.entropymodel
        xe = tr.yl_ae.encode(ll_x[:, i * cpp:(i + 1) * cpp])
        xo = [tr.yh_ae[lv].encode(hx[lv][:, 3 * cpp * i:3 * cpp * (i + 1)])
              for lv in range(levels)]
        ixe, ixo, xe_q, xo_q = em(xe, xo, False)
        info_xe = info_xe + _crop(ixe, top_c, ll.shape[2]).sum()
        for lv in range(levels):
            info_xo = info_xo + _crop(ixo[lv], tops[lv],
                                      highs[lv].shape[2]).sum()
        lls.append(_crop(tr.yl_ae.decode(xe_q), top_c, ll.shape[2]))
        hhs.append([_crop(tr.yh_ae[lv].decode(xo_q[lv]), tops[lv],
                          highs[lv].shape[2]) for lv in range(levels)])
    return (info_xe, info_xo, torch.cat(lls, dim=1),
            [torch.cat([p[lv] for p in hhs], dim=1) for lv in range(levels)])


def halo_min_height(cfg: Config, n_ranks: int) -> int:
    """The least image height the halo eval takes on ``n_ranks``: every
    level's block must hold the rows its neighbours need (the subband
    stage's extension, and the learned ladder's ``halo_radius + 1``)."""
    unit = n_ranks * 2 ** cfg.dwtlevels
    if cfg.entropy_layer == "DWTConditioned2EntropyLayerZTBlock":
        unit *= 2          # the cosets need even block starts at every level
    rows_c = _subband_extension(cfg)   # a block's rows at the coarsest level
    if cfg.netType == "LiftingBasedNeuralWaveletv4":
        # the deepest level's row bands hold halo_radius + 1 rows
        rows_c = max(rows_c, 4 * (cfg.filtersize // 2) + 1)
    else:
        rows_c = max(rows_c, LADDER_REACH)
    need = n_ranks * rows_c * 2 ** cfg.dwtlevels
    return -(-need // unit) * unit


def make_halo_eval_step(cfg: Config, model, mesh: Mesh):
    """The exact H-sharded eval step (no tiles, no seams).

    ``step(batch, lam=None) -> (RDLossOutput, xhat)``: every rank is handed
    the global batch (NCHW RGB in [0, 1]) and takes its block of rows; the
    RD terms are the whole batch's (sums all-reduced), ``xhat`` is this
    rank's block of the clipped reconstruction. Supported transforms:
    ``CDF97`` (:func:`halo_dwt97_2d`, the level kernels on ring-extended
    blocks) and ``LiftingBasedNeuralWaveletv4`` (:func:`halo_lift2d_forward`;
    its P/U convs run in fp32 whatever the dtype, with the same weights, as
    the JAX package's do, so the sharded ladder matches the fp32 one). The
    subband AEs and the entropy model keep the config's dtype. H must
    divide by ``n_ranks * 2^levels`` and be at least
    :func:`halo_min_height`."""
    from ..ops import color
    from ..models.transforms import make_transform

    if cfg.netType not in ("CDF97", "LiftingBasedNeuralWaveletv4"):
        raise ValueError("halo_eval supports CDF97 and the learned lifting "
                         f"transform (netType={cfg.netType!r})")
    full_fp32()
    dev = mesh.device
    model.to(dev).eval()
    levels = cfg.dwtlevels
    unit = mesh.size * 2 ** levels
    h_min = halo_min_height(cfg, mesh.size)
    codecs = [model.codec] if cfg.clrch == 3 else list(model.codecs)
    e_c = _subband_extension(cfg)

    if cfg.netType == "CDF97":
        def fwd(y):
            return halo_dwt97_2d(y, mesh, levels)

        def inv(ll, highs):
            return halo_idwt97_2d(ll, highs, mesh)
    else:
        cfg32 = copy.copy(cfg)
        cfg32.dtype = "float32"
        transforms = []
        for codec in codecs:
            tr = make_transform(cfg32).to(dev)
            tr.load_state_dict(codec.transform.state_dict())
            transforms.append(tr.eval())

        def fwd(y):
            return halo_lift2d_forward(cfg, transforms, y, mesh)

        def inv(ll, highs):
            return halo_lift2d_inverse(cfg, transforms, ll, highs, mesh)

    @torch.inference_mode()
    def step(batch: torch.Tensor, lam: Optional[float] = None):
        if lam is None:
            lam = cfg.lambda_
        h = int(batch.shape[2])
        if h % unit or h < h_min:
            raise ValueError(
                f"halo_eval: H={h} must divide by n_ranks*2^levels={unit} "
                f"and be at least {h_min} on {mesh.size} ranks")
        x = mesh_lib.row_block(mesh, batch).to(dev, torch.float32)
        if cfg.clrch == 3:
            y = x - 0.5
        else:
            y = color.shift_ycbcr(color.rgb_to_ycbcr(x))
        ll, highs = fwd(y)
        info_xe, info_xo, ll_hat, highs_hat = _subband_stage(
            cfg, codecs, ll, highs, mesh, e_c)
        yhat = inv(ll_hat, highs_hat)
        if cfg.clrch == 3:
            xhat = yhat
        else:
            xhat = color.ycbcr_to_rgb(color.unshift_ycbcr(yhat)) - 0.5
        xhat = torch.clamp(xhat, -0.5, 0.5)
        sums = mesh_lib.all_reduce_sum(mesh, torch.stack([
            ((x - 0.5 - xhat) ** 2).sum(), info_xe, info_xo]).double())
        numel = float(batch.numel())
        mse = sums[0] / numel
        rate1 = sums[1] / numel * 3.0
        rate2 = sums[2] / numel * 3.0
        out = RDLossOutput(rate1 + rate2 + lam * mse, mse, rate1, rate2)
        return RDLossOutput(*(t.float() for t in out)), xhat

    return step
