"""Wavefront (anti-diagonal) coding for the ZTsep causal-context model.

Counterpart of the JAX package's ``coding/wavefront.py``, native path only.
Under a mask-A conv of kernel height ``kh`` every pixel on anti-diagonal
``d = a*row + col`` (``a = kh//2 + 1``) depends only on pixels of earlier
diagonals, so a plane is coded one diagonal at a time. Each plane walk
(context evaluation, rANS coding and the writeback of the decoded value
``round(x - mu) + mu``) is one call into the host C++ of
:mod:`.native_ctx`: the 5-layer PixelCNNs for LL and the coarsest details,
and for each finer level the parent context (a whole-plane pass, once per
level, memoized across the encode and decode of one image) fused with the
5x5 causal context. The encoder walks the same diagonals as the decoder, so
both see the same context bit for bit.

The JAX package keeps two fallbacks for a missing C++ build, a jax context
evaluator and an accelerator parent-context pass; the port has neither. A
stream whose ``meta`` names another evaluator than ``"native"`` is refused,
as is a stream whose ``ctx_fp`` differs from this build's fingerprint.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from . import rans
from .native_ctx import ctx_fingerprint

# The plane walks are CPU-bound host compute (C++ context nets + rANS):
# running more walks than cores at once only thrashes the cache, so the
# compute-heavy section admits one walk per core.
_WALK_SLOTS = threading.BoundedSemaphore(max(1, os.cpu_count() or 1))


def diagonal_order(h: int, w: int, a: int) -> List[np.ndarray]:
    """Pixel coordinates grouped by anti-diagonal d = a*row + col; each
    entry is an (n_d, 2) int array of (row, col), rows ascending."""
    rows, cols = np.mgrid[0:h, 0:w]
    d = a * rows + cols
    order = []
    for dv in range(int(d.max()) + 1):
        mask = d == dv
        if mask.any():
            order.append(np.stack([rows[mask], cols[mask]], axis=1))
    return order


def _refuse_other_evaluators(what: str, value: Optional[str]) -> None:
    if value not in (None, "native"):
        raise RuntimeError(
            f"stream's {what} is {value!r}: this package codes only with the "
            "native (C++) context walkers, and another evaluator's last-ulp "
            "sigma/mu differences change CDF indexes, so decoding here could "
            "corrupt the plane; decode it with the package that wrote it")


class ZTSepPlaneCoder:
    """Shared encode/decode wavefront walker for one color plane."""

    def __init__(self, coder, plane: int):
        self.coder = coder
        self.plane = plane
        self.last_evaluator = None
        self.last_plc_backend = None

    def code(self, kind: str, level: Optional[int], x_true, shape,
             stream: Optional[bytes], con=None,
             force_evaluator: Optional[str] = None,
             force_plc_backend: Optional[str] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Walk the plane (NHWC float32, batch 1). Encode mode when
        ``x_true`` is given (returns the symbols and CDF indexes
        diagonal-major); decode mode consumes ``stream``. Returns (hat,
        symbols, indexes). ``force_*`` carry the stream's ``meta``: only
        ``"native"`` (or nothing) is accepted."""
        _refuse_other_evaluators("context evaluator", force_evaluator)
        _refuse_other_evaluators("parent-context pass", force_plc_backend)
        coder = self.coder
        if x_true is not None:
            shape = x_true.shape
        b, h, w, c = shape
        if b != 1:
            raise ValueError(f"the wavefront codes one image, got batch {b}")
        if kind == "level":
            parent = np.ascontiguousarray(np.asarray(con), np.float32)
            plc = coder._plc_memoized(self.plane, level, parent,
                                      coder._native_plc_eval(self.plane, level))
            self.last_plc_backend = "native"
            native = coder._native_level_eval(self.plane, level)
            pad = 2
        else:
            native = coder._native_pixelcnn_eval(self.plane, kind)
            pad = 5
        self.last_evaluator = "native"

        padded = np.zeros((1, h + 2 * pad, w + 2 * pad, c), np.float32)
        hat = padded[:, pad:h + pad, pad:w + pad, :]  # view for readback
        x_np = None if x_true is None else np.asarray(x_true)[0]
        data = b"" if stream is None else stream
        with _WALK_SLOTS:
            if kind == "level":
                syms, idxs = native.walk(
                    padded, plc[0], x_np, coder._gc_cdfs, coder._gc_lengths,
                    coder._gc_offsets, stream=data)
            else:
                syms, idxs = native.walk(
                    padded, pad, x_np, coder._gc_cdfs, coder._gc_lengths,
                    coder._gc_offsets, stream=data)
        if x_true is None:
            syms = np.zeros(0, np.int32)
            idxs = np.zeros(0, np.int32)
        return np.ascontiguousarray(hat), syms, idxs


def compress_ztsep(coder, plane: int, xe, xo_list):
    """Encode one plane's pyramid (NHWC numpy): LL and coarsest details
    through their PixelCNN wavefronts, finer levels through parent and
    causal context. Returns (PlaneStreams, xo_hats, xe_hat, xo_hats)."""
    from .codec_coder import PlaneStreams

    L = coder.cfg.dwtlevels
    walker = ZTSepPlaneCoder(coder, plane)

    def flush(syms, idxs) -> bytes:
        enc = rans.BufferedRansEncoder()
        enc.encode_with_indexes(syms, idxs, coder._gc_cdfs,
                                coder._gc_lengths, coder._gc_offsets)
        return enc.flush()

    meta = {}
    xe_hat, syms, idxs = walker.code("xe", None, np.asarray(xe), None, None)
    meta["evaluator_xe"] = walker.last_evaluator
    stream_xe = flush(syms, idxs)

    streams_xo: List[bytes] = [b""] * L
    xo_hats: List[np.ndarray] = [None] * L
    hat, syms, idxs = walker.code(
        "coarsest", None, np.asarray(xo_list[L - 1]), None, None)
    meta["evaluator_coarsest"] = walker.last_evaluator
    xo_hats[L - 1] = hat
    streams_xo[L - 1] = flush(syms, idxs)
    con = hat
    for i in range(L - 2, -1, -1):
        hat, syms, idxs = walker.code(
            "level", i, np.asarray(xo_list[i]), None, None, con=con)
        meta[f"evaluator_l{i}"] = walker.last_evaluator
        meta[f"plc_backend_l{i}"] = walker.last_plc_backend
        xo_hats[i] = hat
        streams_xo[i] = flush(syms, idxs)
        con = hat
    # the arithmetic fingerprint of this build of the C++ walkers: a
    # decoder whose build produces other bits refuses the stream
    meta["ctx_fp"] = ctx_fingerprint()
    return (PlaneStreams(stream_xe, streams_xo, meta), xo_hats, xe_hat,
            xo_hats)


def check_fingerprint(meta: dict) -> None:
    """Refuse a native stream that carries no ``ctx_fp`` or another build's
    (as the JAX package's decoder does)."""
    if "native" not in meta.values():
        return
    fp = meta.get("ctx_fp")
    if fp is None:
        raise RuntimeError(
            "stream was encoded with the native (C++) coding kernels but "
            "carries no kernel fingerprint ('ctx_fp'): it predates "
            "fingerprint stamping and the kernels' bit-level arithmetic has "
            "changed since; refusing to decode (re-encode with a current "
            "build)")
    local_fp = ctx_fingerprint()
    if fp != local_fp:
        raise RuntimeError(
            f"stream's native coding kernels fingerprint {fp} != this "
            f"build's {local_fp}: the builds produce different bits "
            "(FMA/vector-width differences), decoding would corrupt the "
            "planes")


def decompress_ztsep(coder, plane: int, streams, xe_shape, xo_shapes):
    """Decode one plane's pyramid; returns (xe_hat, xo_hats), NHWC numpy."""
    L = coder.cfg.dwtlevels
    walker = ZTSepPlaneCoder(coder, plane)
    meta = getattr(streams, "meta", None) or {}
    check_fingerprint(meta)
    xe_hat, _, _ = walker.code("xe", None, None, xe_shape, streams.xe,
                               force_evaluator=meta.get("evaluator_xe"))
    xo_hat: List[np.ndarray] = [None] * L
    xo_hat[L - 1], _, _ = walker.code(
        "coarsest", None, None, xo_shapes[L - 1], streams.xo[L - 1],
        force_evaluator=meta.get("evaluator_coarsest"))
    con = xo_hat[L - 1]
    for i in range(L - 2, -1, -1):
        xo_hat[i], _, _ = walker.code(
            "level", i, None, xo_shapes[i], streams.xo[i], con=con,
            force_evaluator=meta.get(f"evaluator_l{i}"),
            force_plc_backend=meta.get(f"plc_backend_l{i}"))
        con = xo_hat[i]
    return xe_hat, xo_hat
