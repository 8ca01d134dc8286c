"""ctypes bindings to the port's build of the native context walkers.

Counterpart of the JAX package's ``coding/native_ctx.py`` over the same C++
(``csrc/wavefront_ctx.cpp``, a byte-for-byte copy), built at first use by
:mod:`.native_build` with the JAX package's flags. A plane's ZTsep weights
are exported once, from the flax-layout numpy tree that
``tools/weights.py::flax_params_from_state_dict`` makes of the port's
module (so the packers below are the JAX package's, unchanged), and each
walk (context evaluation, rANS coding and the decoded-value writeback of a
whole plane) is one C++ call that releases the GIL. Arrays cross as NHWC
float32 numpy, the layout the C++ takes.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from ..entropy import gaussian
from .native_build import WAVEFRONT_CTX


def get_lib() -> ctypes.CDLL:
    """Build (once per source version) and load the walker library."""
    return WAVEFRONT_CTX.load()


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


_ctx_fp_cache = None


def ctx_fingerprint() -> str:
    """Arithmetic fingerprint of this build of the context evaluator.

    Hash of the kernels' output bits on a fixed pseudorandom workload: two
    builds with equal fingerprints produce bit-identical context parameters
    and therefore bit-compatible streams, whichever package built them.
    Recorded in ``PlaneStreams.meta['ctx_fp']`` by the encoder and checked
    by the decoder.
    """
    global _ctx_fp_cache
    if _ctx_fp_cache is None:
        lib = get_lib()
        lib.ztsep_ctx_fingerprint.restype = ctypes.c_uint64
        _ctx_fp_cache = f"{lib.ztsep_ctx_fingerprint():016x}"
    return _ctx_fp_cache


def _pack_conv3x3(kernel: np.ndarray) -> np.ndarray:
    """flax (3,3,cin,cout) -> blocked (ceil(cout/8), 9, cin, 8)."""
    kh, kw, cin, cout = kernel.shape
    assert (kh, kw) == (3, 3)
    cp = (cout + 7) & ~7
    k = np.zeros((9, cin, cp), np.float32)
    k[:, :, :cout] = np.asarray(kernel, np.float32).reshape(9, cin, cout)
    # (9, cin, cp) -> (cp/8, 9, cin, 8)
    return np.ascontiguousarray(
        k.reshape(9, cin, cp // 8, 8).transpose(2, 0, 1, 3))


def _pad_bias(bias: np.ndarray) -> np.ndarray:
    b = np.asarray(bias, np.float32)
    cp = (b.shape[0] + 7) & ~7
    out = np.zeros(cp, np.float32)
    out[:b.shape[0]] = b
    return out


class PLCPlaneEvaluator:
    """Native whole-plane parent-context pass for one (plane, level):
    upsample2 + conv3x3(LReLU) + conv3x3, deterministic host fp32
    arithmetic."""

    def __init__(self, plane_params: Dict, level: int, so: int):
        em = plane_params["entropymodel"]
        plc = em[f"plc_{level}"]
        k0 = np.asarray(plc["Conv_0"]["kernel"], np.float32)
        k1 = np.asarray(plc["Conv_1"]["kernel"], np.float32)
        assert k0.shape[2] == so and k1.shape[3] == so * 81
        self.so = so
        self.wide = so * 81
        self.w1 = _pack_conv3x3(k0)
        self.b1 = _pad_bias(plc["Conv_0"]["bias"])
        self.w2 = _pack_conv3x3(k1)
        self.b2 = _pad_bias(plc["Conv_1"]["bias"])

    def __call__(self, parent: np.ndarray) -> np.ndarray:
        """parent (1, h2, w2, so) -> plc (1, 2*h2, 2*w2, so*81) float32."""
        lib = get_lib()
        parent = np.ascontiguousarray(np.asarray(parent)[0], np.float32)
        h2, w2, so = parent.shape
        assert so == self.so
        out = np.empty((1, 2 * h2, 2 * w2, self.wide), np.float32)
        lib.ztsep_plc_plane(
            _fp(parent), ctypes.c_int32(h2), ctypes.c_int32(w2),
            ctypes.c_int32(so),
            _fp(self.w1), _fp(self.b1), ctypes.c_int32(self.wide),
            _fp(self.w2), _fp(self.b2),
            _fp(out))
        return out


class LevelContextEvaluator:
    """Native evaluator for one (plane, level) of ZTsepSubbands."""

    def __init__(self, plane_params: Dict, level: int, so: int):
        em = plane_params["entropymodel"]
        csc = em[f"csc_{level}"]
        self.so = so
        # pre-transpose weights to (out, in) for unit-stride C++ reads
        self.csc_w = np.ascontiguousarray(
            np.asarray(csc["kernel"], np.float32).reshape(25, so * 81).T)
        self.csc_b = np.ascontiguousarray(
            np.asarray(csc["bias"], np.float32))
        cgp = em[f"cgp_{level}"]
        self.ws, self.bs, self.outs = [], [], []
        for i in range(4):
            k = np.asarray(cgp[f"Conv_{i}"]["kernel"], np.float32)
            # (1,1,in_g,out_total) -> (out_total, in_g)
            self.ws.append(np.ascontiguousarray(
                k.reshape(k.shape[2], k.shape[3]).T))
            self.bs.append(np.ascontiguousarray(
                np.asarray(cgp[f"Conv_{i}"]["bias"], np.float32)))
            self.outs.append(k.shape[3])
        self.table = np.ascontiguousarray(
            gaussian.get_scale_table().astype(np.float32))

    def __call__(self, patches: np.ndarray, plc: np.ndarray):
        """patches (n,5,5,so), plc (n,so*81) -> (idx (n,so) i32, mu (n,so))."""
        lib = get_lib()
        n = patches.shape[0]
        patches = np.ascontiguousarray(patches, np.float32)
        plc = np.ascontiguousarray(plc, np.float32)
        idx = np.zeros((n, self.so), np.int32)
        mu = np.zeros((n, self.so), np.float32)
        lib.ztsep_level_centers(
            _fp(patches), ctypes.c_int64(n), ctypes.c_int32(self.so),
            _fp(plc),
            _fp(self.csc_w), _fp(self.csc_b),
            _fp(self.ws[0]), _fp(self.bs[0]), ctypes.c_int32(self.outs[0]),
            _fp(self.ws[1]), _fp(self.bs[1]), ctypes.c_int32(self.outs[1]),
            _fp(self.ws[2]), _fp(self.bs[2]), ctypes.c_int32(self.outs[2]),
            _fp(self.ws[3]), _fp(self.bs[3]), ctypes.c_int32(self.outs[3]),
            _fp(self.table), ctypes.c_int32(len(self.table)),
            ctypes.c_float(gaussian.SCALE_BOUND),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _fp(mu))
        return idx, mu

    def walk(self, padded: np.ndarray, plc: np.ndarray,
             x_true: np.ndarray = None,
             cdfs: np.ndarray = None, cdf_lengths: np.ndarray = None,
             offsets: np.ndarray = None, stream: bytes = b""):
        """Full-plane wavefront walk in one C++ call: per-diagonal center
        evaluation, rANS symbol coding and decoded-value writeback with no
        Python in the loop.

        ``padded``: (1, h+4, w+4, so) float32 zero-initialized plane the
        decoded values are written into (pad=2). Encode mode when
        ``x_true`` (1, h, w, so) is given — returns (symbols, indexes) in
        the buffered-encoder order; decode mode consumes ``stream`` with
        the in-library rANS decoder (bit-compatible with the rANS library:
        both compile ``rans_core.h``) and returns (None, None).
        """
        lib = get_lib()
        h = padded.shape[1] - 4
        w = padded.shape[2] - 4
        assert padded.dtype == np.float32 and padded.flags.c_contiguous
        plc = np.ascontiguousarray(plc, np.float32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        n_all = h * w * self.so
        encode = x_true is not None
        if encode:
            x_true = np.ascontiguousarray(x_true, np.float32)
            syms = np.zeros(n_all, np.int32)
            idxs = np.zeros(n_all, np.int32)
            sbuf = np.zeros(0, np.uint8)
        else:
            syms = idxs = None
            sbuf = np.frombuffer(stream, np.uint8)
        cdfs = np.ascontiguousarray(cdfs, np.uint32)
        cdf_lengths = np.ascontiguousarray(cdf_lengths, np.int32)
        offsets = np.ascontiguousarray(offsets, np.int32)
        null_i32 = ctypes.cast(None, i32p)
        lib.ztsep_level_walk(
            ctypes.c_int32(0 if encode else 1),
            ctypes.c_int32(h), ctypes.c_int32(w), ctypes.c_int32(self.so),
            _fp(padded), _fp(plc),
            _fp(x_true) if encode else ctypes.cast(
                None, ctypes.POINTER(ctypes.c_float)),
            _fp(self.csc_w), _fp(self.csc_b),
            _fp(self.ws[0]), _fp(self.bs[0]), ctypes.c_int32(self.outs[0]),
            _fp(self.ws[1]), _fp(self.bs[1]), ctypes.c_int32(self.outs[1]),
            _fp(self.ws[2]), _fp(self.bs[2]), ctypes.c_int32(self.outs[2]),
            _fp(self.ws[3]), _fp(self.bs[3]), ctypes.c_int32(self.outs[3]),
            _fp(self.table), ctypes.c_int32(len(self.table)),
            ctypes.c_float(gaussian.SCALE_BOUND),
            cdfs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int32(cdfs.shape[1]),
            cdf_lengths.ctypes.data_as(i32p),
            offsets.ctypes.data_as(i32p),
            sbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(sbuf.size),
            syms.ctypes.data_as(i32p) if encode else null_i32,
            idxs.ctypes.data_as(i32p) if encode else null_i32)
        return syms, idxs


class PixelCNNWalker:
    """Native incremental evaluator for a 5-layer masked PixelCNN over a
    wavefront plane walk (the ZTsep xe / coarsest-details paths).

    ``which`` selects the param subtree (``pixelcnn_xe`` or ``pixelcnn_xo``);
    ``ic`` is the grouped channel count (1*clrch or 3*clrch). Each layer's
    activations are computed exactly once per pixel over the whole walk
    (persistent per-layer planes advanced diagonal by diagonal) — ~24x
    fewer MAC than re-running the stack over each center's 11x11
    dependency cone. ``begin(h, w)`` returns an independent walk session
    (the evaluator itself holds only read-only weights, so one cached
    instance serves concurrent tile/plane threads); then
    ``session.step(padded_plane, pad, coords)`` advances one anti-diagonal
    and returns the centers' (CDF rows, mu).
    """

    # causal 3x3 taps: mask A = first 4, mask B adds the center
    _TAPS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0))

    def __init__(self, plane_params: Dict, which: str, ic: int):
        stack = plane_params["entropymodel"][which]
        self.ic = ic
        self.ws, self.bs, self.outs, self.og16 = [], [], [], []
        for i in range(5):
            k = np.asarray(stack[f"MaskedConv2d_{i}"]["kernel"], np.float32)
            kh, kw, in_g, out = k.shape
            assert (kh, kw) == (3, 3)
            ntaps = 4 if i == 0 else 5
            out_g = out // ic
            og16 = (out_g + 15) & ~15
            # (3,3,in_g,out) -> (ic, ntaps, in_g, og16): outputs are the
            # SIMD axis of the C++ evaluator; per-group lanes padded to 16
            # (padding weight/bias lanes zero — pure data movement, no
            # arithmetic, so numpy is safe here)
            wt = np.zeros((ic, ntaps, in_g, og16), np.float32)
            for t, (dr, dc) in enumerate(self._TAPS[:ntaps]):
                # (in_g, out) -> (in_g, ic, out_g) -> per-group lanes
                tap = k[dr + 1, dc + 1].reshape(in_g, ic, out_g)
                wt[:, t, :, :out_g] = tap.transpose(1, 0, 2)
            self.ws.append(np.ascontiguousarray(wt))
            bias = np.asarray(stack[f"MaskedConv2d_{i}"]["bias"], np.float32)
            bp = np.zeros((ic, og16), np.float32)
            bp[:, :out_g] = bias.reshape(ic, out_g)
            self.bs.append(np.ascontiguousarray(bp))
            self.outs.append(out)
            self.og16.append(og16)
        self.table = np.ascontiguousarray(
            gaussian.get_scale_table().astype(np.float32))

    def begin(self, h: int, w: int) -> "_PixelCNNWalk":
        """Fresh walk session with zeroed per-layer activation planes."""
        return _PixelCNNWalk(self, h, w)

    def walk(self, padded: np.ndarray, pad: int,
             x_true: np.ndarray = None,
             cdfs: np.ndarray = None, cdf_lengths: np.ndarray = None,
             offsets: np.ndarray = None, stream: bytes = b""):
        """Full-plane wavefront walk in one C++ call (anti-diagonal loop,
        incremental 5-layer evaluation, rANS coding, writeback), the
        PixelCNN mirror of :meth:`LevelContextEvaluator.walk`.

        ``padded``: (1, h+2*pad, w+2*pad, ic) float32 zero-initialized
        plane. Encode mode when ``x_true`` (1, h, w, ic) is given; decode
        mode consumes ``stream``. Returns (symbols, indexes) on encode,
        (None, None) on decode.
        """
        lib = get_lib()
        h = padded.shape[1] - 2 * pad
        w = padded.shape[2] - 2 * pad
        assert padded.dtype == np.float32 and padded.flags.c_contiguous
        i32p = ctypes.POINTER(ctypes.c_int32)
        n_all = h * w * self.ic
        encode = x_true is not None
        if encode:
            x_true = np.ascontiguousarray(x_true, np.float32)
            syms = np.zeros(n_all, np.int32)
            idxs = np.zeros(n_all, np.int32)
            sbuf = np.zeros(0, np.uint8)
        else:
            syms = idxs = None
            sbuf = np.frombuffer(stream, np.uint8)
        cdfs = np.ascontiguousarray(cdfs, np.uint32)
        cdf_lengths = np.ascontiguousarray(cdf_lengths, np.int32)
        offsets = np.ascontiguousarray(offsets, np.int32)
        null_i32 = ctypes.cast(None, i32p)
        args = [ctypes.c_int32(0 if encode else 1),
                ctypes.c_int32(h), ctypes.c_int32(w),
                ctypes.c_int32(self.ic), ctypes.c_int32(pad),
                _fp(padded),
                _fp(x_true) if encode else ctypes.cast(
                    None, ctypes.POINTER(ctypes.c_float))]
        for wt, b, o, og in zip(self.ws, self.bs, self.outs, self.og16):
            args += [_fp(wt), _fp(b), ctypes.c_int32(o), ctypes.c_int32(og)]
        args += [_fp(self.table), ctypes.c_int32(len(self.table)),
                 ctypes.c_float(gaussian.SCALE_BOUND),
                 cdfs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                 ctypes.c_int32(cdfs.shape[1]),
                 cdf_lengths.ctypes.data_as(i32p),
                 offsets.ctypes.data_as(i32p),
                 sbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                 ctypes.c_int64(sbuf.size),
                 syms.ctypes.data_as(i32p) if encode else null_i32,
                 idxs.ctypes.data_as(i32p) if encode else null_i32]
        lib.ztsep_pixelcnn_walk(*args)
        return syms, idxs


class _PixelCNNWalk:
    """One plane walk's mutable state (per-layer activation planes)."""

    def __init__(self, ev: PixelCNNWalker, h: int, w: int):
        self.ev = ev
        self.ic = ev.ic
        self.h, self.w = h, w
        self.acts = [np.zeros((h + 2, w + 2, o), np.float32)
                     for o in ev.outs[:4]]

    def step(self, padded: np.ndarray, pad: int, coords: np.ndarray):
        """Advance one anti-diagonal.

        ``padded``: (1, h+2*pad, w+2*pad, ic) decoded plane so far;
        ``coords``: (n, 2) int64 (row, col). Returns (idx (n,ic) i32,
        mu (n,ic) f32).
        """
        lib = get_lib()
        ev = self.ev
        n = coords.shape[0]
        padded = np.ascontiguousarray(padded, np.float32)  # keep alive
        rows = np.ascontiguousarray(coords[:, 0], np.int64)
        cols = np.ascontiguousarray(coords[:, 1], np.int64)
        idx = np.zeros((n, self.ic), np.int32)
        mu = np.zeros((n, self.ic), np.float32)
        i64 = ctypes.POINTER(ctypes.c_int64)
        args = [_fp(padded), ctypes.c_int32(self.h),
                ctypes.c_int32(self.w), ctypes.c_int32(pad),
                ctypes.c_int32(self.ic),
                rows.ctypes.data_as(i64), cols.ctypes.data_as(i64),
                ctypes.c_int64(n)]
        args += [_fp(a) for a in self.acts]
        for w, b, o, og in zip(ev.ws, ev.bs, ev.outs, ev.og16):
            args += [_fp(w), _fp(b), ctypes.c_int32(o), ctypes.c_int32(og)]
        args += [_fp(ev.table), ctypes.c_int32(len(ev.table)),
                 ctypes.c_float(gaussian.SCALE_BOUND),
                 idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _fp(mu)]
        lib.ztsep_pixelcnn_step(*args)
        return idx, mu
