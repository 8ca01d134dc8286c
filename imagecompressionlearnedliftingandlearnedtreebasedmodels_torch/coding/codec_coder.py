"""Real encode and decode: the transforms on the device, the entropy coding
on the host.

Counterpart of the JAX package's ``coding/codec_coder.py``. The analysis
and synthesis transforms run on the model's device (the card unless the
caller asks for the CPU) through each plane codec's ``transform.encode`` /
``transform.decode``; the subbands cross to the host once per plane and
level as NHWC float32 numpy, the layout the C++ takes, and the host codes
them:

- ZTsepSubbands (the flagship): the wavefront walkers of
  :mod:`.wavefront` (host C++ context nets and rANS);
- factorized (the CDF 9/7 codec): one rANS call per subband with the
  learned-CDF tables of each ``EntropyBottleneck.pmf_table``.

onlyEZWT and ZTBlock are not ported yet (ROADMAP Queue A item 10) and
raise ``NotImplementedError``; so does tiled coding (item 13).

Decode-consistency: every context input is the decoded value
``round(x - mu) + mu``, so the encoder's writeback and the decoder's planes
are the same bits and the streams round-trip exactly. Bits per pixel,
PSNR, clipping and the colour policy follow the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, resolve_device
from ..entropy import gaussian
from ..ops import color
from ..tools import weights
from . import rans

_UNPORTED = "is not ported yet (ROADMAP Queue A item {})"


@dataclasses.dataclass
class PlaneStreams:
    """Byte streams for one color plane: LL + one per detail level.

    ``meta`` records the coding variant the decoder must honor: the
    context evaluator of each ZTsep walk (always ``"native"`` here) and the
    C++ build's arithmetic fingerprint ``ctx_fp``.
    """
    xe: bytes
    xo: List[bytes]
    meta: dict = dataclasses.field(default_factory=dict)

    def nbytes(self) -> int:
        return len(self.xe) + sum(len(s) for s in self.xo)


@dataclasses.dataclass
class CodecResult:
    xhat: np.ndarray
    bpp: float
    psnr: float
    streams: List[PlaneStreams]


def _gc_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantized CDF matrix for the 64-entry Gaussian scale table."""
    pmf, tail, lengths, offsets = gaussian.cdf_table()
    cdfs, cdf_lengths = rans.build_cdf_matrix(pmf, tail, lengths)
    return cdfs, cdf_lengths, offsets.astype(np.int32)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().permute(0, 2, 3, 1).float().cpu()
                                .numpy())


class CodecCoder:
    """Bitstream compress/decompress around a port ``CodecWrapper``.

    ``device``: where the transforms run; the card unless the caller passes
    another (``"cpu"`` for a rehearsal), and never the CPU on its own.
    ``last_timing`` holds the split of the last ``compress_decompress``:
    the transforms' milliseconds on the device (CUDA events on the card)
    and the host's coding milliseconds, summed over the planes.
    """

    # Parent-keyed plc memo: the decoder's parent plane is bit-identical to
    # the encoder's writeback by construction, so the round trip of one
    # image computes each (plane, level) parent-context pass once.
    _PLC_MEMO_BYTES = 512 * 1024 * 1024

    def __init__(self, cfg: Config, model, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.n_planes = 1 if cfg.clrch == 3 else 3
        self._gc_cdfs, self._gc_lengths, self._gc_offsets = _gc_tables()
        self._eb_tables: Dict = {}
        self._plane_params_cache: Dict[int, dict] = {}
        self._native_cache: Dict = {}
        self._plc_memo: "OrderedDict" = OrderedDict()
        self._plc_memo_bytes = 0
        self._plc_memo_lock = threading.Lock()
        self._warm = False  # the first image runs its planes serially
        self.last_timing: Dict[str, float] = {}

    # --- module access ------------------------------------------------
    def _plane_module(self, plane: int):
        return self.model.codec if self.cfg.clrch == 3 \
            else self.model.codecs[plane]

    def _plane_params(self, plane: int) -> dict:
        """One plane's weights as the flax-layout numpy tree the C++
        packers read."""
        if plane not in self._plane_params_cache:
            flat = weights.flax_params_from_state_dict(
                self._plane_module(plane).state_dict())
            self._plane_params_cache[plane] = weights.unflatten_params(flat)
        return self._plane_params_cache[plane]

    def _native(self, key, make):
        if key not in self._native_cache:
            self._native_cache[key] = make()
        return self._native_cache[key]

    def _native_level_eval(self, plane: int, level: int):
        from .native_ctx import LevelContextEvaluator
        return self._native((plane, level), lambda: LevelContextEvaluator(
            self._plane_params(plane), level, 3 * self.cfg.clrch))

    def _native_plc_eval(self, plane: int, level: int):
        from .native_ctx import PLCPlaneEvaluator
        return self._native((plane, "plc", level), lambda: PLCPlaneEvaluator(
            self._plane_params(plane), level, 3 * self.cfg.clrch))

    def _native_pixelcnn_eval(self, plane: int, kind: str):
        from .native_ctx import PixelCNNWalker
        which = "pixelcnn_xe" if kind == "xe" else "pixelcnn_xo"
        ic = (1 if kind == "xe" else 3) * self.cfg.clrch
        return self._native((plane, kind), lambda: PixelCNNWalker(
            self._plane_params(plane), which, ic))

    def _plc_memoized(self, plane: int, level: int, parent_np, evaluator):
        key = (plane, level,
               hashlib.blake2b(parent_np.tobytes(), digest_size=16).digest())
        with self._plc_memo_lock:
            hit = self._plc_memo.get(key)
        if hit is None:
            hit = evaluator(parent_np)
            with self._plc_memo_lock:
                self._plc_memo[key] = hit
                self._plc_memo_bytes += hit.nbytes
                while self._plc_memo_bytes > self._PLC_MEMO_BYTES \
                        and len(self._plc_memo) > 1:
                    _, old = self._plc_memo.popitem(last=False)
                    self._plc_memo_bytes -= old.nbytes
        return hit

    # --- transforms on the device ---------------------------------------
    def _device_ms(self, fn):
        """``(fn(), ms)``: CUDA events on the card, the host clock on the
        CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end)
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    @torch.inference_mode()
    def analysis(self, plane: int, y: torch.Tensor):
        """One plane (NCHW on the device) -> ``(xe, [xo])`` NHWC numpy."""
        xe, xo_list = self._plane_module(plane).transform.encode(
            y.to(self.device, torch.float32))
        return _nhwc(xe), [_nhwc(t) for t in xo_list]

    @torch.inference_mode()
    def synthesis(self, plane: int, xe_hat: np.ndarray, xo_hats) -> np.ndarray:
        """Decoded subbands (NHWC numpy) -> the plane, NHWC numpy."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).permute(
                0, 3, 1, 2).to(self.device)

        yhat = self._plane_module(plane).transform.decode(
            dev(xe_hat), [dev(t) for t in xo_hats])
        return _nhwc(yhat)

    # --- EB (factorized bottleneck) coding ----------------------------
    def _eb_table(self, plane: int, attr: str, index: Optional[int] = None):
        key = (plane, attr, index)
        if key not in self._eb_tables:
            eb = getattr(self._plane_module(plane).entropymodel, attr)
            if index is not None:
                eb = eb[index]
            pmf, tail, length, offset = (t.cpu().numpy()
                                         for t in eb.pmf_table())
            cdfs, lengths = rans.build_cdf_matrix(pmf, tail, length)
            self._eb_tables[key] = (cdfs, lengths,
                                    np.asarray(offset, np.int32),
                                    eb.medians().detach().cpu().numpy())
        return self._eb_tables[key]

    def _eb_encode(self, x: np.ndarray, table) -> Tuple[bytes, np.ndarray]:
        cdfs, lengths, offsets, med = table
        symbols = np.round(x - med).astype(np.int32)
        indexes = np.broadcast_to(
            np.arange(x.shape[-1], dtype=np.int32), x.shape)
        data = rans.encode_with_indexes(
            symbols.ravel(), indexes.ravel(), cdfs, lengths, offsets)
        return data, symbols.astype(np.float32) + med

    def _eb_decode(self, data: bytes, shape, table) -> np.ndarray:
        cdfs, lengths, offsets, med = table
        indexes = np.broadcast_to(np.arange(shape[-1], dtype=np.int32), shape)
        symbols = rans.decode_with_indexes(
            data, indexes.ravel(), cdfs, lengths, offsets).reshape(shape)
        return symbols.astype(np.float32) + med

    # --- per-entropy-model plane coding --------------------------------
    def compress_plane(self, plane: int, y: torch.Tensor):
        """Analysis + entropy-encode one color plane (NCHW). Returns the
        streams and the decode-consistent subband reconstructions."""
        xe, xo_list = self.analysis(plane, y)
        return self._compress_entropy(plane, xe, xo_list)

    def _unported(self):
        el = self.cfg.entropy_layer
        if el in ("onlyEZWT", "DWTConditioned2EntropyLayerZTBlock"):
            raise NotImplementedError(
                f"coding entropy_layer {el!r} " + _UNPORTED.format(10))
        raise ValueError(el)

    def _compress_entropy(self, plane: int, xe, xo_list):
        el = self.cfg.entropy_layer
        if el == "factorized":
            return self._compress_factorized(plane, xe, xo_list)
        if el == "conditioned2ZTsepSubbands":
            from .wavefront import compress_ztsep
            return compress_ztsep(self, plane, xe, xo_list)
        return self._unported()

    def _decompress_entropy(self, plane: int, streams: PlaneStreams,
                            xe_shape, xo_shapes):
        el = self.cfg.entropy_layer
        if el == "factorized":
            return self._decompress_factorized(plane, streams, xe_shape,
                                               xo_shapes)
        if el == "conditioned2ZTsepSubbands":
            from .wavefront import decompress_ztsep
            return decompress_ztsep(self, plane, streams, xe_shape,
                                    xo_shapes)
        return self._unported()

    # factorized ---------------------------------------------------------
    def _compress_factorized(self, plane, xe, xo_list):
        L = self.cfg.dwtlevels
        xo_streams, xo_hats = [], []
        for i in range(L):
            data, hat = self._eb_encode(np.asarray(xo_list[i]),
                                        self._eb_table(plane, "eb_xo", i))
            xo_streams.append(data)
            xo_hats.append(hat)
        data_xe, xe_hat = self._eb_encode(
            np.asarray(xe), self._eb_table(plane, "eb_xe"))
        return (PlaneStreams(data_xe, xo_streams), xo_hats, xe_hat, xo_hats)

    def _decompress_factorized(self, plane, streams, xe_shape, xo_shapes):
        xe_hat = self._eb_decode(streams.xe, xe_shape,
                                 self._eb_table(plane, "eb_xe"))
        xo_hat = [self._eb_decode(streams.xo[i], xo_shapes[i],
                                  self._eb_table(plane, "eb_xo", i))
                  for i in range(self.cfg.dwtlevels)]
        return xe_hat, xo_hat

    # --- top level ------------------------------------------------------
    def compress_decompress(self, batch: np.ndarray) -> CodecResult:
        """Full round trip of one RGB image, NHWC (1, h, w, 3) in [0, 1]:
        the reconstruction, the real bits per pixel and the PSNR. Raises if
        a plane's decoded subbands are not the encoder's writeback bit for
        bit."""
        cfg = self.cfg
        b, h, w, _ = batch.shape
        if b != 1:
            raise ValueError("the coding path processes one image at a time")
        if cfg.tile_size and h > cfg.tile_size and h % cfg.tile_size == 0:
            raise NotImplementedError(
                f"tiled coding (tile_size {cfg.tile_size}) "
                + _UNPORTED.format(13))
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).permute(
            0, 3, 1, 2).to(self.device)
        if cfg.clrch == 3:
            planes = [x - 0.5]
        else:
            ycbcr = color.shift_ycbcr(color.rgb_to_ycbcr(x))
            planes = [ycbcr[:, i:i + 1] for i in range(3)]
        timing = {"encode_host_ms": 0.0, "decode_host_ms": 0.0}
        lock = threading.Lock()

        xe_xo, timing["analysis_ms"] = self._device_ms(
            lambda: [self.analysis(p, y) for p, y in enumerate(planes)])

        def roundtrip(p):
            xe, xo_list = xe_xo[p]
            t0 = time.perf_counter()
            plane_streams, _, xe_hat, xo_hats = self._compress_entropy(
                p, xe, xo_list)
            t1 = time.perf_counter()
            xe_hat2, xo_hat2 = self._decompress_entropy(
                p, plane_streams, xe_hat.shape, [t.shape for t in xo_hats])
            t2 = time.perf_counter()
            if not (np.array_equal(xe_hat2, xe_hat) and all(
                    np.array_equal(a, b) for a, b in zip(xo_hat2, xo_hats))):
                raise RuntimeError(f"plane {p}: the decoded subbands differ "
                                   "from the encoder's writeback")
            with lock:
                timing["encode_host_ms"] += (t1 - t0) * 1e3
                timing["decode_host_ms"] += (t2 - t1) * 1e3
            return plane_streams, xe_hat2, xo_hat2

        t0 = time.perf_counter()
        if len(planes) > 1 and self._warm:
            # the C++ walks release the GIL: the planes' host coding overlaps
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=len(planes)) as pool:
                results = list(pool.map(roundtrip, range(len(planes))))
        else:
            results = [roundtrip(p) for p in range(len(planes))]
            self._warm = True
        timing["host_wall_ms"] = (time.perf_counter() - t0) * 1e3
        streams = [r[0] for r in results]
        yhats, timing["synthesis_ms"] = self._device_ms(
            lambda: [self.synthesis(p, r[1], r[2])
                     for p, r in enumerate(results)])

        if cfg.clrch == 3:
            xhat = np.clip(yhats[0], -0.5, 0.5) + 0.5
        else:
            y = torch.from_numpy(np.concatenate(yhats, axis=-1)).permute(
                0, 3, 1, 2)
            xhat = _nhwc(color.ycbcr_to_rgb(color.unshift_ycbcr(y)))
            xhat = np.clip(xhat, 0.0, 1.0)
        self.last_timing = timing
        total_bytes = sum(s.nbytes() for s in streams)
        bpp = total_bytes * 8.0 / (h * w)
        mse = float(np.mean((batch - xhat) ** 2))
        psnr = float(-10.0 * np.log10(max(mse, 1e-12)))
        return CodecResult(xhat, bpp, psnr, streams)


def _pack_chunks(chunks) -> bytes:
    """Length-prefixed concatenation of nested byte chunks (the ZTBlock
    streams' framing, kept for item 10)."""
    flat: List[bytes] = []

    def walk(c):
        if isinstance(c, (bytes, bytearray)):
            flat.append(bytes(c))
        else:
            for e in c:
                walk(e)
    walk(chunks)
    out = [np.int64(len(flat)).tobytes()]
    for f in flat:
        out.append(np.int64(len(f)).tobytes())
        out.append(f)
    return b"".join(out)


def _unpack_chunks(data: bytes, group: int = 4):
    """Inverse of :func:`_pack_chunks`, regrouped into lists of ``group``."""
    n = int(np.frombuffer(data[:8], np.int64)[0])
    pos = 8
    flat: List[bytes] = []
    for _ in range(n):
        ln = int(np.frombuffer(data[pos:pos + 8], np.int64)[0])
        pos += 8
        flat.append(data[pos:pos + ln])
        pos += ln
    return [flat[i:i + group] for i in range(0, len(flat), group)]
