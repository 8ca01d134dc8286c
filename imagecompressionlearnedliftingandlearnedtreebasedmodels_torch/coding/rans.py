"""ctypes bindings to the port's build of the host rANS coder.

Counterpart of the JAX package's ``coding/rans.py`` over the same C++
(``csrc/rans.cpp``, ``csrc/rans_core.h``, byte-for-byte copies), built at
first use by :mod:`.native_build`:

- :class:`BufferedRansEncoder`: accumulate ``(symbols, indexes)`` batches,
  ``flush()`` to one byte stream;
- :class:`RansDecoder`: ``set_stream(bytes)``, then incremental
  ``decode_stream(indexes)`` calls;
- :func:`pmf_to_quantized_cdf` / :func:`build_cdf_matrix`: 16-bit CDF
  quantization of pmf rows (tail mass as the last element).

Everything here is numpy on the host.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from .native_build import RANS


def get_lib() -> ctypes.CDLL:
    """Build (once per source version) and load the rANS library."""
    return RANS.load()


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _as_u32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint32)


def _ptr(a: np.ndarray) -> int:
    """The address of ``a``'s data: the caller keeps ``a`` alive across the
    C call."""
    return a.ctypes.data


def pmf_to_quantized_cdf(pmf: Sequence[float], precision: int = 16
                         ) -> np.ndarray:
    """Quantize one pmf row (tail mass as the last element) to a CDF of
    length ``len(pmf) + 1`` summing exactly to ``2**precision``."""
    lib = get_lib()
    pmf = np.ascontiguousarray(pmf, dtype=np.float64)
    out = np.zeros(len(pmf) + 1, dtype=np.uint32)
    rc = lib.pmf_to_quantized_cdf(
        _ptr(pmf), len(pmf), precision,
        _ptr(out))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed with code {rc}")
    return out


def build_cdf_matrix(pmfs: np.ndarray, tails: np.ndarray,
                     pmf_lengths: np.ndarray, precision: int = 16):
    """Stack variable-length pmf rows into the (cdfs, lengths) matrix the
    coder takes. Row i codes symbols ``0..pmf_lengths[i]-1`` plus the
    escape (tail) interval."""
    n = len(pmf_lengths)
    max_cdf_len = int(np.max(pmf_lengths)) + 2
    cdfs = np.zeros((n, max_cdf_len), dtype=np.uint32)
    lengths = np.zeros(n, dtype=np.int32)
    for i in range(n):
        ln = int(pmf_lengths[i])
        row = np.concatenate([pmfs[i, :ln], [max(float(tails[i]), 1e-12)]])
        cdfs[i, : ln + 2] = pmf_to_quantized_cdf(row, precision)
        lengths[i] = ln + 2
    return cdfs, lengths


class BufferedRansEncoder:
    """Accumulates symbol/index batches; one stream out on flush. All
    batches of one flush must share the same CDF tables: mixing tables
    raises."""

    def __init__(self):
        self._symbols: List[np.ndarray] = []
        self._indexes: List[np.ndarray] = []
        self._cdfs = None

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_lengths,
                            offsets) -> None:
        self._symbols.append(_as_i32(np.asarray(symbols).ravel()))
        self._indexes.append(_as_i32(np.asarray(indexes).ravel()))
        cdfs = _as_u32(cdfs)
        cdf_lengths = _as_i32(cdf_lengths)
        offsets = _as_i32(offsets)
        if self._cdfs is None:
            self._cdfs, self._cdf_lengths, self._offsets = (
                cdfs, cdf_lengths, offsets)
        elif not (np.array_equal(self._cdfs, cdfs)
                  and np.array_equal(self._cdf_lengths, cdf_lengths)
                  and np.array_equal(self._offsets, offsets)):
            raise ValueError(
                "BufferedRansEncoder: CDF tables changed between batches "
                "of one flush; flush() per table set instead")

    def flush(self) -> bytes:
        if self._cdfs is None:
            return b""
        lib = get_lib()
        symbols = np.concatenate(self._symbols)
        indexes = np.concatenate(self._indexes)
        if symbols.shape != indexes.shape:
            raise ValueError(f"{symbols.size} symbols but {indexes.size} "
                             "indexes")
        capacity = max(1024, symbols.size * 8 + 1024)
        out = np.zeros(capacity, dtype=np.uint8)
        n = lib.rans_encode_with_indexes(
            _ptr(symbols), _ptr(indexes),
            symbols.size, _ptr(self._cdfs),
            self._cdfs.shape[1], _ptr(self._cdf_lengths),
            _ptr(self._offsets),
            _ptr(out), capacity)
        if n < 0:
            raise RuntimeError("rANS encode buffer overflow")
        self._symbols, self._indexes, self._cdfs = [], [], None
        return bytes(out[:n].tobytes())


def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    enc = BufferedRansEncoder()
    enc.encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets)
    return enc.flush()


class RansDecoder:
    """Streaming decoder over one byte stream (the C decoder keeps its own
    copy of the bytes)."""

    def __init__(self):
        self._handle = None
        self._lib = None

    def set_stream(self, data: bytes) -> None:
        self._free()
        self._lib = get_lib()
        buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
        self._handle = self._lib.rans_decoder_new(
            _ptr(buf), buf.size)

    def decode_stream(self, indexes, cdfs, cdf_lengths, offsets) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("RansDecoder: set_stream first")
        # every buffer the C call reads stays referenced here until it returns
        indexes = _as_i32(np.asarray(indexes).ravel())
        cdfs = _as_u32(cdfs)
        cdf_lengths = _as_i32(cdf_lengths)
        offsets = _as_i32(offsets)
        out = np.zeros(indexes.size, dtype=np.int32)
        self._lib.rans_decoder_decode(
            self._handle, _ptr(indexes), indexes.size, _ptr(cdfs),
            cdfs.shape[1], _ptr(cdf_lengths), _ptr(offsets), _ptr(out))
        return out

    def _free(self):
        if self._handle is not None:
            self._lib.rans_decoder_free(self._handle)
            self._handle = None

    def __del__(self):
        self._free()


def decode_with_indexes(data: bytes, indexes, cdfs, cdf_lengths,
                        offsets) -> np.ndarray:
    dec = RansDecoder()
    dec.set_stream(data)
    return dec.decode_stream(indexes, cdfs, cdf_lengths, offsets)
