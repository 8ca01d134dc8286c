"""Standalone arithmetic-coding utilities over the port's rANS.

Per-channel symbol coding against quantized CDFs (:class:`ArithmeticCoder`,
with ``measure_bpp``'s round-trip assert), an adaptive per-symbol variant
(:class:`ContextArithmeticCoder`), and the CDF validation asserts kept as
API. The rANS is the host C++ of ``csrc/rans.cpp`` (:mod:`.rans`), so the
streams are the JAX package's byte for byte.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import rans

PRECISION = 16


def validate_cdf(cdf: np.ndarray) -> None:
    """CDF well-formedness checks: starts at 0, normalized to 2^16,
    strictly increasing. Raises ``AssertionError`` (whatever ``-O`` says),
    as the JAX package's asserts do."""
    cdf = np.asarray(cdf)
    for ok, what in ((cdf[0] == 0, "cdf must start at 0"),
                     (cdf[-1] == (1 << PRECISION),
                      "cdf must be normalized to 2^16"),
                     ((np.diff(cdf) >= 1).all(),
                      "cdf must be strictly increasing")):
        if not ok:
            raise AssertionError(what)


def _with_escape(row: np.ndarray) -> np.ndarray:
    """Append a 1-wide escape interval (the rANS rows treat the final
    interval as escape), stealing one count from the widest bin."""
    row = np.asarray(row, np.int64).copy()
    widest = int(np.argmax(np.diff(row)))
    row[widest + 1:] -= 1
    return np.concatenate([row, [1 << PRECISION]]).astype(np.uint32)


def _cdf_matrix(cdfs: Sequence[np.ndarray]):
    """Validated rows with their escape interval, zero-padded into one
    ``(n, max_len + 1)`` uint32 matrix, and each row's length."""
    mat = np.zeros((len(cdfs), max(len(c) for c in cdfs) + 1), np.uint32)
    lengths = np.zeros(len(cdfs), np.int32)
    for i, c in enumerate(cdfs):
        validate_cdf(c)
        row = _with_escape(c)
        mat[i, : len(row)] = row
        lengths[i] = len(row)
    return mat, lengths


class ArithmeticCoder:
    """Encode/decode per-channel symbol lists against per-channel CDFs.

    ``cdfs``: one quantized CDF array a channel, each ending at 2^16;
    symbols are non-negative ints below ``len(cdf) - 1``.
    """

    def __init__(self, cdfs: Sequence[np.ndarray]):
        self.cdfs, self.lengths = _cdf_matrix(cdfs)
        self.offsets = np.zeros(len(cdfs), np.int32)

    def encode(self, symbols_per_channel: Sequence[Sequence[int]]) -> bytes:
        syms = [np.asarray(s, np.int32) for s in symbols_per_channel]
        idxs = [np.full(len(s), ch, np.int32) for ch, s in enumerate(syms)]
        return rans.encode_with_indexes(
            np.concatenate(syms), np.concatenate(idxs), self.cdfs,
            self.lengths, self.offsets)

    def decode(self, data: bytes, counts: Sequence[int]) -> List[np.ndarray]:
        idxs = np.concatenate([
            np.full(n, ch, np.int32) for ch, n in enumerate(counts)])
        flat = rans.decode_with_indexes(data, idxs, self.cdfs, self.lengths,
                                        self.offsets)
        return np.split(flat, np.cumsum(counts)[:-1])

    def measure_bpp(self, symbols_per_channel, num_pixels: int) -> float:
        """Encode, decode, check bit-exact recovery (``AssertionError``
        otherwise), return bits/pixel."""
        data = self.encode(symbols_per_channel)
        decoded = self.decode(data, [len(s) for s in symbols_per_channel])
        for got, want in zip(decoded, symbols_per_channel):
            if not np.array_equal(got, np.asarray(want)):
                raise AssertionError("arithmetic coder round-trip mismatch")
        return len(data) * 8.0 / num_pixels


class ContextArithmeticCoder:
    """Per-symbol adaptive CDFs: every symbol carries its own CDF row."""

    def encode(self, symbols: Sequence[int],
               cdfs: Sequence[np.ndarray]) -> bytes:
        if len(symbols) != len(cdfs):
            raise AssertionError(f"{len(symbols)} symbols, {len(cdfs)} cdfs")
        mat, lengths = _cdf_matrix(cdfs)
        return rans.encode_with_indexes(
            np.asarray(symbols, np.int32),
            np.arange(len(symbols), dtype=np.int32), mat, lengths,
            np.zeros(len(cdfs), np.int32))

    def decode(self, data: bytes, cdfs: Sequence[np.ndarray]) -> np.ndarray:
        mat, lengths = _cdf_matrix(cdfs)
        return rans.decode_with_indexes(
            data, np.arange(len(cdfs), dtype=np.int32), mat, lengths,
            np.zeros(len(cdfs), np.int32))
