"""One CDF 9/7 level as explicit separable stride-2 circular filters (NCHW).

Counterpart of the JAX package's ``ops/dwt97_conv.py``: the analysis taps
are derived from the lifting ladder (the 9 low-pass and 7 high-pass taps
of a unit impulse's response), and the filtering is circular, so one level
equals :func:`.dwt97.dwt97_level`'s to fp32 rounding. No transform calls
it: it cross-checks the ladder, and is the natural form when the transform
is fused into neighbouring convs (it does about twice the ladder's work).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .math_utils import LIFTING_COEFF

ALPHA, BETA, GAMMA, DELTA, NH, NL = LIFTING_COEFF


@functools.lru_cache(maxsize=1)
def _filters_np():
    n = 32

    def lift(sig):
        s, d = sig[0::2].copy(), sig[1::2].copy()
        d += ALPHA * (s + np.roll(s, -1))
        s += BETA * (np.roll(d, 1) + d)
        d += GAMMA * (s + np.roll(s, -1))
        s += DELTA * (np.roll(d, 1) + d)
        return s * NL, d * NH

    low = np.zeros((n // 2, n))
    high = np.zeros((n // 2, n))
    for i in range(n):
        e = np.zeros(n)
        e[i] = 1.0
        low[:, i], high[:, i] = lift(e)

    def extract(row, support):
        # the circular row centred: its taps lie near index 0 (mod n)
        rolled = np.roll(row, n // 2)
        nz = np.abs(rolled) > 1e-12
        first = int(np.argmax(nz))
        last = n - 1 - int(np.argmax(nz[::-1]))
        if last - first + 1 != support:
            raise AssertionError(f"9/7 filter support {last - first + 1}, "
                                 f"expected {support}")
        return rolled[first:last + 1], first - n // 2

    h_low, off_low = extract(low[0], 9)
    h_high, off_high = extract(high[0], 7)
    return h_low, h_high, off_low, off_high


def cdf97_filters():
    """(h_low, h_high, low_offset, high_offset): the analysis taps (fp32
    tensors) and the input offset of each filter's first tap relative to
    its output sample."""
    h_low, h_high, off_low, off_high = _filters_np()
    return (torch.tensor(h_low, dtype=torch.float32),
            torch.tensor(h_high, dtype=torch.float32), off_low, off_high)


def _circ_filter_downsample(x: torch.Tensor, taps, offset: int,
                            dim: int) -> torch.Tensor:
    """y[k] = sum_t taps[t] * x[2k + offset + t], indices circular."""
    acc = None
    for t, tap in enumerate(taps.tolist()):
        term = tap * torch.roll(x, -(offset + t), dims=dim)
        acc = term if acc is None else acc + term
    even = [slice(None)] * x.dim()
    even[dim] = slice(0, None, 2)
    return acc[tuple(even)]


def dwt97_conv_1d(x: torch.Tensor, dim: int):
    """One 1-D analysis pass along ``dim`` (2: H, 3: W) -> (low, high); both
    bands apply at stride 2 on the even output grid."""
    h_low, h_high, off_low, off_high = cdf97_filters()
    return (_circ_filter_downsample(x, h_low, off_low, dim),
            _circ_filter_downsample(x, h_high, off_high, dim))


def dwt97_conv_level(x: torch.Tensor):
    """One 2-D level, rows (H) then columns (W): (ll, lh, hl, hh), equal to
    :func:`.dwt97.dwt97_level`'s subbands to fp32 rounding."""
    low, high = dwt97_conv_1d(x, 2)
    ll, hl = dwt97_conv_1d(low, 3)
    lh, hh = dwt97_conv_1d(high, 3)
    return ll, lh, hl, hh
