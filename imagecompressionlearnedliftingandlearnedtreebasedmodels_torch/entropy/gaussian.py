"""Conditional Gaussian entropy model.

The integer-bin Gaussian likelihood ``Phi((0.5-|v|)/s) - Phi((-0.5-|v|)/s)``
around a predicted mean, with compressAI's ``GaussianConditional`` bounds
(scale >= 0.11, likelihood >= 1e-9), as the JAX package's
``entropy/gaussian.py``; and for the bitstream the 64-entry log-spaced
scale table, the CDF-row index of a scale (:func:`build_indexes`) and the
pmf rows of the table (:func:`cdf_table`, numpy and scipy in float64 as
there, so the quantized CDFs are the same integers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.math_utils import (lower_bound, quantize_dequantize,
                              quantize_noise)

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64
SCALE_BOUND = 0.11
LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9


def get_scale_table(smin=SCALES_MIN, smax=SCALES_MAX, levels=SCALES_LEVELS):
    """exp-linspace scale table (float64)."""
    return np.exp(np.linspace(np.log(smin), np.log(smax), levels))


def build_indexes(scales: torch.Tensor) -> torch.Tensor:
    """Each scale's CDF-table row: the number of table entries (all but the
    last, in fp32) strictly below the scale bounded at ``SCALE_BOUND``;
    int32, ``scales``' shape."""
    table = torch.as_tensor(get_scale_table()[:-1], dtype=torch.float32,
                            device=scales.device)
    s = torch.clamp_min(scales.float(), SCALE_BOUND)
    return (s[..., None] > table).sum(-1, dtype=torch.int32)


def cdf_table(scale_table=None, tail_mass: float = TAIL_MASS):
    """Dense pmf rows per scale-table entry for the host CDF builder: row i
    covers symbols ``[-center_i, center_i]`` with ``center_i = ceil(scale_i
    * z_tail)``, each row's tail taken at its own center (compressAI's
    ``GaussianConditional.update``). Returns numpy ``(pmf, tail,
    pmf_length, offset)``."""
    from scipy.special import erfc
    from scipy.stats import norm

    if scale_table is None:
        scale_table = get_scale_table()
    scale_table = np.asarray(scale_table, dtype=np.float64)
    multiplier = -norm.ppf(tail_mass / 2.0)
    centers = np.ceil(scale_table * multiplier).astype(np.int64)
    pmf_length = 2 * centers + 1
    max_length = int(pmf_length.max())
    samples = np.abs(np.arange(max_length)[None, :] - centers[:, None])
    s = scale_table[:, None]
    upper = 0.5 * erfc(-(2 ** -0.5) * (0.5 - samples) / s)
    lower = 0.5 * erfc(-(2 ** -0.5) * (-0.5 - samples) / s)
    pmf = upper - lower
    tail = 2.0 * lower[:, 0]
    pmf[np.arange(max_length)[None, :] >= pmf_length[:, None]] = 0.0
    return pmf, tail, pmf_length, -centers


def _standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) via erfc for upper-tail stability."""
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


def likelihood(x: torch.Tensor, scales: torch.Tensor, means=None,
               training: bool = False, generator=None):
    """Quantize ``x`` (uniform noise from ``generator`` in training, hard
    rounding around ``means`` in eval) and evaluate its bin likelihood.
    Returns ``(x_qnt, lik)``."""
    if training:
        x_qnt = quantize_noise(x, generator)
    else:
        x_qnt = quantize_dequantize(x, means)
    values = x_qnt - means if means is not None else x_qnt
    scales = lower_bound(scales, SCALE_BOUND)
    values = torch.abs(values)
    upper = _standardized_cumulative((0.5 - values) / scales)
    lower = _standardized_cumulative((-0.5 - values) / scales)
    return x_qnt, lower_bound(upper - lower, LIKELIHOOD_BOUND)


def self_information_bits(x: torch.Tensor, scales: torch.Tensor, means=None,
                          training: bool = False, generator=None):
    """``(x_qnt, -log2 likelihood)``."""
    x_qnt, lik = likelihood(x, scales, means, training, generator)
    return x_qnt, -torch.log2(lik)
