"""Conditional Gaussian entropy model.

The integer-bin Gaussian likelihood ``Phi((0.5-|v|)/s) - Phi((-0.5-|v|)/s)``
around a predicted mean, with compressAI's ``GaussianConditional`` bounds
(scale >= 0.11, likelihood >= 1e-9), as the JAX package's
``entropy/gaussian.py``.
"""

from __future__ import annotations

import torch

from ..ops.math_utils import (lower_bound, quantize_dequantize,
                              quantize_noise)

SCALE_BOUND = 0.11
LIKELIHOOD_BOUND = 1e-9


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
