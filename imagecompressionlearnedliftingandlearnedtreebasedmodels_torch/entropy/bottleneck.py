"""Fully factorized learned-CDF entropy model ("EntropyBottleneck"), NCHW.

Counterpart of the JAX package's ``entropy/bottleneck.py`` (Balle et al.
2018, as compressAI's ``EntropyBottleneck``): a per-channel monotone MLP
models the cumulative distribution, and the likelihood of an integer bin
is ``sigmoid(logits(v + 0.5)) - sigmoid(logits(v - 0.5))``. Training adds
uniform noise; eval rounds around the learned median. The auxiliary
quantile loss reaches only ``quantiles``: it reads the MLP's parameters
detached.

Parameters carry the flax names and shapes: ``matrix_i`` (C, out, in),
``bias_i`` (C, out, 1), ``factor_i`` (C, out, 1) and ``quantiles``
(C, 1, 3). :meth:`EntropyBottleneck.pmf_table` gives the coding tables of
the bitstream.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.math_utils import lower_bound, quantize_dequantize, quantize_noise

LIKELIHOOD_BOUND = 1e-9


class EntropyBottleneck(nn.Module):
    """Per-channel learned CDF over dim 1 of an NCHW tensor."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        self.init_scale = init_scale
        self.tail_mass = tail_mass
        dims = (1,) + self.filters + (1,)
        for i in range(len(self.filters) + 1):
            self.register_parameter(f"matrix_{i}", nn.Parameter(
                torch.empty(channels, dims[i + 1], dims[i])))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.empty(channels, dims[i + 1], 1)))
            if i < len(self.filters):
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.empty(channels, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's init: constant matrices ``log(expm1(1/scale/dims))``,
        biases U(-0.5, 0.5) from ``generator``, zero factors, quantiles
        [-init_scale, 0, init_scale]."""
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / (len(self.filters) + 1))
        for i in range(len(self.filters) + 1):
            getattr(self, f"matrix_{i}").fill_(
                math.log(math.expm1(1.0 / scale / dims[i + 1])))
            b = getattr(self, f"bias_{i}")
            b.copy_(torch.rand(b.shape, generator=generator) - 0.5)
            if i < len(self.filters):
                getattr(self, f"factor_{i}").zero_()
        self.quantiles.copy_(torch.tensor(
            [-self.init_scale, 0.0, self.init_scale]).expand_as(self.quantiles))

    def _logits_cumulative(self, inputs: torch.Tensor,
                           detach: bool) -> torch.Tensor:
        """inputs (C, 1, N) -> logits (C, 1, N)."""
        logits = inputs
        for i in range(len(self.filters) + 1):
            m = getattr(self, f"matrix_{i}")
            b = getattr(self, f"bias_{i}")
            if detach:
                m, b = m.detach(), b.detach()
            logits = torch.bmm(F.softplus(m), logits) + b
            if i < len(self.filters):
                f = getattr(self, f"factor_{i}")
                if detach:
                    f = f.detach()
                logits = logits + torch.tanh(f) * torch.tanh(logits)
        return logits

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1]

    def aux_loss(self) -> torch.Tensor:
        """Quantile pinning loss; its gradient reaches only ``quantiles``."""
        logits = self._logits_cumulative(self.quantiles, detach=True)
        t = math.log(2.0 / self.tail_mass - 1.0)
        target = logits.new_tensor([-t, 0.0, t])
        return (logits - target).abs().sum()

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (B, C, H, W) -> (x_qnt, likelihood), both x's shape. Training
        adds U(-0.5, 0.5) noise from ``generator``; eval rounds around the
        median."""
        if training:
            x_qnt = quantize_noise(x, generator)
        else:
            x_qnt = quantize_dequantize(
                x, self.medians().view(1, -1, *([1] * (x.dim() - 2))))
        c = self.channels
        flat = x_qnt.transpose(0, 1).reshape(c, 1, -1)
        lower = self._logits_cumulative(flat - 0.5, detach=False)
        upper = self._logits_cumulative(flat + 0.5, detach=False)
        sign = -torch.sign(lower + upper).detach()
        lik = (torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower)).abs()
        lik = lower_bound(lik, LIKELIHOOD_BOUND)
        shape = (x_qnt.shape[1], x_qnt.shape[0]) + x_qnt.shape[2:]
        return x_qnt, lik.reshape(shape).transpose(0, 1)

    @torch.no_grad()
    def pmf_table(self):
        """Dense pmf rows for the coding CDF tables (compressAI's
        ``EntropyBottleneck.update``): ``(pmf, tail_mass, pmf_length,
        offset)`` of shapes ``(C, max_len)``, ``(C,)``, ``(C,)``, ``(C,)``,
        the inputs of the host ``pmf_to_quantized_cdf``."""
        q = self.quantiles.detach()
        medians = q[:, 0, 1]
        minima = torch.clamp_min(torch.ceil(medians - q[:, 0, 0]), 0).int()
        maxima = torch.clamp_min(torch.ceil(q[:, 0, 2] - medians), 0).int()
        pmf_length = minima + maxima + 1
        max_length = int(pmf_length.max())
        samples = (torch.arange(max_length, device=q.device)[None, :]
                   - minima[:, None] + medians[:, None])     # (C, max_len)
        flat = samples[:, None, :]
        lower = self._logits_cumulative(flat - 0.5, detach=True)
        upper = self._logits_cumulative(flat + 0.5, detach=True)
        sign = -torch.sign(lower + upper)
        pmf = (torch.sigmoid(sign * upper)
               - torch.sigmoid(sign * lower)).abs()[:, 0, :]
        tail = torch.sigmoid(lower[:, 0, 0]) + torch.sigmoid(-upper[:, 0, -1])
        return pmf, tail, pmf_length, -minima
