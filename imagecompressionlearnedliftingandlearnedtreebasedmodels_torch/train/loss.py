"""Rate-distortion loss.

Keeps the original's rate normalization: rates are
``sum(bits) / numel(x) * 3`` (bits per pixel per color plane, times 3),
whatever ``clrch`` is. Distortion is the mean MSE over the shifted RGB
tensor.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch


class RDLossOutput(NamedTuple):
    loss: torch.Tensor
    mse: torch.Tensor
    rate1: torch.Tensor   # LL (xe) bits per pixel
    rate2: torch.Tensor   # detail (xo) bits per pixel, summed over levels


def rd_loss3(x, xhat, info_xe, info_xo_list: List, lambda_: float,
             rate_weight: float = 1.0) -> RDLossOutput:
    """R + lambda * D; ``rate_weight = 0`` gives the D-only warm-up loss
    while still reporting the rates."""
    numel = float(x.numel())
    mse = torch.mean((x - xhat) ** 2)
    rate1 = torch.sum(info_xe) / numel * 3.0
    rate2 = torch.zeros((), device=x.device)
    for info in info_xo_list:
        rate2 = rate2 + torch.sum(info) / numel * 3.0
    loss = rate_weight * (rate1 + rate2) + lambda_ * mse
    return RDLossOutput(loss, mse, rate1, rate2)


def psnr(x, xhat, peak: float = 1.0) -> torch.Tensor:
    """Per-image PSNR averaged over the batch."""
    mse = torch.mean((x - xhat) ** 2, dim=tuple(range(1, x.dim())))
    return torch.mean(-10.0 * torch.log10(mse / (peak ** 2)))


def rate_loss(self_informations) -> torch.Tensor:
    """Mean self-information: the original's rate-only training loss."""
    return torch.mean(self_informations)


def valid_rd_loss(x, xhat, info_xe, info_xo_list: List, lambda_: float):
    """PSNR-based validation objective: ``(psnr + lambda * rate, psnr,
    rate)``."""
    numel = float(x.numel())
    p = psnr(x, xhat)
    rate = torch.sum(info_xe) / numel * 3.0
    for info in info_xo_list:
        rate = rate + torch.sum(info) / numel * 3.0
    return p + rate * lambda_, p, rate
