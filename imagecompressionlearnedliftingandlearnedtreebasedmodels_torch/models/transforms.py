"""Analysis/synthesis transforms (NCHW).

``encode(x) -> (xe, xo_list)`` and ``decode(xe, xo_list) -> xhat``, where
``xe`` is the coarsest LL subband after its scaling AE and ``xo_list[i]``
the level-i detail pack ``(B, 3C, H/2^{i+1}, W/2^{i+1})``, finest first.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..config import Config, compute_dtype
from ..ops import dwt97, register_list
from ..ops.lifting import LiftStage, lift_level_forward, lift_level_inverse
from ..ops.subband_ae import make_subband_ae


class CDF97Transform(nn.Module):
    """Fixed 9/7 DWT (:mod:`..ops.dwt97`) + per-subband scaling AEs."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.clrch
        dt = compute_dtype(cfg)
        self.yl_ae = make_subband_ae(cfg.autoencoder, 1 * c, dt)
        self.yh_ae = register_list(self, "yh_ae", [
            make_subband_ae(cfg.autoencoder, 3 * c, dt)
            for _ in range(cfg.dwtlevels)])

    def encode(self, x: torch.Tensor):
        ll, highs = dwt97.dwt97_forward(x, self.cfg.dwtlevels)
        return self.yl_ae.encode(ll), [ae.encode(h)
                                       for ae, h in zip(self.yh_ae, highs)]

    def decode(self, xe: torch.Tensor, xo_list) -> torch.Tensor:
        return dwt97.dwt97_inverse(
            self.yl_ae.decode(xe),
            [ae.decode(xo) for ae, xo in zip(self.yh_ae, xo_list)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xe, xo_list = self.encode(x)
        return self.decode(xe, xo_list)


class LearnedLiftingTransform(nn.Module):
    """Learned nonlinear lifting DWT + per-subband scaling AEs.

    ``block_property == 'same'`` shares one lifting stage across all levels
    (the paper's configuration); ``'different'`` gives each level its own.
    """

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.clrch
        hidden = cfg.depth_scale * 8 * c
        num_stages = 1 if cfg.block_property == "same" else cfg.dwtlevels
        dt = compute_dtype(cfg)
        self.stages = register_list(self, "stages", [
            LiftStage(channels=c, hidden=hidden, filtersize=cfg.filtersize,
                      num_pairs=cfg.num_lifting_perlayer,
                      nonlinear=bool(cfg.linearity_flag),
                      res_weight=cfg.res_connection_weight,
                      use_scale=bool(cfg.scale), dtype=dt)
            for _ in range(num_stages)])
        self.yl_ae = make_subband_ae(cfg.autoencoder, 1 * c, dt)
        self.yh_ae = register_list(self, "yh_ae", [
            make_subband_ae(cfg.autoencoder, 3 * c, dt)
            for _ in range(cfg.dwtlevels)])

    def _stage(self, level: int) -> LiftStage:
        return self.stages[0 if self.cfg.block_property == "same" else level]

    def encode(self, x: torch.Tensor):
        ll = x
        xo_list: List[torch.Tensor] = []
        for lvl in range(self.cfg.dwtlevels):
            ll, lh, hl, hh = lift_level_forward(self._stage(lvl), ll)
            xo_list.append(self.yh_ae[lvl].encode(
                dwt97.pack_details(lh, hl, hh)))
        return self.yl_ae.encode(ll), xo_list

    def decode(self, xe: torch.Tensor, xo_list) -> torch.Tensor:
        ll = self.yl_ae.decode(xe)
        for lvl in range(self.cfg.dwtlevels - 1, -1, -1):
            lh, hl, hh = dwt97.unpack_details(self.yh_ae[lvl].decode(
                xo_list[lvl]))
            ll = lift_level_inverse(self._stage(lvl), ll, lh, hl, hh)
        return ll

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xe, xo_list = self.encode(x)
        return self.decode(xe, xo_list)


def make_transform(cfg: Config) -> nn.Module:
    if cfg.netType == "CDF97":
        return CDF97Transform(cfg)
    if cfg.netType == "LiftingBasedNeuralWaveletv4":
        return LearnedLiftingTransform(cfg)
    raise NotImplementedError(f"netType {cfg.netType!r} is not ported yet")
