"""Analysis/synthesis transforms (NCHW).

``encode(x) -> (xe, xo_list)`` and ``decode(xe, xo_list) -> xhat``, where
``xe`` is the coarsest LL subband after its scaling AE and ``xo_list[i]``
the level-i detail pack ``(B, 3C, H/2^{i+1}, W/2^{i+1})``, finest first.
The packs' channel orders differ as in the JAX package: the 9/7 and
learned-lifting transforms interleave (LH, HL, HH) per channel
(:func:`..ops.dwt97.pack_details`), quincunx ``hv`` concatenates the LH,
HL and HH blocks, and BasicWavelet passes its conv's last 3C channels.
``QuincunxLiftingTransform``'s ``encode``/``decode`` also take
``training`` and the ``generator`` of its integer-lifting noise.
Every ``encode`` and ``decode`` is a span, ``codec.encode`` and
``codec.decode`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..config import Config, compute_dtype
from ..ops import dwt97, register_list
from ..ops.cbam import CBAMPostProcessing
from ..ops.fast_conv import Conv2d, ConvTranspose2d, StridedConv2d
from ..ops.gdn import GDN
from ..ops.lifting import LiftStage, lift_level_forward, lift_level_inverse
from ..ops.quincunx import (QuincunxHorVerNet, QuincunxLiftingNet,
                            quincunx_merge, quincunx_split,
                            split_mode_channels)
from ..ops.subband_ae import make_subband_ae
from ..utils.profiling import spanned


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

    @spanned("codec.encode")
    def encode(self, x: torch.Tensor):
        ll, highs = dwt97.dwt97_forward(x, self.cfg.dwtlevels)
        return self.yl_ae.encode(ll), [ae.encode(h)
                                       for ae, h in zip(self.yh_ae, highs)]

    @spanned("codec.decode")
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

    @spanned("codec.encode")
    def encode(self, x: torch.Tensor):
        ll = x
        xo_list: List[torch.Tensor] = []
        for lvl in range(self.cfg.dwtlevels):
            ll, lh, hl, hh = lift_level_forward(self._stage(lvl), ll)
            xo_list.append(self.yh_ae[lvl].encode(
                dwt97.pack_details(lh, hl, hh)))
        return self.yl_ae.encode(ll), xo_list

    @spanned("codec.decode")
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


class BasicWaveletTransform(nn.Module):
    """Strided-conv "wavelet": per level a stride-2 3x3 conv to 4C channels
    (C -> LL, 3C -> details), with ``linearity_flag`` a GDN and a 3x3 conv
    after it; inverted by a learned transposed conv (the reconstruction is
    learned, not algebraic). Without ``linearity_flag`` the extra conv and
    the GDN of each side do not exist (encode never calls ``fwd_{i}_1``,
    decode never ``inv_{i}_0``, so flax creates no parameters for them).
    ``fwd_{i}`` counts from the finest level, ``inv_{i}`` from the
    coarsest. Its AEs take no compute dtype, as in the JAX package."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.clrch
        self.use_gdn = bool(cfg.linearity_flag)
        self.down, self.post, self.pre, self.up = [], [], [], []
        self.fwd_gdn, self.inv_gdn = [], []
        for i in range(cfg.dwtlevels):
            self.down.append(self._add(f"fwd_{i}_0", StridedConv2d(c, 4 * c)))
            self.up.append(self._add(f"inv_{i}_1",
                                     ConvTranspose2d(4 * c, c)))
            if self.use_gdn:
                self.post.append(self._add(f"fwd_{i}_1",
                                           Conv2d(4 * c, 4 * c, 3)))
                self.pre.append(self._add(f"inv_{i}_0",
                                          Conv2d(4 * c, 4 * c, 3)))
                self.fwd_gdn.append(self._add(f"fwd_gdn_{i}", GDN(4 * c)))
                self.inv_gdn.append(self._add(f"inv_gdn_{i}",
                                              GDN(4 * c, inverse=True)))
        self.yl_ae = make_subband_ae(cfg.autoencoder, 1 * c)
        self.yh_ae = register_list(self, "yh_ae", [
            make_subband_ae(cfg.autoencoder, 3 * c)
            for _ in range(cfg.dwtlevels)])

    def _add(self, name: str, module: nn.Module) -> nn.Module:
        self.add_module(name, module)
        return module

    @spanned("codec.encode")
    def encode(self, x: torch.Tensor):
        c = self.cfg.clrch
        ll = x
        xo_list = []
        for i in range(self.cfg.dwtlevels):
            h = self.down[i](ll)
            if self.use_gdn:
                h = self.post[i](self.fwd_gdn[i](h))
            ll, details = h[:, :c], h[:, c:]
            xo_list.append(self.yh_ae[i].encode(details))
        return self.yl_ae.encode(ll), xo_list

    @spanned("codec.decode")
    def decode(self, xe: torch.Tensor, xo_list) -> torch.Tensor:
        levels = self.cfg.dwtlevels
        ll = self.yl_ae.decode(xe)
        for i in range(levels):
            lvl = levels - 1 - i
            h = torch.cat([ll, self.yh_ae[lvl].decode(xo_list[lvl])], 1)
            if self.use_gdn:
                h = self.inv_gdn[i](self.pre[i](h))
            ll = self.up[i](h)
        return ll

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xe, xo_list = self.encode(x)
        return self.decode(xe, xo_list)


class AttentionWaveletTransform(nn.Module):
    """The fixed 9/7 DWT with a softmax boost of LL from the coarsest LH+HL
    (softmax over the channels; with one channel it is 1 and LL doubles),
    applied on the analysis side only, as in the JAX package: synthesis
    does not invert it. The AEs are ``SubbandAutoEncoder`` whatever the
    config says. ``with_postprocess`` adds the CBAM restoration head after
    synthesis (``AttentionWaveletPostProcessing``)."""

    def __init__(self, cfg: Config, with_postprocess: bool = False):
        super().__init__()
        self.cfg = cfg
        c = cfg.clrch
        self.yl_ae = make_subband_ae("SubbandAutoEncoder", 1 * c)
        self.yh_ae = register_list(self, "yh_ae", [
            make_subband_ae("SubbandAutoEncoder", 3 * c)
            for _ in range(cfg.dwtlevels)])
        self.postprocess = CBAMPostProcessing(c) if with_postprocess else None

    @spanned("codec.encode")
    def encode(self, x: torch.Tensor):
        ll, highs = dwt97.dwt97_forward(x, self.cfg.dwtlevels)
        lh, hl, _ = dwt97.unpack_details(highs[-1])
        ll = ll + ll * torch.softmax(lh + hl, dim=1)
        return self.yl_ae.encode(ll), [ae.encode(h)
                                       for ae, h in zip(self.yh_ae, highs)]

    @spanned("codec.decode")
    def decode(self, xe: torch.Tensor, xo_list) -> torch.Tensor:
        xhat = dwt97.dwt97_inverse(
            self.yl_ae.decode(xe),
            [ae.decode(xo) for ae, xo in zip(self.yh_ae, xo_list)])
        return xhat if self.postprocess is None else self.postprocess(xhat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xe, xo_list = self.encode(x)
        return self.decode(xe, xo_list)


class QuincunxLiftingTransform(nn.Module):
    """Multi-level quincunx / polyphase lifting with optional integer
    lifting (``lif_prec_bits``). ``split_mode`` 'hv' composes a horizontal
    and two vertical lifts into (LL, [LH | HL | HH]); the polyphase modes
    lift the odd cosets from the even ones, and modes 2 and 3 grow LL's
    channels every level (their packs do not fit the entropy models' 3C
    details: they run with ``autoencoder="none"`` and no entropy model).
    fp32 throughout: the JAX package gives these nets no compute dtype.

    ``encode(x, training=False, generator=None)`` and ``decode``: in
    training the lifting rounding adds uniform noise drawn from
    ``generator``; in eval it rounds to the integer grid."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        mode, se, so = split_mode_channels(cfg.split_mode)
        self.mode = mode
        self.precision_bits = cfg.lif_prec_bits
        c = cfg.clrch
        layers = []
        ch = c
        for _ in range(cfg.dwtlevels):
            if mode == "hor":
                layers.append(QuincunxHorVerNet(
                    ch, cfg.lif_prec_bits, cfg.num_lifting_perlayer))
            else:
                layers.append(QuincunxLiftingNet(
                    se * ch, so * ch, se * ch, so * ch, cfg.lif_prec_bits,
                    cfg.num_lifting_perlayer))
                ch = se * ch
        self.layers = register_list(self, "layers", layers)
        self.yl_ae = make_subband_ae(cfg.autoencoder, 1 * c)
        self.yh_ae = register_list(self, "yh_ae", [
            make_subband_ae(cfg.autoencoder, 3 * c)
            for _ in range(cfg.dwtlevels)])

    def _noise(self, training: bool, generator):
        if not training:
            return None
        if generator is None and self.precision_bits > 0:
            raise ValueError("integer lifting in training needs an explicit "
                             "torch.Generator for its noise")
        return generator

    @spanned("codec.encode")
    def encode(self, x: torch.Tensor, training: bool = False,
               generator=None):
        gen = self._noise(training, generator)
        xe = x
        xo_list = []
        for layer, ae in zip(self.layers, self.yh_ae):
            even, odd = quincunx_split(xe, self.mode)
            xe, xo = layer.forward_lifting(even, odd, gen)
            xo_list.append(ae.encode(xo))
        return self.yl_ae.encode(xe), xo_list

    @spanned("codec.decode")
    def decode(self, xe: torch.Tensor, xo_list, training: bool = False,
               generator=None) -> torch.Tensor:
        gen = self._noise(training, generator)
        xe = self.yl_ae.decode(xe)
        for i in range(self.cfg.dwtlevels - 1, -1, -1):
            xo = self.yh_ae[i].decode(xo_list[i])
            even, odd = self.layers[i].inverse_lifting(xe, xo, gen)
            xe = quincunx_merge(even, odd, self.mode)
        return xe

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xe, xo_list = self.encode(x)
        return self.decode(xe, xo_list)


def make_transform(cfg: Config) -> nn.Module:
    if cfg.netType == "CDF97":
        return CDF97Transform(cfg)
    if cfg.netType == "LiftingBasedNeuralWaveletv4":
        return LearnedLiftingTransform(cfg)
    if cfg.netType == "BasicWavelet":
        return BasicWaveletTransform(cfg)
    if cfg.netType == "AttentionWavelet":
        return AttentionWaveletTransform(cfg)
    if cfg.netType == "AttentionWaveletPostProcessing":
        return AttentionWaveletTransform(cfg, with_postprocess=True)
    if cfg.netType == "QuincunxLifting":
        return QuincunxLiftingTransform(cfg)
    raise ValueError(f"unknown netType {cfg.netType!r}")
