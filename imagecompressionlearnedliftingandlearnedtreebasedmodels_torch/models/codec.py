"""Codec graphs (NCHW).

``LiftingDWTCodec`` = analysis transform -> entropy model -> synthesis.
``CodecWrapper`` handles the color-channel policy: ``clrch == 3`` runs one
codec on joint RGB; ``clrch == 1`` runs three independent codecs on the Y,
Cb, Cr planes and concatenates their outputs.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from ..config import Config
from ..entropy.bottleneck import EntropyBottleneck
from ..entropy.models import make_entropy_model
from ..ops.cbam import CBAMPostProcessing, GroupNorm
from ..ops.fast_conv import (Conv2d, ConvTranspose2d, FastConv3x3,
                             StridedConv2d)
from ..ops.masked_conv import ChannelIncrementalConv2d
from ..ops.upscaling import ConvTranspose2x2
from ..utils.profiling import span
from .transforms import QuincunxLiftingTransform, make_transform


class LiftingDWTCodec(nn.Module):
    """Single color-group codec: transform + entropy + inverse transform;
    the call of the entropy model is the span ``codec.entropy``, of its
    aux loss ``entropy.aux_loss`` (``utils/profiling.py``)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.transform = make_transform(cfg)
        self.entropymodel = make_entropy_model(cfg)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None):
        # integer lifting draws its training noise from the generator too
        lifting = isinstance(self.transform, QuincunxLiftingTransform)
        kw = dict(training=training, generator=generator) if lifting else {}
        xe, xo_list = self.transform.encode(x, **kw)
        with span("codec.entropy"):
            info_xe, info_xo_list, xe_qnt, xo_qnt = self.entropymodel(
                xe, xo_list, training, generator)
        xhat = self.transform.decode(xe_qnt, xo_qnt, **kw)
        return xhat, info_xe, info_xo_list

    def aux_loss(self) -> torch.Tensor:
        with span("entropy.aux_loss"):
            return self.entropymodel.aux_loss()


class CodecWrapper(nn.Module):
    """Color-policy wrapper; ``forward(x, training=False, generator=None)``
    returns ``(xhat, info_xe, info_xo_list, aux_loss)``. In training the
    quantizers add uniform noise drawn from ``generator``; the default is
    the eval forward (hard rounding).

    Conv and dense weights start from flax's ``lecun_normal`` (std
    1/sqrt(fan_in)) drawn from ``generator``; biases start at zero and the
    GDN, GroupNorm, CBAM skip and lifting skip parameters at their defined
    values; entropy bottlenecks take flax's init, their biases drawn from
    ``generator`` too.
    """

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.clrch not in (1, 3):
            raise ValueError("clrch must be 1 or 3")
        if cfg.clrch == 3:
            self.codec = LiftingDWTCodec(cfg)
        else:
            self.codecs = nn.ModuleList([LiftingDWTCodec(cfg)
                                         for _ in range(3)])
        reset_conv_weights(self, generator)
        for m in self.modules():
            if isinstance(m, EntropyBottleneck):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None):
        if self.cfg.clrch == 3:
            xhat, info_xe, info_xo = self.codec(x, training, generator)
            return xhat, info_xe, info_xo, self.codec.aux_loss()
        outs = [self.codecs[i](x[:, i:i + 1], training, generator)
                for i in range(3)]
        xhat = torch.cat([o[0] for o in outs], dim=1)
        info_xe = torch.cat([o[1] for o in outs], dim=1)
        info_xo_list: List = []
        for o in outs:
            info_xo_list.extend(o[2])
        aux = sum(c.aux_loss() for c in self.codecs)
        return xhat, info_xe, info_xo_list, aux


_LECUN = (Conv2d, FastConv3x3, StridedConv2d, ChannelIncrementalConv2d,
          nn.Linear)
_TRANSPOSED = (ConvTranspose2x2, ConvTranspose2d)   # weight (in, out, kh, kw)


@torch.no_grad()
def reset_conv_weights(model: nn.Module,
                       generator: Optional[torch.Generator] = None) -> None:
    """lecun_normal conv and dense weights (truncated normal with std
    1/sqrt(fan_in) at +-2 std, as flax's initializer) and zero biases, the
    bias-free convs included; GroupNorm at scale 1 and bias 0, the CBAM
    head's skip weight at 0.1. A transposed conv's fan-in is its input
    channels times its taps, as flax counts it."""
    for m in model.modules():
        if isinstance(m, _LECUN + _TRANSPOSED):
            fan_in = (m.weight[:, 0] if isinstance(m, _TRANSPOSED)
                      else m.weight[0]).numel()
            # flax divides by the std of the unit normal truncated at +-2
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            m.weight.copy_(w * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, GroupNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, CBAMPostProcessing):
            m.res_weight.fill_(0.1)
