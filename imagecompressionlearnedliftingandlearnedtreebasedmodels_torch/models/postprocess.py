"""Restoration (post-processing) nets applied to a codec's reconstruction
(NCHW).

Counterpart of the JAX package's ``models/postprocess.py``: the five nets
that ``config.postprocess`` selects, trained on top of a frozen codec
(``train/postprocess_loop.py``):

- ``DnCNN``    the shallow residual denoiser ``DnCNN(D=clrch, C=64)``;
- ``iwave``    iWave++-style: a head conv, ``resnetlevel`` residual
               blocks, a long skip, a tail conv and a global residual;
- ``IRCNN``    seven 3x3 convs at dilations 1, 2, 3, 4, 3, 2, 1;
- ``DIDN``     six down-up residual blocks and a shared reconstruction
               block, with pixel-shuffle upsampling;
- ``DUDnCNN``  DnCNN with a dilation schedule in place of pooling.

Every stride-1, undilated 3x3 conv is a :class:`FastConv3x3`, so on the
card it runs on the fp32 conv kernel (``csrc/conv3x3_halo.cu``), forward
and dx; the dilated, the stride-2 and the 1x1 convs are ``F.conv2d``
(:class:`..ops.fast_conv.Conv2d`), as the JAX package computes all of them
with ``nn.Conv``. Modules are named as flax names them (``Conv_0``,
``BatchNorm_0``, ``PReLU_0``, ``PostProcessResidual_0``, ...), so
``tools/weights.py`` carries a flax ``variables`` tree both ways.

:class:`BatchNorm` is flax's ``nn.BatchNorm``, not ``nn.BatchNorm2d``:
epsilon is the width (64: the original passes ``BatchNorm2d(C, C)``),
momentum 0.99 on the running statistics, and the batch variance is the
biased ``E[x^2] - E[x]^2`` in the normalization and in the running update
alike. :class:`PReLU` is flax's: one scalar slope, initialised to 0.01.
Every net takes ``forward(x, train=False)``; ``train`` normalizes with the
batch's statistics and updates the running ones.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from ..config import Config
from ..ops import register_list
from ..ops.fast_conv import Conv2d, FastConv3x3


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth to space; NCHW ``F.pixel_shuffle`` has the channel order of the
    JAX package's NHWC ``pixel_shuffle``."""
    return nn.functional.pixel_shuffle(x, r)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW channels: parameters ``scale`` and
    ``bias``, running statistics ``mean`` and ``var`` (flax's
    ``batch_stats``) as buffers."""

    def __init__(self, channels: int, epsilon: float, momentum: float = 0.99):
        super().__init__()
        self.epsilon, self.momentum = float(epsilon), momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean = x.mean((0, 2, 3))
            var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)


class PReLU(nn.Module):
    """flax ``nn.PReLU``: one scalar ``negative_slope``, 0.01 at init."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope * x)


def conv3x3(cin: int, cout: int, bias: bool = True,
            dilation: int = 1) -> nn.Module:
    """A SAME 3x3 conv: kernel 1 where it is undilated, ``F.conv2d``
    otherwise."""
    if dilation == 1:
        return FastConv3x3(cin, cout, bias=bias)
    return Conv2d(cin, cout, 3, bias=bias, dilation=dilation)


class DnCNN(nn.Module):
    """conv-relu, ``depth`` x (conv-BN-relu), conv, plus the input (the
    original's module-scope ``DnCNN(D=clrch, C=64)``)."""

    def __init__(self, depth: int, channels: int = 3, features: int = 64):
        super().__init__()
        widths = [channels] + [features] * (depth + 1) + [channels]
        self.convs = register_list(self, "Conv", [
            conv3x3(a, b) for a, b in zip(widths[:-1], widths[1:])])
        self.bns = register_list(self, "BatchNorm", [
            BatchNorm(features, features) for _ in range(depth)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.convs[0](x))
        for conv, bn in zip(self.convs[1:-1], self.bns):
            h = torch.relu(bn(conv(h), train))
        return self.convs[-1](h) + x


class PostProcessResidual(nn.Module):
    """conv-relu-conv residual block."""

    def __init__(self, width: int):
        super().__init__()
        self.Conv_0 = conv3x3(width, width)
        self.Conv_1 = conv3x3(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.Conv_1(torch.relu(self.Conv_0(x)))


class PostProcessingiWave(nn.Module):
    """Head conv, ``resnetlevel`` residual blocks, a conv and the long skip,
    the tail conv and the global residual; width ``clrch * 64``."""

    def __init__(self, cfg: Config, channels: int = 3):
        super().__init__()
        width = cfg.clrch * 64
        self.Conv_0 = conv3x3(channels, width)
        self.blocks = register_list(self, "PostProcessResidual", [
            PostProcessResidual(width) for _ in range(cfg.resnetlevel)])
        self.Conv_1 = conv3x3(width, width)
        self.Conv_2 = conv3x3(width, channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        t1 = self.Conv_0(x)
        t2 = t1
        for blk in self.blocks:
            t2 = blk(t2)
        return self.Conv_2(self.Conv_1(t2) + t1) + x


class IRCNN(nn.Module):
    """Seven 3x3 convs at dilations 1, 2, 3, 4, 3, 2, 1 (relu between);
    the output is the input minus the last."""

    DILATIONS = (1, 2, 3, 4, 3, 2, 1)

    def __init__(self, channels: int = 3, features: int = 64):
        super().__init__()
        n = len(self.DILATIONS)
        widths = [channels] + [features] * (n - 1) + [channels]
        self.convs = register_list(self, "Conv", [
            conv3x3(widths[i], widths[i + 1], dilation=d)
            for i, d in enumerate(self.DILATIONS)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        for conv in self.convs[:-1]:
            h = torch.relu(conv(h))
        return x - self.convs[-1](h)


def _conv_nb(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Module:
    """DIDN's bias-free convs: kernel 1 for a stride-1 3x3; stride 2 pads
    one on each side, PyTorch's ``Conv2d(k=3, s=2, padding=1)``."""
    if k == 3 and stride == 1:
        return conv3x3(cin, cout, bias=False)
    return Conv2d(cin, cout, k, bias=False, stride=stride)


class _DIDNResidualBlock(nn.Module):
    """DIDN's down-up residual block (the original's ``_Residual_Block``):
    two levels down by stride-2 convs, back up by pixel shuffles."""

    def __init__(self, width: int):
        super().__init__()
        w = width
        specs = [(w, w), (w, w), (w, 2 * w, 3, 2), (2 * w, 2 * w),
                 (2 * w, 4 * w, 3, 2), (4 * w, 4 * w), (4 * w, 8 * w, 1),
                 (4 * w, 2 * w, 1), (2 * w, 2 * w), (2 * w, 4 * w, 1),
                 (2 * w, w, 1), (w, w), (w, w), (w, w)]
        self.convs = register_list(self, "Conv", [_conv_nb(*s) for s in specs])
        self.prelus = register_list(self, "PReLU", [PReLU() for _ in range(9)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, p = self.convs, self.prelus
        res1 = x
        out = p[1](c[1](p[0](c[0](x)))) + res1
        cat1 = out
        out = p[2](c[2](out))
        out = p[3](c[3](out)) + out
        cat2 = out
        out = p[4](c[4](out))
        out = p[5](c[5](out)) + out
        out = pixel_shuffle(c[6](out), 2)
        out = c[7](torch.cat([out, cat2], 1))
        out = p[6](c[8](out)) + out
        out = pixel_shuffle(c[9](out), 2)
        out = c[10](torch.cat([out, cat1], 1))
        res5 = out
        out = p[8](c[12](p[7](c[11](out)))) + res5
        return c[13](out) + res1


class _DIDNReconBlock(nn.Module):
    """Four conv-PReLU pairs with a skip each, a conv and the block skip."""

    def __init__(self, width: int):
        super().__init__()
        self.convs = register_list(self, "Conv", [
            _conv_nb(width, width) for _ in range(9)])
        self.prelus = register_list(self, "PReLU", [PReLU() for _ in range(8)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, p = self.convs, self.prelus
        out = x
        for i in range(4):
            out = p[2 * i + 1](c[2 * i + 1](p[2 * i](c[2 * i](out)))) + out
        return c[8](out) + x


class DIDN(nn.Module):
    """Deep iterative down-up net: a head at half resolution, six residual
    blocks, the shared reconstruction block on each block's output, a
    fusion conv, and the tail after a pixel shuffle back to full
    resolution."""

    def __init__(self, cfg: Config, width: int = 64, channels: int = 3):
        super().__init__()
        w = width
        self.convs = register_list(self, "Conv", [
            _conv_nb(channels, w), _conv_nb(w, w, 3, 2),
            _conv_nb(6 * w, w, 1), _conv_nb(w, w),
            _conv_nb(w // 4, channels)])
        self.prelus = register_list(self, "PReLU", [PReLU() for _ in range(4)])
        self.blocks = register_list(self, "_DIDNResidualBlock", [
            _DIDNResidualBlock(w) for _ in range(6)])
        self._DIDNReconBlock_0 = _DIDNReconBlock(w)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c, p = self.convs, self.prelus
        out = p[1](c[1](p[0](c[0](x))))
        outs: List[torch.Tensor] = []
        for blk in self.blocks:
            out = blk(out)
            outs.append(out)
        out = torch.cat([self._DIDNReconBlock_0(o) for o in outs], 1)
        out = p[2](c[2](out))
        out = p[3](c[3](out)) + out
        return c[4](pixel_shuffle(out, 2)) + x


def dudncnn_dilations(depth: int) -> List[int]:
    """DUDnCNN's dilation per conv (``depth + 2`` of them): up to
    ``2 ** (depth // 2 - 1)`` and back down."""
    D = depth
    k = [0] + list(range(D // 2)) + [max(D // 2 - 1, 0)] * (D + 1 - D // 2)
    ell = [0] * (D // 2 + 1) + list(range(D + 1 - (D // 2 + 1)))
    ell.append(ell[-1])
    return [2 ** (a - b) for a, b in zip(k, ell)][: D + 2]


class DUDnCNN(nn.Module):
    """Dilated-U DnCNN: ``resnetlevel`` conv-BN-relu layers whose dilation
    grows and shrinks; the second half adds the first half's maps back,
    scaled by 1/sqrt(2)."""

    def __init__(self, cfg: Config, channels: int = 3, features: int = 64):
        super().__init__()
        D = self.depth = cfg.resnetlevel
        dil = dudncnn_dilations(D)
        widths = [channels] + [features] * (D + 1) + [channels]
        self.convs = register_list(self, "Conv", [
            conv3x3(widths[i], widths[i + 1], dilation=dil[i])
            for i in range(D + 2)])
        self.bns = register_list(self, "BatchNorm", [
            BatchNorm(features, features) for _ in range(D)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        D, c, bn = self.depth, self.convs, self.bns
        h = torch.relu(c[0](x))
        h_buff = []
        for i in range(D // 2 - 1):
            h = torch.relu(bn[i](c[i + 1](h), train))
            h_buff.append(h)
        for i in range(D // 2 - 1, D // 2 + 1):
            h = torch.relu(bn[i](c[i + 1](h), train))
        for i in range(D // 2 + 1, D):
            j = i - (D // 2 + 1) + 1
            h = torch.relu(bn[i](c[i + 1]((h + h_buff[-j]) / math.sqrt(2)),
                                 train))
        return c[D + 1](h) + x


def make_postprocess(cfg: Config,
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Module:
    """The restoration net ``cfg.postprocess`` names, its conv weights drawn
    from ``generator`` as the codec's are (lecun_normal, zero biases)."""
    from .codec import reset_conv_weights

    kind = cfg.postprocess
    if kind == "DnCNN":
        net = DnCNN(depth=cfg.clrch)
    elif kind == "iwave":
        net = PostProcessingiWave(cfg)
    elif kind == "IRCNN":
        net = IRCNN(channels=3)
    elif kind == "DIDN":
        net = DIDN(cfg)
    elif kind == "DUDnCNN":
        net = DUDnCNN(cfg)
    else:
        raise ValueError(f"unknown postprocess {kind!r}")
    reset_conv_weights(net, generator)
    return net
