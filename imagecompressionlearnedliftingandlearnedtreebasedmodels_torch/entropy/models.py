"""Subband entropy models over the wavelet pyramid (NCHW).

``model(xe, xo_list, training=False, generator=None) ->
(info_xe, info_xo_list, xe_qnt, xo_list_qnt)``: per-sample
self-informations in bits and the quantized subbands fed to the synthesis
transform (hard-rounded in eval; with additive uniform noise drawn from
``generator`` in training).

- ``FactorizedEntropy``: one learned-CDF bottleneck per level plus one for
  LL (the CDF 9/7 + factorized codec).
- ``ZTSepSubbands``: zerotree + causal spatial context (the paper's main
  model). Per finer level a parent-context CNN (plc) on the x2-upsampled
  quantized parent details, a 5x5 masked type-A grouped conv (csc) on the
  current quantized details, fused by a grouped 1x1 stack (cgp) into
  interleaved (sigma, mu). The coarsest details and LL use grouped masked
  PixelCNNs.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, compute_dtype
from ..ops import register_list
from ..ops.fast_conv import Conv2d, FastConv3x3
from ..ops.masked_conv import MaskedConv2d
from ..ops.math_utils import quantize_dequantize, quantize_noise
from . import gaussian
from .bottleneck import EntropyBottleneck


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _split_sigma_mu(params: torch.Tensor):
    """Interleaved (sigma, mu) channel pairs -> (sigma, mu)."""
    return params[:, 0::2], params[:, 1::2]


def _quantize_ctx(x: torch.Tensor, training: bool, generator) -> torch.Tensor:
    """Context quantization: noise in training, plain rounding in eval."""
    return quantize_noise(x, generator) if training else quantize_dequantize(x)


class _ConvStack(nn.Module):
    """Conv -> LReLU -> ... -> Conv, SAME padding (fp32 output). Dense 3x3
    layers run through ``conv3x3_halo``."""

    def __init__(self, in_ch: int, features: Sequence[int],
                 kernels: Sequence[int], groups: int = 1, dtype=None):
        super().__init__()
        layers = []
        cin = in_ch
        for f, k in zip(features, kernels):
            if k == 3 and groups == 1:
                layers.append(FastConv3x3(cin, f, dtype))
            else:
                layers.append(Conv2d(cin, f, k, groups=groups, dtype=dtype))
            cin = f
        self.layers = register_list(self, "Conv", layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.leaky_relu(x, 0.01)
        return x.float()


class _MaskedPixelCNN(nn.Module):
    """5-layer grouped masked 3x3 stack A,B,B,B,B -> (sigma, mu) pairs."""

    def __init__(self, in_ch: int, dtype=None):
        super().__init__()
        wide = in_ch * 81
        feats = [wide, wide, wide // 3, wide // 9, 2 * in_ch]
        layers = []
        cin = in_ch
        for i, f in enumerate(feats):
            layers.append(MaskedConv2d(cin, f, 3,
                                       mask_type="A" if i == 0 else "B",
                                       groups=in_ch, dtype=dtype))
            cin = f
        self.layers = register_list(self, "MaskedConv2d", layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.leaky_relu(x, 0.01)
        return x.float()


class FactorizedEntropy(nn.Module):
    """Per-level factorized bottlenecks ``eb_xo_i`` plus ``eb_xe`` for LL."""

    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg.clrch
        self.eb_xo = register_list(self, "eb_xo", [
            EntropyBottleneck(3 * c) for _ in range(cfg.dwtlevels)])
        self.eb_xe = EntropyBottleneck(1 * c)

    def forward(self, xe: torch.Tensor, xo_list, training: bool = False,
                generator=None):
        """Noise is drawn in the JAX package's order: levels 0..L-1, then
        LL."""
        info_xo: List = []
        xo_qnt: List = []
        for eb, xo in zip(self.eb_xo, xo_list):
            q, lik = eb(xo, training, generator)
            xo_qnt.append(q)
            info_xo.append(-torch.log2(lik))
        xe_qnt, lik_xe = self.eb_xe(xe, training, generator)
        return -torch.log2(lik_xe), info_xo, xe_qnt, xo_qnt

    def aux_loss(self) -> torch.Tensor:
        return self.eb_xe.aux_loss() + sum(eb.aux_loss() for eb in self.eb_xo)


class ZTSepSubbands(nn.Module):
    """Zerotree + causal spatial context entropy model."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.clrch
        L = cfg.dwtlevels
        dt = compute_dtype(cfg)
        so = 3 * c
        wide = so * 81
        fused = 2 * wide
        self.plc = register_list(self, "plc", [
            _ConvStack(so, (wide, wide), (3, 3), dtype=dt)
            for _ in range(L - 1)])
        self.csc = register_list(self, "csc", [
            MaskedConv2d(so, wide, 5, mask_type="A", groups=so, dtype=dt)
            for _ in range(L - 1)])
        self.cgp = register_list(self, "cgp", [
            _ConvStack(fused, (fused, fused // 3, fused // 9, 2 * so),
                       (1, 1, 1, 1), groups=so, dtype=dt)
            for _ in range(L - 1)])
        self.pixelcnn_xo = _MaskedPixelCNN(so, dtype=dt)
        self.pixelcnn_xe = _MaskedPixelCNN(c, dtype=dt)

    def _fuse(self, plc_params: torch.Tensor,
              csc_params: torch.Tensor) -> torch.Tensor:
        """Interleave per-subband 81-channel blocks as (plc_g, csc_g) pairs,
        so group g of the cgp stack sees only subband g's context."""
        so = 3 * self.cfg.clrch
        b, _, h, w = plc_params.shape
        p = plc_params.reshape(b, so, 81, h, w)
        s = csc_params.reshape(b, so, 81, h, w)
        return torch.cat([p, s], dim=2).reshape(b, so * 162, h, w)

    def level_params(self, i: int, xo_qnt_i: torch.Tensor, con: torch.Tensor):
        """(sigma, mu) for finer level i from its quantized details and the
        upsampled parent context."""
        csc_params = self.csc[i](xo_qnt_i)
        plc_params = self.plc[i](con)
        return _split_sigma_mu(self.cgp[i](self._fuse(plc_params, csc_params)))

    def coarsest_params(self, xo_qnt: torch.Tensor):
        return _split_sigma_mu(self.pixelcnn_xo(xo_qnt))

    def xe_params(self, xe_qnt: torch.Tensor):
        return _split_sigma_mu(self.pixelcnn_xe(xe_qnt))

    def forward(self, xe: torch.Tensor, xo_list, training: bool = False,
                generator=None):
        """Noise is drawn in the JAX package's order: per subband first the
        context's, then the likelihood's; LL, coarsest details, then finer."""
        L = self.cfg.dwtlevels
        noise = (training, generator)
        # LL: causal PixelCNN over its own quantized plane
        xe_qnt = _quantize_ctx(xe, *noise)
        sigma, mu = self.xe_params(xe_qnt)
        _, info_xe = gaussian.self_information_bits(xe, sigma, mu, *noise)

        info_xo: List = [None] * L
        xo_qnt: List = [None] * L
        # coarsest details: own-plane PixelCNN
        q = _quantize_ctx(xo_list[L - 1], *noise)
        sigma, mu = self.coarsest_params(q)
        _, info = gaussian.self_information_bits(xo_list[L - 1], sigma, mu,
                                                 *noise)
        xo_qnt[L - 1], info_xo[L - 1] = q, info
        con = upsample2(q)
        # finer levels: parent + causal context
        for i in range(L - 2, -1, -1):
            q = _quantize_ctx(xo_list[i], *noise)
            sigma, mu = self.level_params(i, q, con)
            _, info = gaussian.self_information_bits(xo_list[i], sigma, mu,
                                                     *noise)
            xo_qnt[i], info_xo[i] = q, info
            con = upsample2(q)
        return info_xe, info_xo, xe_qnt, xo_qnt

    def aux_loss(self) -> torch.Tensor:
        return next(self.parameters()).new_zeros(())


def make_entropy_model(cfg: Config) -> nn.Module:
    if cfg.entropy_layer == "factorized":
        return FactorizedEntropy(cfg)
    if cfg.entropy_layer == "conditioned2ZTsepSubbands":
        return ZTSepSubbands(cfg)
    raise NotImplementedError(
        f"entropy_layer {cfg.entropy_layer!r} is not ported yet")
