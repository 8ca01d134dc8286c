"""Subband entropy models over the wavelet pyramid (NCHW).

``model(xe, xo_list, training=False, generator=None) ->
(info_xe, info_xo_list, xe_qnt, xo_list_qnt)``: per-sample
self-informations in bits and the quantized subbands fed to the synthesis
transform (hard-rounded in eval; with additive uniform noise drawn from
``generator`` in training).

- ``FactorizedEntropy``: one learned-CDF bottleneck per level plus one for
  LL (the CDF 9/7 + factorized codec).
- ``OnlyEZWT``: zerotree-only conditioning. LL and the coarsest details are
  factorized; each finer level gets (sigma, mu) from its decoded parent,
  upsampled (nearest, or the learned ``ZeroTreePreviousLayer``), through a
  parent-context stack. No spatial context: a level decodes in one pass.
- ``ZTSepSubbands``: zerotree + causal spatial context (the paper's main
  model). Per finer level a parent-context CNN (plc) on the x2-upsampled
  quantized parent details, a 5x5 masked type-A grouped conv (csc) on the
  current quantized details, fused by a grouped 1x1 stack (cgp) into
  interleaved (sigma, mu). The coarsest details and LL use grouped masked
  PixelCNNs.
- ``ZTBlock``: polyphase-coset zerotree model. Each subband channel's four
  cosets are coded in turn, each conditioned on the parent channel and the
  cosets before it through its own small ``_DepNet`` pair (sigma, mu), so
  a level decodes in four passes.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, compute_dtype
from ..ops import register_list
from ..ops.fast_conv import Conv2d, FastConv3x3, FastGroupedConv1x1
from ..ops.masked_conv import MaskedConv2d
from ..ops.math_utils import quantize_dequantize, quantize_noise
from ..ops.upscaling import ZeroTreePreviousLayer
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
    layers run through ``conv3x3_halo``; with a compute dtype, grouped 1x1
    layers (the cgp fusion) are ``FastGroupedConv1x1``."""

    def __init__(self, in_ch: int, features: Sequence[int],
                 kernels: Sequence[int], groups: int = 1, dtype=None):
        super().__init__()
        layers = []
        cin = in_ch
        for f, k in zip(features, kernels):
            if k == 3 and groups == 1:
                layers.append(FastConv3x3(cin, f, dtype))
            elif dtype is not None and k == 1 and groups > 1:
                layers.append(FastGroupedConv1x1(cin, f, groups, dtype))
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


class OnlyEZWT(nn.Module):
    """Zerotree-only conditioning: ``eb_xe`` for LL, ``eb_xo`` for the
    coarsest details, and for each finer level i a parent-context stack
    ``plc_i`` (3x3, 3x3, 1x1) on the upsampled decoded parent.

    The plc stacks take no compute dtype, as in the JAX package: they stay
    fp32 (kernel 1 on the card) in a bf16 config."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.clrch
        L = cfg.dwtlevels
        so = 3 * c
        wide = so * 81
        self.eb_xe = EntropyBottleneck(1 * c)
        self.eb_xo = EntropyBottleneck(so)
        self.plc = register_list(self, "plc", [
            _ConvStack(so, (wide, wide, 2 * so), (3, 3, 1))
            for _ in range(L - 1)])
        self.learned_up = cfg.zt_upsample == "learned"
        if self.learned_up:
            self.ups = register_list(self, "ups", [
                ZeroTreePreviousLayer(so, so) for _ in range(L - 1)])

    def _up(self, i: int, parent_q: torch.Tensor) -> torch.Tensor:
        """Parent->child context upsampling feeding ``plc[i]``."""
        if self.learned_up:
            return self.ups[i](parent_q)
        return upsample2(parent_q)

    def level_params_from_parent(self, i: int, parent_hat: torch.Tensor):
        """(sigma, mu) for finer level i from the decoded parent details:
        the coding path's whole-level parameter pass."""
        return _split_sigma_mu(self.plc[i](self._up(i, parent_hat)))

    def encode_chain(self, xo_list, con: torch.Tensor):
        """Every finer level's (symbols, CDF indexes, decoded plane) in one
        device pass, coarse to fine: each level's decode-consistent
        writeback ``round(x - mu) + mu`` is the next level's parent.
        ``con`` is the decoded coarsest-details plane."""
        L = self.cfg.dwtlevels
        syms: List = [None] * (L - 1)
        idxs: List = [None] * (L - 1)
        hats: List = [None] * (L - 1)
        for i in range(L - 2, -1, -1):
            sigma, mu = self.level_params_from_parent(i, con)
            sym = torch.round(xo_list[i] - mu)
            hats[i] = con = sym + mu
            syms[i] = sym.to(torch.int32)
            idxs[i] = gaussian.build_indexes(sigma)
        return syms, idxs, hats

    def forward(self, xe: torch.Tensor, xo_list, training: bool = False,
                generator=None):
        """Noise is drawn in the JAX package's order: ``eb_xe``, ``eb_xo``,
        then one draw a finer level, coarse to fine."""
        L = self.cfg.dwtlevels
        xe_qnt, lik_xe = self.eb_xe(xe, training, generator)
        info_xo: List = [None] * L
        xo_qnt: List = [None] * L
        q, lik = self.eb_xo(xo_list[L - 1], training, generator)
        xo_qnt[L - 1], info_xo[L - 1] = q, -torch.log2(lik)
        for i in range(L - 2, -1, -1):
            sigma, mu = self.level_params_from_parent(i, q)
            q, info_xo[i] = gaussian.self_information_bits(
                xo_list[i], sigma, mu, training, generator)
            xo_qnt[i] = q
        return -torch.log2(lik_xe), info_xo, xe_qnt, xo_qnt

    def aux_loss(self) -> torch.Tensor:
        return self.eb_xe.aux_loss() + self.eb_xo.aux_loss()


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


class _DepNet(nn.Module):
    """Coset predictor: 3x3, 3x3, 1x1, 1x1 convs (hidden 32, LeakyReLU
    after each), then a 1x1 conv to one channel; fp32 ``F.conv2d``."""

    def __init__(self, cin: int, hidden: int = 32):
        super().__init__()
        layers = []
        for k in (3, 3, 1, 1):
            layers.append(Conv2d(cin, hidden, k))
            cin = hidden
        layers.append(Conv2d(hidden, 1, 1))
        self.layers = register_list(self, "Conv", layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.leaky_relu(layer(x), 0.01)
        return self.layers[-1](x)


def _cosets(x: torch.Tensor):
    """The 4 polyphase cosets (ee, eo, oe, oo) of an NCHW plane."""
    return (x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2],
            x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2])


def _interleave_cosets(ee, eo, oe, oo) -> torch.Tensor:
    """Full-resolution plane from its 4 polyphase cosets (inverse of
    :func:`_cosets`)."""
    b, c, h2, w2 = ee.shape
    top = torch.stack([ee, eo], dim=-1).reshape(b, c, h2, 2 * w2)
    bot = torch.stack([oe, oo], dim=-1).reshape(b, c, h2, 2 * w2)
    return torch.stack([top, bot], dim=3).reshape(b, c, 2 * h2, 2 * w2)


class ZTBlock(nn.Module):
    """Polyphase-coset zerotree model: ``eb_xe`` for LL, ``eb_xo`` for the
    coarsest details; each finer subband channel n (level step by level
    step, coarse to fine) has the dep-nets ``dep_sigma_{n}_{k}`` and
    ``dep_mu_{n}_{k}`` for its cosets k = 0..3, fed the parent channel
    (at the child coset's resolution) and the cosets before k."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.clrch
        L = cfg.dwtlevels
        self.eb_xe = EntropyBottleneck(1 * c)
        self.eb_xo = EntropyBottleneck(3 * c)
        n = (L - 1) * 3 * c
        self.dep_mu = [[_DepNet(k + 1) for k in range(4)] for _ in range(n)]
        self.dep_sigma = [[_DepNet(k + 1) for k in range(4)]
                          for _ in range(n)]
        for name, nets in (("dep_mu", self.dep_mu),
                           ("dep_sigma", self.dep_sigma)):
            for i, row in enumerate(nets):
                for k, m in enumerate(row):
                    self.add_module(f"{name}_{i}_{k}", m)

    def channel_params(self, idx: int, q_ch: torch.Tensor,
                       parent_ch: torch.Tensor):
        """(sigma, mu) planes of subband channel ``idx`` from its parent
        channel and its own quantized cosets."""
        ee, eo, oe, _ = _cosets(q_ch)
        deps = [parent_ch,
                torch.cat([parent_ch, ee], 1),
                torch.cat([parent_ch, ee, eo], 1),
                torch.cat([parent_ch, ee, eo, oe], 1)]
        mu = _interleave_cosets(*[self.dep_mu[idx][k](deps[k])
                                  for k in range(4)])
        sigma = _interleave_cosets(*[self.dep_sigma[idx][k](deps[k])
                                     for k in range(4)])
        return sigma, mu

    def level_coset_params(self, step: int, k: int, parents: torch.Tensor,
                           *prev_cosets: torch.Tensor):
        """(sigma, mu) of coset k of every subband channel of finer-level
        ``step`` in one pass: the coding path's unit of work. ``parents``
        is the decoded parent level (B, 3c, h2, w2), ``prev_cosets`` the k
        decoded cosets before k, of the same shape."""
        c3 = 3 * self.cfg.clrch
        sigmas, mus = [], []
        for j in range(c3):
            dep = torch.cat([parents[:, j:j + 1]]
                            + [p[:, j:j + 1] for p in prev_cosets], 1)
            idx = step * c3 + j
            sigmas.append(self.dep_sigma[idx][k](dep))
            mus.append(self.dep_mu[idx][k](dep))
        return torch.cat(sigmas, 1), torch.cat(mus, 1)

    def encode_chain(self, xo_list, con: torch.Tensor):
        """(symbols, CDF indexes, decoded planes) of every finer level and
        coset in one device pass; ``syms``/``idxs`` nested [step][coset],
        ``hats`` per level. ``con`` is the decoded coarsest details."""
        L = self.cfg.dwtlevels
        all_syms: List = []
        all_idxs: List = []
        hats: List = [None] * (L - 1)
        for step, lvl in enumerate(range(L - 2, -1, -1)):
            x_cosets = _cosets(xo_list[lvl])
            cosets, lsyms, lidxs = [], [], []
            for k in range(4):
                sigma, mu = self.level_coset_params(step, k, con, *cosets)
                sym = torch.round(x_cosets[k] - mu)
                cosets.append(sym + mu)
                lsyms.append(sym.to(torch.int32))
                lidxs.append(gaussian.build_indexes(sigma))
            hats[lvl] = con = _interleave_cosets(*cosets)
            all_syms.append(lsyms)
            all_idxs.append(lidxs)
        return all_syms, all_idxs, hats

    def forward(self, xe: torch.Tensor, xo_list, training: bool = False,
                generator=None):
        """Noise is drawn in the JAX package's order: ``eb_xe``, ``eb_xo``,
        then channel by channel (coarse levels first) the context's draw,
        then the likelihood's."""
        L, c3 = self.cfg.dwtlevels, 3 * self.cfg.clrch
        noise = (training, generator)
        xe_qnt, lik_xe = self.eb_xe(xe, *noise)
        info_xo: List = [None] * L
        xo_qnt: List = [None] * L
        q, lik = self.eb_xo(xo_list[L - 1], *noise)
        xo_qnt[L - 1], info_xo[L - 1] = q, -torch.log2(lik)
        con = q  # the parent stays at its resolution (a child coset's)
        for step, lvl in enumerate(range(L - 2, -1, -1)):
            infos, qs = [], []
            for j in range(c3):
                x_ch = xo_list[lvl][:, j:j + 1]
                q_ch = _quantize_ctx(x_ch, *noise)
                sigma, mu = self.channel_params(step * c3 + j, q_ch,
                                                con[:, j:j + 1])
                _, info = gaussian.self_information_bits(x_ch, sigma, mu,
                                                         *noise)
                infos.append(info)
                qs.append(q_ch)
            info_xo[lvl] = torch.cat(infos, 1)
            xo_qnt[lvl] = con = torch.cat(qs, 1)
        return -torch.log2(lik_xe), info_xo, xe_qnt, xo_qnt

    def aux_loss(self) -> torch.Tensor:
        return self.eb_xe.aux_loss() + self.eb_xo.aux_loss()


def make_entropy_model(cfg: Config) -> nn.Module:
    if cfg.entropy_layer == "factorized":
        return FactorizedEntropy(cfg)
    if cfg.entropy_layer == "onlyEZWT":
        return OnlyEZWT(cfg)
    if cfg.entropy_layer == "conditioned2ZTsepSubbands":
        return ZTSepSubbands(cfg)
    if cfg.entropy_layer == "DWTConditioned2EntropyLayerZTBlock":
        return ZTBlock(cfg)
    raise ValueError(f"unknown entropy_layer {cfg.entropy_layer!r}")
