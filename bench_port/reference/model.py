"""The plain reference of the two benchmarked codecs, in PyTorch alone.

A frozen, independent copy of the codec's mathematics: the learned-lifting
flagship (LiftingBasedNeuralWaveletv4, Berk GDN autoencoders, the ZTsep
zerotree + causal-context entropy model, three YCbCr planes) and the CDF
9/7 + factorized codec (pointwise grouped autoencoders, learned-CDF
bottlenecks, joint RGB). Every convolution is ``F.conv2d``; the 9/7 ladder
is ``torch.roll`` arithmetic; nothing here imports the measured program or
any kernel of it. Parameter names equal the program's, so one state dict
(made by the benchmark from the seed) loads into both.

The arithmetic follows the published model as the program states it:
flax's SAME padding, compressAI's lower bound with its pass-through
gradient, the Gaussian and learned-CDF likelihoods, bits normalised per
pixel of a colour plane times 3, and the training noise drawn from one
``torch.Generator`` in the model's order (per plane: LL, coarsest details,
finer levels coarse to fine; each a context draw, then a likelihood draw).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

ALPHA, BETA, GAMMA, DELTA, NH, NL = (
    -1.586134342059924, -0.052980118572961, 0.882911075530934,
    0.443506852043971, 0.869864451624781, 1.149604398860241)
NNP_OFFSET = 2 ** -18
PEDESTAL = NNP_OFFSET ** 2
GDN_BETA_MIN = 1e-6
SCALE_BOUND = 0.11
LIKELIHOOD_BOUND = 1e-9


# --- primitives -------------------------------------------------------------

class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x >= ctx.bound) | (g < 0)
        return torch.where(keep, g, torch.zeros_like(g)), None


def lower_bound(x, bound):
    return _LowerBound.apply(x, float(bound))


def noise(x, generator):
    """U(-0.5, 0.5) of x's shape, drawn on the generator's device."""
    u = torch.rand(x.shape, generator=generator, device=generator.device,
                   dtype=x.dtype)
    return (u - 0.5).to(x.device)


def quantize(x, training, generator, means=None):
    if training:
        return x + noise(x, generator)
    if means is None:
        return torch.round(x)
    return torch.round(x - means) + means


class Conv(nn.Module):
    """SAME conv (odd kernel), fp32, bias added after; optional causal
    mask (PixelCNN types A and B) multiplied onto the weight.
    ``operand_round``, when set, rounds both operands first (a lower
    precision's control)."""

    operand_round = None

    def __init__(self, cin, cout, k, groups=1, mask=None):
        super().__init__()
        self.groups, self.pad = groups, k // 2
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        if mask is not None:
            m = torch.zeros(k, k)
            m[:k // 2, :] = 1.0
            m[k // 2, :k // 2] = 1.0
            if mask == "B":
                m[k // 2, k // 2] = 1.0
            self.register_buffer("mask", m[None, None], persistent=False)
        else:
            self.mask = None

    def forward(self, x):
        w = self.weight if self.mask is None else self.weight * self.mask
        if self.operand_round is not None:
            x, w = self.operand_round(x), self.operand_round(w)
        y = F.conv2d(x, w, padding=self.pad, groups=self.groups)
        return y + self.bias.view(1, -1, 1, 1)


def add_list(parent, prefix, modules):
    for i, m in enumerate(modules):
        parent.add_module(f"{prefix}_{i}", m)
    return list(modules)


class GDN(nn.Module):
    operand_round = None

    def __init__(self, c, inverse=False):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(torch.sqrt(torch.ones(c) + PEDESTAL))
        self.gamma = nn.Parameter(torch.sqrt(0.1 * torch.eye(c) + PEDESTAL))

    def forward(self, x):
        beta = lower_bound(self.beta, (GDN_BETA_MIN + PEDESTAL) ** 0.5) ** 2 \
            - PEDESTAL
        gamma = lower_bound(self.gamma, PEDESTAL ** 0.5) ** 2 - PEDESTAL
        sq = x * x
        if self.operand_round is not None:
            sq, gamma = self.operand_round(sq), self.operand_round(gamma)
        norm = torch.sqrt(F.conv2d(sq, gamma[:, :, None, None], beta))
        return x * norm if self.inverse else x / norm


# --- transforms -------------------------------------------------------------

class PBlock(nn.Module):
    def __init__(self, c, hidden, k):
        super().__init__()
        widths = [(c, hidden), (hidden, hidden), (hidden, hidden),
                  (hidden, c)]
        self.convs = add_list(self, "Conv", [Conv(i, o, k) for i, o in widths])

    def forward(self, x):
        c0, c1, c2, c3 = self.convs
        r = c0(x)
        t = torch.tanh(c1(torch.tanh(r)))
        return c3(c2(t) + r)


class SkipConv(nn.Module):
    """3-tap depthwise conv along H, zero padded."""

    def __init__(self, c, coeff, kind):
        super().__init__()
        pat = [0.0, coeff, coeff] if kind == "predict" else [coeff, coeff, 0.0]
        self.taps = nn.Parameter(torch.tensor(pat)[:, None].repeat(1, c))

    def forward(self, x):
        n = x.shape[2]
        xp = F.pad(x, (0, 0, 1, 1))
        t = self.taps.view(3, 1, -1, 1, 1)
        return t[0] * xp[:, :, :n] + t[1] * xp[:, :, 1:n + 1] \
            + t[2] * xp[:, :, 2:n + 2]


class LiftStage(nn.Module):
    def __init__(self, c, hidden, k, pairs, res_weight):
        super().__init__()
        self.pairs, self.w = pairs, res_weight
        skips = []
        for p in range(pairs):
            skips.append(SkipConv(c, (ALPHA, GAMMA)[p % 2], "predict"))
            skips.append(SkipConv(c, (BETA, DELTA)[p % 2], "update"))
        self.skips = add_list(self, "skips", skips)
        self.p = add_list(self, "p_blocks",
                          [PBlock(c, hidden, k) for _ in range(pairs)])
        self.u = add_list(self, "u_blocks",
                          [PBlock(c, hidden, k) for _ in range(pairs)])

    def forward(self, lo, hi):
        for p in range(self.pairs):
            s = self.skips[2 * p](lo)
            hi = hi + s + self.p[p](s) * self.w
            s = self.skips[2 * p + 1](hi)
            lo = lo + s + self.u[p](s) * self.w
        return lo, hi

    def inverse(self, lo, hi):
        for p in range(self.pairs - 1, -1, -1):
            s = self.skips[2 * p + 1](hi)
            lo = lo - s - self.u[p](s) * self.w
            s = self.skips[2 * p](lo)
            hi = hi - s - self.p[p](s) * self.w
        return lo, hi


def pack(lh, hl, hh):
    s = torch.stack([lh, hl, hh], dim=2)
    b, c, _, h, w = s.shape
    return s.reshape(b, 3 * c, h, w)


def unpack(xo):
    b, c3, h, w = xo.shape
    s = xo.reshape(b, c3 // 3, 3, h, w)
    return s[:, :, 0], s[:, :, 1], s[:, :, 2]


def merge_rows(even, odd):
    b, c, h2, w = even.shape
    return torch.stack([even, odd], dim=3).reshape(b, c, 2 * h2, w)


def lift_forward(stage, x):
    lo, hi = stage(x[:, :, 0::2], x[:, :, 1::2])
    b = x.shape[0]
    t = torch.cat([lo.transpose(2, 3), hi.transpose(2, 3)], dim=0)
    lt, ht = stage(t[:, :, 0::2], t[:, :, 1::2])
    return (lt[:b].transpose(2, 3), lt[b:].transpose(2, 3),
            ht[:b].transpose(2, 3), ht[b:].transpose(2, 3))  # ll lh hl hh


def lift_inverse(stage, ll, lh, hl, hh):
    b = ll.shape[0]
    lt = torch.cat([ll.transpose(2, 3), lh.transpose(2, 3)], dim=0)
    ht = torch.cat([hl.transpose(2, 3), hh.transpose(2, 3)], dim=0)
    m = merge_rows(*stage.inverse(lt, ht))
    return merge_rows(*stage.inverse(m[:b].transpose(2, 3),
                                     m[b:].transpose(2, 3)))


# CDF 9/7 ladders: (kind, coefficient) steps, P = 0, U = 1; (low, high) gains
LADDER_F = (((0, ALPHA), (1, BETA), (0, GAMMA), (1, DELTA)), (NL, NH))
LADDER_I = (((1, -DELTA), (0, -GAMMA), (1, -BETA), (0, -ALPHA)),
            (1.0 / NL, 1.0 / NH))


def _ladder(s, d, dim, steps):
    for kind, c in steps:
        if kind == 0:
            d = d + c * (s + torch.roll(s, -1, dims=dim))
        else:
            s = s + c * (torch.roll(d, 1, dims=dim) + d)
    return s, d


def analysis(x, dim):
    xr = x.unflatten(dim, (x.shape[dim] // 2, 2))
    s, d = _ladder(xr.select(dim + 1, 0), xr.select(dim + 1, 1), dim,
                   LADDER_F[0])
    return s * LADDER_F[1][0], d * LADDER_F[1][1]


def synthesis(lo, hi, dim):
    s, d = _ladder(lo * LADDER_I[1][0], hi * LADDER_I[1][1], dim, LADDER_I[0])
    return torch.stack([s, d], dim=dim + 1).flatten(dim, dim + 1)


def dwt97_level(x):
    low, high = analysis(x, 2)
    ll, hl = analysis(low, 3)
    lh, hh = analysis(high, 3)
    return ll, pack(lh, hl, hh)


def idwt97_level(ll, xo):
    lh, hl, hh = unpack(xo)
    return synthesis(synthesis(ll, hl, 3), synthesis(lh, hh, 3), 2)


class PointwiseAE(nn.Module):
    """Per-channel 1 -> 32 -> 32 -> 32 -> 1 tanh MLPs (grouped 1x1)."""

    def __init__(self, ic):
        super().__init__()
        w = [(ic, 32 * ic), (32 * ic, 32 * ic), (32 * ic, 32 * ic),
             (32 * ic, ic)]
        self.down = add_list(self, "down", [Conv(i, o, 1, ic) for i, o in w])
        self.up = add_list(self, "up", [Conv(i, o, 1, ic) for i, o in w])

    @staticmethod
    def _run(layers, x):
        for layer in layers[:-1]:
            x = torch.tanh(layer(x))
        return layers[-1](x)

    def encode(self, x):
        return self._run(self.down, x)

    def decode(self, y):
        return self._run(self.up, y)


class BerkAE(nn.Module):
    def __init__(self, ic):
        super().__init__()
        w = [(ic, 32 * ic), (32 * ic, 64 * ic), (64 * ic, 32 * ic),
             (32 * ic, ic)]
        g = [32 * ic, 64 * ic, 32 * ic]
        self.down = add_list(self, "down", [Conv(i, o, 3) for i, o in w])
        self.down_gdn = add_list(self, "down_gdn", [GDN(c) for c in g])
        self.up = add_list(self, "up", [Conv(i, o, 3) for i, o in w])
        self.up_gdn = add_list(self, "up_gdn", [GDN(c, True) for c in g])

    def encode(self, x):
        for layer, gdn in zip(self.down[:-1], self.down_gdn):
            x = gdn(layer(x))
        return self.down[-1](x)

    def decode(self, y):
        for layer, gdn in zip(self.up[:-1], self.up_gdn):
            y = gdn(layer(y))
        return self.up[-1](y)


def make_ae(kind, ic):
    return {"SubbandAutoEncoder": PointwiseAE,
            "SubbandAutoEncoderBerk": BerkAE}[kind](ic)


class Transform(nn.Module):
    """``LiftingBasedNeuralWaveletv4`` (one shared stage) or ``CDF97``."""

    def __init__(self, cfg):
        super().__init__()
        c, self.levels = cfg["clrch"], cfg["dwtlevels"]
        self.learned = cfg["netType"] == "LiftingBasedNeuralWaveletv4"
        if self.learned:
            if cfg["block_property"] != "same" or cfg["scale"] \
                    or not cfg["linearity_flag"]:
                raise ValueError("the reference lifts with one shared "
                                 "nonlinear stage and no learned gains")
            self.stages = add_list(self, "stages", [LiftStage(
                c, cfg["depth_scale"] * 8 * c, cfg["filtersize"],
                cfg["num_lifting_perlayer"],
                cfg["res_connection_weight"])])
        self.yl_ae = make_ae(cfg["autoencoder"], c)
        self.yh_ae = add_list(self, "yh_ae", [
            make_ae(cfg["autoencoder"], 3 * c) for _ in range(self.levels)])

    def encode(self, x):
        ll, xo = x, []
        for lvl in range(self.levels):
            if self.learned:
                ll, lh, hl, hh = lift_forward(self.stages[0], ll)
                pk = pack(lh, hl, hh)
            else:
                ll, pk = dwt97_level(ll)
            xo.append(self.yh_ae[lvl].encode(pk))
        return self.yl_ae.encode(ll), xo

    def decode(self, xe, xo):
        ll = self.yl_ae.decode(xe)
        for lvl in range(self.levels - 1, -1, -1):
            pk = self.yh_ae[lvl].decode(xo[lvl])
            ll = lift_inverse(self.stages[0], ll, *unpack(pk)) if self.learned \
                else idwt97_level(ll, pk)
        return ll


# --- entropy models ---------------------------------------------------------

class Bottleneck(nn.Module):
    """Per-channel learned CDF (filters 3, 3, 3, 3; init scale 10).
    ``operand_round`` as :class:`Conv`'s, on its products' operands."""

    FILTERS = (3, 3, 3, 3)
    operand_round = None

    def __init__(self, c):
        super().__init__()
        self.c = c
        dims = (1,) + self.FILTERS + (1,)
        scale = 10.0 ** (1.0 / (len(self.FILTERS) + 1))
        for i in range(len(self.FILTERS) + 1):
            self.register_parameter(f"matrix_{i}", nn.Parameter(torch.full(
                (c, dims[i + 1], dims[i]),
                math.log(math.expm1(1.0 / scale / dims[i + 1])))))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.zeros(c, dims[i + 1], 1)))
            if i < len(self.FILTERS):
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.zeros(c, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(
            torch.tensor([-10.0, 0.0, 10.0]).repeat(c, 1, 1))

    def _logits(self, v, detach):
        for i in range(len(self.FILTERS) + 1):
            m, b = getattr(self, f"matrix_{i}"), getattr(self, f"bias_{i}")
            if detach:
                m, b = m.detach(), b.detach()
            a = F.softplus(m)
            if self.operand_round is not None:
                a, v = self.operand_round(a), self.operand_round(v)
            v = torch.bmm(a, v) + b
            if i < len(self.FILTERS):
                f = getattr(self, f"factor_{i}")
                v = v + torch.tanh(f.detach() if detach else f) * torch.tanh(v)
        return v

    def aux_loss(self):
        t = math.log(2.0 / 1e-9 - 1.0)
        logits = self._logits(self.quantiles, True)
        return (logits - logits.new_tensor([-t, 0.0, t])).abs().sum()

    def forward(self, x, training, generator):
        med = self.quantiles[:, 0, 1].view(1, -1, 1, 1)
        q = quantize(x, training, generator, None if training else med)
        flat = q.transpose(0, 1).reshape(self.c, 1, -1)
        lo = self._logits(flat - 0.5, False)
        hi = self._logits(flat + 0.5, False)
        sign = -torch.sign(lo + hi).detach()
        lik = lower_bound((torch.sigmoid(sign * hi)
                           - torch.sigmoid(sign * lo)).abs(), LIKELIHOOD_BOUND)
        shape = (q.shape[1], q.shape[0]) + q.shape[2:]
        return q, -torch.log2(lik.reshape(shape).transpose(0, 1))


class Factorized(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg["clrch"]
        self.eb_xo = add_list(self, "eb_xo", [
            Bottleneck(3 * c) for _ in range(cfg["dwtlevels"])])
        self.eb_xe = Bottleneck(c)

    def forward(self, xe, xo, training, generator):
        info_xo, q_xo = [], []
        for eb, x in zip(self.eb_xo, xo):
            q, bits = eb(x, training, generator)
            q_xo.append(q)
            info_xo.append(bits)
        q_xe, bits_xe = self.eb_xe(xe, training, generator)
        return bits_xe, info_xo, q_xe, q_xo

    def aux_loss(self):
        return self.eb_xe.aux_loss() + sum(eb.aux_loss() for eb in self.eb_xo)


def gaussian_bits(x, sigma, mu, training, generator):
    q = quantize(x, training, generator, None if training else mu)
    v = torch.abs(q - mu)
    s = lower_bound(sigma, SCALE_BOUND)

    def phi(t):
        return 0.5 * torch.special.erfc(-(2 ** -0.5) * t)

    lik = lower_bound(phi((0.5 - v) / s) - phi((-0.5 - v) / s),
                      LIKELIHOOD_BOUND)
    return -torch.log2(lik)


class Stack(nn.Module):
    """Conv -> LeakyReLU(0.01) -> ... -> Conv."""

    def __init__(self, cin, feats, k, groups=1, mask=None, prefix="Conv"):
        super().__init__()
        layers = []
        for i, f in enumerate(feats):
            m = None if mask is None else ("A" if i == 0 else "B")
            layers.append(Conv(cin, f, k, groups, m))
            cin = f
        self.layers = add_list(self, prefix, layers)

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.leaky_relu(x, 0.01)
        return x


def up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class ZTSep(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c, levels = cfg["clrch"], cfg["dwtlevels"]
        so = 3 * c
        wide = 81 * so
        self.so, self.levels = so, levels
        self.plc = add_list(self, "plc", [
            Stack(so, (wide, wide), 3) for _ in range(levels - 1)])
        self.csc = add_list(self, "csc", [
            Conv(so, wide, 5, so, "A") for _ in range(levels - 1)])
        self.cgp = add_list(self, "cgp", [
            Stack(2 * wide, (2 * wide, 2 * wide // 3, 2 * wide // 9, 2 * so),
                  1, so) for _ in range(levels - 1)])
        self.pixelcnn_xo = Stack(so, (wide, wide, wide // 3, wide // 9,
                                      2 * so), 3, so, "A", "MaskedConv2d")
        self.pixelcnn_xe = Stack(c, (81 * c, 81 * c, 27 * c, 9 * c, 2 * c),
                                 3, c, "A", "MaskedConv2d")

    def forward(self, xe, xo, training, generator):
        L, so = self.levels, self.so
        q_xe = quantize(xe, training, generator)
        p = self.pixelcnn_xe(q_xe)
        bits_xe = gaussian_bits(xe, p[:, 0::2], p[:, 1::2], training,
                                generator)
        info, q_xo = [None] * L, [None] * L
        q = quantize(xo[L - 1], training, generator)
        p = self.pixelcnn_xo(q)
        info[L - 1] = gaussian_bits(xo[L - 1], p[:, 0::2], p[:, 1::2],
                                    training, generator)
        q_xo[L - 1] = q
        con = up2(q)
        for i in range(L - 2, -1, -1):
            q = quantize(xo[i], training, generator)
            csc, plc = self.csc[i](q), self.plc[i](con)
            b, _, h, w = plc.shape
            fused = torch.cat([plc.reshape(b, so, 81, h, w),
                               csc.reshape(b, so, 81, h, w)], dim=2)
            p = self.cgp[i](fused.reshape(b, so * 162, h, w))
            info[i] = gaussian_bits(xo[i], p[:, 0::2], p[:, 1::2], training,
                                    generator)
            q_xo[i] = q
            con = up2(q)
        return bits_xe, info, q_xe, q_xo

    def aux_loss(self):
        return self.plc[0].layers[0].weight.new_zeros(())


class Codec(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.transform = Transform(cfg)
        kind = cfg["entropy_layer"]
        if kind == "conditioned2ZTsepSubbands":
            self.entropymodel = ZTSep(cfg)
        elif kind == "factorized":
            self.entropymodel = Factorized(cfg)
        else:
            raise ValueError(f"the reference has no entropy model {kind!r}")

    def forward(self, x, training, generator):
        xe, xo = self.transform.encode(x)
        bits_xe, info, q_xe, q_xo = self.entropymodel(xe, xo, training,
                                                      generator)
        return self.transform.decode(q_xe, q_xo), bits_xe, info


class Reference(nn.Module):
    """The whole codec: ``clrch`` 3 one codec on RGB - 0.5, ``clrch`` 1
    three codecs on the shifted BT.601 YCbCr planes."""

    def __init__(self, cfg):
        super().__init__()
        self.clrch = cfg["clrch"]
        if self.clrch == 3:
            self.codec = Codec(cfg)
        else:
            self.codecs = nn.ModuleList([Codec(cfg) for _ in range(3)])

    def aux_loss(self):
        if self.clrch == 3:
            return self.codec.entropymodel.aux_loss()
        return sum(c.entropymodel.aux_loss() for c in self.codecs)

    def forward(self, x, training=False, generator=None):
        """x: NCHW RGB in [0, 1] -> (x - 0.5, xhat - 0.5, bits_xe, bits_xo
        list)."""
        if self.clrch == 3:
            xhat, bits_xe, info = self.codec(x - 0.5, training, generator)
            return x - 0.5, xhat, bits_xe, info
        r, g, b = x[:, 0], x[:, 1], x[:, 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 0.5 * (b - y) / (1.0 - 0.114) + 0.5
        cr = 0.5 * (r - y) / (1.0 - 0.299) + 0.5
        planes = [y - 0.5, cb, cr]
        outs = [codec(p[:, None], training, generator)
                for codec, p in zip(self.codecs, planes)]
        yh = outs[0][0][:, 0] + 0.5
        cbh, crh = outs[1][0][:, 0], outs[2][0][:, 0]
        rh = yh + 2.0 * (1.0 - 0.299) * (crh - 0.5)
        bh = yh + 2.0 * (1.0 - 0.114) * (cbh - 0.5)
        gh = (yh - 0.299 * rh - 0.114 * bh) / 0.587
        xhat = torch.stack([rh, gh, bh], dim=1)
        bits_xe = torch.cat([o[1] for o in outs], dim=1)
        info: List = []
        for o in outs:
            info.extend(o[2])
        return x - 0.5, xhat - 0.5, bits_xe, info


def rd_terms(xs, xhat, bits_xe, info, lam, rate_weight=1.0):
    """(loss, mse, rate1, rate2): rates in bits per pixel of a plane x 3."""
    n = float(xs.numel())
    mse = torch.mean((xs - xhat) ** 2)
    rate1 = torch.sum(bits_xe) / n * 3.0
    rate2 = sum(torch.sum(b) / n * 3.0 for b in info)
    return rate_weight * (rate1 + rate2) + lam * mse, mse, rate1, rate2
