"""The plain reference of the benchmarked codecs, in PyTorch alone.

A frozen, independent copy of the codec's mathematics. Every convolution is
``F.conv2d``; nothing here imports the measured program or any kernel of
it. Parameter names equal the program's, so one state dict (made by the
benchmark from the seed) loads into both.

The arithmetic follows the published model as the program states it:
flax's SAME padding, compressAI's lower bound with its pass-through
gradient, the Gaussian and learned-CDF likelihoods, bits normalised per
pixel of a colour plane times 3, and the training noise drawn from one
``torch.Generator`` in the model's order.

This file holds what the parts share (the primitives, the likelihoods,
the codec around its parts, the colour planes and ``rd_terms``). The parts
are files found by the configuration's names, so that a configuration with
a new part brings a file and edits none:

- ``transform/<netType>.py``: ``build(transform, cfg)`` registers the
  transform's own parameters on ``transform`` (before its autoencoders);
  ``analysis(transform, x) -> (ll, details)`` is one level, the details
  packed by :func:`pack`; ``synthesis(transform, ll, details) -> x`` is its
  exact inverse;
- ``autoencoder/<autoencoder>.py``: ``build(cfg, ic)`` returns a module with
  ``encode`` and ``decode`` for a subband of ``ic`` channels;
- ``entropy/<entropy_layer>.py``: ``build(cfg)`` returns a module with
  ``forward(xe, xo, training, generator) -> (bits_xe, info, q_xe, q_xo)``
  (``info`` and ``q_xo`` per level, finest first), which draws the training
  noise from ``generator`` in the model's order, and ``aux_loss()``.

A part file:

- names its parameters as the program does (the state dict's keys, their
  shapes and their order are the program's);
- follows the seeder's conventions (``harness/weights.py``): 4-D
  ``.weight`` kernels are drawn lecun-normal, ``.bias_<n>`` CDF biases
  U(-0.5, 0.5), and every other parameter keeps the start it is built with;
- builds its convolutions and products from :class:`Conv`, :class:`GDN`
  and :class:`Bottleneck`, or gives its own an ``operand_round`` used as
  theirs, so that the control (``checks.lower_precision``) rounds them;
- imports nothing outside ``reference/`` but ``torch`` and the standard
  library: this file, as ``from ..model import ...``.

A configuration that names a part with no file fails at set-up with
:class:`NoPart`, which names the file to add.
"""

from __future__ import annotations

import functools
import importlib.util
import math
import os
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
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = HERE     # where :func:`part` looks for the part files


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


def pack(lh, hl, hh):
    s = torch.stack([lh, hl, hh], dim=2)
    b, c, _, h, w = s.shape
    return s.reshape(b, 3 * c, h, w)


def unpack(xo):
    b, c3, h, w = xo.shape
    s = xo.reshape(b, c3 // 3, 3, h, w)
    return s[:, :, 0], s[:, :, 1], s[:, :, 2]


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


# --- likelihoods ------------------------------------------------------------

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


def gaussian_bits(x, sigma, mu, training, generator):
    q = quantize(x, training, generator, None if training else mu)
    v = torch.abs(q - mu)
    s = lower_bound(sigma, SCALE_BOUND)

    def phi(t):
        return 0.5 * torch.special.erfc(-(2 ** -0.5) * t)

    lik = lower_bound(phi((0.5 - v) / s) - phi((-0.5 - v) / s),
                      LIKELIHOOD_BOUND)
    return -torch.log2(lik)


# --- the codec, from its parts ----------------------------------------------

class NoPart(LookupError):
    """The reference has no file for a part that the configuration names."""


def part(family: str, name: str, root: str | None = None):
    """The part module ``<root>/<family>/<name>.py`` (``root`` by default
    :data:`ROOT`, read at the call), loaded once a process under this
    package, so that its ``from ..model import ...`` finds this file."""
    return _load(family, name, ROOT if root is None else root)


@functools.lru_cache(maxsize=None)
def _load(family: str, name: str, root: str):
    path = os.path.join(root, family, f"{name}.py")
    if not os.path.isfile(path):
        raise NoPart(f"the reference has no {family} part {name!r}: add "
                     f"{path}")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.{family}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Transform(nn.Module):
    """``dwtlevels`` levels of the ``netType`` part, with an ``autoencoder``
    part on each level's details (``yh_ae_<i>``) and on the last LL band
    (``yl_ae``)."""

    def __init__(self, cfg):
        super().__init__()
        c, self.levels = cfg["clrch"], cfg["dwtlevels"]
        wavelet = part("transform", cfg["netType"])
        wavelet.build(self, cfg)
        self._analysis, self._synthesis = wavelet.analysis, wavelet.synthesis
        ae = part("autoencoder", cfg["autoencoder"])
        self.yl_ae = ae.build(cfg, c)
        self.yh_ae = add_list(self, "yh_ae", [
            ae.build(cfg, 3 * c) for _ in range(self.levels)])

    def encode(self, x):
        ll, xo = x, []
        for lvl in range(self.levels):
            ll, pk = self._analysis(self, ll)
            xo.append(self.yh_ae[lvl].encode(pk))
        return self.yl_ae.encode(ll), xo

    def decode(self, xe, xo):
        ll = self.yl_ae.decode(xe)
        for lvl in range(self.levels - 1, -1, -1):
            pk = self.yh_ae[lvl].decode(xo[lvl])
            ll = self._synthesis(self, ll, pk)
        return ll


class Codec(nn.Module):
    """The transform, then the ``entropy_layer`` part."""

    def __init__(self, cfg):
        super().__init__()
        self.transform = Transform(cfg)
        self.entropymodel = part("entropy", cfg["entropy_layer"]).build(cfg)

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
