"""Seeded weights, made on the device in a few large draws.

The benchmark, not the program, makes the weights: every conv kernel from
flax's ``lecun_normal`` (a normal truncated at +-2 standard deviations,
scaled to 1/sqrt(fan-in)), the learned-CDF biases from U(-0.5, 0.5), and
every other parameter (GDN's beta and gamma, the lifting skip taps, the
CDF matrices, factors and quantiles, the zero biases) at the value the
model defines for its start. The same seed gives the same weights; one
state dict goes to the program and, made again, to the reference.

A cell's file may ask for an ``encoder_gain`` on one ``encoder_layer`` (its
``weights`` entry): that encoder kernel of every subband autoencoder
(``down_<i>``) is multiplied by the gain. At the model's start the detail
subbands' latents lie within +-0.5 and nearly all round to 0, so an eval
step's quantiser, context models and decoders see zeros; a trained
codec's latents span several bins, and with the gain the seeded ones do
too. Which layer takes the gain depends on the autoencoder: in the GDN
one the first kernel (GDN bounds what follows), in the pointwise tanh one
the last (after the tanh layers, so the latents scale linearly and the
tanh does not saturate).
"""

from __future__ import annotations

import math
import re

import torch
from torch import nn

from ..reference.model import Reference
from ..traffic.generator import stream_seed

TRUNC_STD = 0.87962566103423978   # std of the unit normal cut at +-2


@torch.no_grad()
def seeded_reference(cfg: dict, seed: int, device, spec=None
                     ) -> Reference:
    """The reference model on ``device`` with the seed's weights; ``spec``
    is the cell's ``weights`` entry."""
    with torch.device(device):
        ref = Reference(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "weights", 64))
    named = list(ref.named_parameters())
    kernels = [p for n, p in named if n.endswith(".weight") and p.dim() == 4]
    cdf_bias = [p for n, p in named if re.search(r"\.bias_\d+$", n)]
    flat = torch.empty(sum(p.numel() for p in kernels), device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    at = 0
    for p in kernels:
        std = 1.0 / math.sqrt(p[0].numel()) / TRUNC_STD
        p.copy_(flat[at:at + p.numel()].view_as(p) * std)
        at += p.numel()
    u = torch.rand(sum(p.numel() for p in cdf_bias), generator=g,
                   device=device)
    at = 0
    for p in cdf_bias:
        p.copy_(u[at:at + p.numel()].view_as(p) - 0.5)
        at += p.numel()
    spec = spec or {}
    if "encoder_gain" in spec:
        layer = re.escape(spec["encoder_layer"])
        scaled = [p for n, p in named
                  if re.search(rf"_ae(_\d+)?\.{layer}\.weight$", n)]
        if not scaled:
            raise ValueError(f"no autoencoder layer {layer!r} to scale")
        for p in scaled:
            p.mul_(spec["encoder_gain"])
    return ref
