"""``CDF97``: the fixed CDF 9/7 lifting ladder, periodic at the borders
(``torch.roll`` arithmetic), H and then W at every level; no parameters."""

import torch

from ..model import ALPHA, BETA, DELTA, GAMMA, NH, NL, pack, unpack

# (kind, coefficient) steps, P = 0, U = 1; (low, high) gains
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


def _analysis(x, dim):
    xr = x.unflatten(dim, (x.shape[dim] // 2, 2))
    s, d = _ladder(xr.select(dim + 1, 0), xr.select(dim + 1, 1), dim,
                   LADDER_F[0])
    return s * LADDER_F[1][0], d * LADDER_F[1][1]


def _synthesis(lo, hi, dim):
    s, d = _ladder(lo * LADDER_I[1][0], hi * LADDER_I[1][1], dim, LADDER_I[0])
    return torch.stack([s, d], dim=dim + 1).flatten(dim, dim + 1)


def build(transform, cfg):
    pass


def analysis(transform, x):
    low, high = _analysis(x, 2)
    ll, hl = _analysis(low, 3)
    lh, hh = _analysis(high, 3)
    return ll, pack(lh, hl, hh)


def synthesis(transform, ll, details):
    lh, hl, hh = unpack(details)
    return _synthesis(_synthesis(ll, hl, 3), _synthesis(lh, hh, 3), 2)
