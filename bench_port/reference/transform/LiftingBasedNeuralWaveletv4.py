"""``LiftingBasedNeuralWaveletv4``: one shared learned lifting stage (P/U
pairs of CNNs beside the 9/7 ladder's skip taps), run along H and then
along W at every level, and its exact inverse."""

import torch
import torch.nn.functional as F
from torch import nn

from ..model import (ALPHA, BETA, DELTA, GAMMA, Conv, add_list, pack,
                     unpack)


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


def build(transform, cfg):
    if cfg["block_property"] != "same" or cfg["scale"] \
            or not cfg["linearity_flag"]:
        raise ValueError("the reference lifts with one shared "
                         "nonlinear stage and no learned gains")
    c = cfg["clrch"]
    transform.stages = add_list(transform, "stages", [LiftStage(
        c, cfg["depth_scale"] * 8 * c, cfg["filtersize"],
        cfg["num_lifting_perlayer"], cfg["res_connection_weight"])])


def analysis(transform, x):
    ll, lh, hl, hh = lift_forward(transform.stages[0], x)
    return ll, pack(lh, hl, hh)


def synthesis(transform, ll, details):
    return lift_inverse(transform.stages[0], ll, *unpack(details))
