"""``conditioned2ZTsepSubbands`` (ZTsep): Gaussian likelihoods whose (sigma,
mu) come from masked PixelCNNs on the LL band and the coarsest details,
and on each finer level from its parent level (``plc``) and its own causal
context (``csc``) fused per channel (``cgp``). The training noise is drawn
for LL, the coarsest details, then finer levels coarse to fine; each a
context draw, then a likelihood draw."""

import torch
from torch import nn

from ..model import Conv, Stack, add_list, gaussian_bits, quantize, up2


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


def build(cfg):
    return ZTSep(cfg)
