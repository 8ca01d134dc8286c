"""ZTsep: masked PixelCNN stacks on the coarsest subbands (LL and its
details), and at each finer level the parent-context (plc) 3x3 convs, the
causal (csc) masked 5x5 conv and the fusion (cgp) grouped 1x1 stack."""

from bench_port.work import Layer


def layers(cfg, c, b, h, w):
    levels = cfg["dwtlevels"]
    so = 3 * c
    wide = 81 * so
    coarse = b * (h >> levels) * (w >> levels)
    out = []
    for cin, feats in ((c, (81 * c, 81 * c, 27 * c, 9 * c, 2 * c)),
                       (so, (wide, wide, wide // 3, wide // 9, 2 * so))):
        a = cin
        for f in feats:
            out.append(Layer("masked", coarse, a, f, 3, cin))
            a = f
    for i in range(levels - 1):
        n = b * (h >> (i + 1)) * (w >> (i + 1))
        out += [Layer("conv3x3", n, so, wide, 3, 1),
                Layer("conv3x3", n, wide, wide, 3, 1),
                Layer("masked", n, so, wide, 5, so)]
        fused = 2 * wide
        a = fused
        for f in (fused, fused // 3, fused // 9, 2 * so):
            out.append(Layer("conv1x1g", n, a, f, 1, so))
            a = f
    return out
