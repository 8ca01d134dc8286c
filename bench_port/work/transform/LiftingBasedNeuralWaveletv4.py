"""Learned nonlinear lifting: at each level a row pass over h/2 x w pairs
and a column pass over both halves, each running the P and U blocks of
every lifting pair, in analysis and synthesis. A P/U block is a
``filtersize``^2 CNN c -> hidden -> hidden -> hidden -> c, hidden =
``depth_scale`` x 8 x c. Every subband's autoencoder input carries a
gradient (the lifting is learned)."""

from bench_port.work import Layer


def _pblock(c, hidden, k, pixels):
    widths = [(c, hidden), (hidden, hidden), (hidden, hidden), (hidden, c)]
    return [Layer(f"conv{k}x{k}", pixels, a, b, k, 1) for a, b in widths]


def layers(cfg, c, b, h, w):
    out, subbands = [], []
    hidden = cfg["depth_scale"] * 8 * c
    pairs = cfg["num_lifting_perlayer"]
    levels = cfg["dwtlevels"]
    for lvl in range(levels):
        hh, ww = h >> lvl, w >> lvl
        for pixels in (b * (hh // 2) * ww,              # row pass
                       2 * b * (ww // 2) * (hh // 2)):  # column pass
            out += _pblock(c, hidden, cfg["filtersize"], pixels) \
                * (2 * 2 * pairs)
        subbands.append((3 * c, b * (hh // 2) * (ww // 2), True))
    subbands.append((c, b * (h >> levels) * (w >> levels), True))
    return out, subbands
