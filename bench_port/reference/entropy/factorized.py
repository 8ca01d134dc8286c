"""``factorized``: a learned-CDF bottleneck per level's details and one for
the LL band, each per channel. The training noise is drawn for the
details, finest level first, then for LL."""

from torch import nn

from ..model import Bottleneck, add_list


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


def build(cfg):
    return Factorized(cfg)
