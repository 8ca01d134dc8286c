"""``SubbandAutoEncoderBerk``: 3x3 convs of widths 32, 64, 32 times the
subband's channels with GDN between them (inverse GDN in the decoder)."""

from torch import nn

from ..model import GDN, Conv, add_list


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


def build(cfg, ic):
    return BerkAE(ic)
