"""``SubbandAutoEncoder``: per-channel 1 -> 32 -> 32 -> 32 -> 1 tanh MLPs
(grouped 1x1 convs), an encoder and a decoder."""

import torch
from torch import nn

from ..model import Conv, add_list


class PointwiseAE(nn.Module):
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


def build(cfg, ic):
    return PointwiseAE(ic)
