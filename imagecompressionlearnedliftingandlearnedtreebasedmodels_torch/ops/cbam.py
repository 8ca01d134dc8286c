"""CBAM attention (channel gate x spatial gate) and the CBAM restoration
head of ``AttentionWaveletPostProcessing`` (NCHW).

Counterpart of the JAX package's ``ops/cbam.py``, which departs from the
original in one place and the port follows it: the spatial gate normalizes
with a one-group GroupNorm (flax's epsilon, 1e-6), not BatchNorm. Module
and parameter names are flax's (``Dense_0``, ``GroupNorm_0.scale``,
``res_weight``), so ``tools/weights.py`` carries them across. The convs
and dense layers are ``F.conv2d`` / ``F.linear``: ``nn.Conv`` and
``nn.Dense`` outside Pallas in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .fast_conv import Conv2d

GROUPNORM_EPS = 1e-6   # flax.linen.GroupNorm's default


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm`` over NCHW: per-channel ``scale`` and
    ``bias``."""

    def __init__(self, channels: int, num_groups: int = 1):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.scale, self.bias,
                            GROUPNORM_EPS)


class ChannelGate(nn.Module):
    """A shared two-layer MLP on the spatial mean and the spatial max of each
    channel; their sum's sigmoid scales the channels."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.Dense_0 = nn.Linear(channels, hidden)
        self.Dense_1 = nn.Linear(hidden, channels)

    def mlp(self, v: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(v)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3))
        mx = x.amax(dim=(2, 3))
        scale = torch.sigmoid(self.mlp(avg) + self.mlp(mx))
        return x * scale[:, :, None, None]


class SpatialGate(nn.Module):
    """[max, mean] over the channels, a 7x7 conv (no bias) to one map,
    GroupNorm, sigmoid: the map scales every channel."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv2d(2, 1, 7, bias=False)
        self.GroupNorm_0 = GroupNorm(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([x.amax(dim=1, keepdim=True),
                            x.mean(dim=1, keepdim=True)], 1)
        return x * torch.sigmoid(self.GroupNorm_0(self.Conv_0(pooled)))


class CBAM(nn.Module):
    def __init__(self, channels: int, reduction: int = 16,
                 no_spatial: bool = False):
        super().__init__()
        self.ChannelGate_0 = ChannelGate(channels, reduction)
        self.SpatialGate_0 = None if no_spatial else SpatialGate()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ChannelGate_0(x)
        return x if self.SpatialGate_0 is None else self.SpatialGate_0(x)


class CBAMPostProcessing(nn.Module):
    """5x5 conv to 64*clrch channels, CBAM, 5x5 conv to an eighth of that,
    tanh, 5x5 conv back to the image's channels, plus the input times
    ``res_weight``."""

    def __init__(self, clrch: int):
        super().__init__()
        width = 64 * clrch
        self.res_weight = nn.Parameter(torch.tensor(0.1))
        self.Conv_0 = Conv2d(clrch, width, 5)
        self.CBAM_0 = CBAM(width, 16)
        self.Conv_1 = Conv2d(width, width // 8, 5)
        self.Conv_2 = Conv2d(width // 8, clrch, 5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.CBAM_0(self.Conv_0(x))
        h = self.Conv_2(torch.tanh(self.Conv_1(h)))
        return h + x * self.res_weight
