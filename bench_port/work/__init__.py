"""The work of one step, counted from a configuration file's shapes.

Every convolution and matrix product of the codec's step is listed with its
pixels, channels, kernel and groups, from the configuration's keys alone
(never from the program's objects). A layer's work is the same whatever
implements it: a masked conv counts its whole kernel, and each input,
output and weight byte is counted once.

The codec's parts are counted by files found by the configuration's names,
so that a configuration with a new part brings a file and edits none:

- ``transform/<netType>.py``: ``layers(cfg, c, b, h, w) -> (layers,
  subbands)``, the transform's own layers on ``b`` images of ``c`` channels
  and h x w, and the subbands its autoencoders see as ``(channels, pixels,
  encoder_dx)`` (``encoder_dx`` false where the autoencoder's input carries
  no gradient, as a fixed transform's output does);
- ``autoencoder/<autoencoder>.py``: ``layers(cfg, ic, pixels, encoder_dx)``,
  one subband's encode and decode stacks;
- ``entropy/<entropy_layer>.py``: ``layers(cfg, c, b, h, w)``.

A configuration with a part that has no file raises :class:`NoCount`; the
readers of a traced run that need the count then report nothing.

A training step counts each conv three times (forward, dk, and dx) except
the dx of a conv whose input carries no gradient.

Least time is ``max(flops / peak FLOP/s, bytes / peak bytes/s)``, on the
published peaks of one H100 SXM (NVIDIA's data sheet, dense) for the
configuration's ``dtype`` (float32 where it names none: the package's
default, run with TF32 off, so outside the tensor cores).
"""

from __future__ import annotations

import importlib.util
import os
from typing import List, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
BYTES = {"float32": 4, "bfloat16": 2}


class NoCount(LookupError):
    """No work counter for a part of the configuration."""


class Layer(NamedTuple):
    kind: str        # conv3x3 | conv1x1g | conv5x5 | masked | gdn | matmul
    pixels: int      # output positions (batch included)
    cin: int
    cout: int
    k: int
    groups: int
    needs_dx: bool = True

    @property
    def weights(self) -> int:
        return self.k * self.k * (self.cin // self.groups) * self.cout

    @property
    def flops(self) -> float:
        return 2.0 * self.pixels * self.weights

    def bytes(self, size: int = 4) -> float:
        return float(self.pixels * (self.cin + self.cout) + self.weights) \
            * size


def part(family: str, name: str):
    """The counter module ``<family>/<name>.py``."""
    path = os.path.join(HERE, family, f"{name}.py")
    if not os.path.isfile(path):
        raise NoCount(f"no work counter {family}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_work_{family}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dtype(cfg: dict) -> str:
    return cfg.get("dtype", "float32")


def peak_flops(cfg: dict) -> float:
    return PEAK_FLOPS[dtype(cfg)]


def _codec_layers(cfg: dict, c: int, b: int, h: int, w: int) -> List[Layer]:
    """One codec's layers (one plane group of ``c`` channels)."""
    out, subbands = part("transform", cfg["netType"]).layers(cfg, c, b, h, w)
    ae = part("autoencoder", cfg["autoencoder"])
    for ic, pixels, encoder_dx in subbands:
        out += ae.layers(cfg, ic, pixels, encoder_dx)
    return out + part("entropy", cfg["entropy_layer"]).layers(cfg, c, b, h, w)


def step_layers(cfg: dict, batch: int, height: int, width: int
                ) -> List[Layer]:
    """Every conv and product of one eval step (a forward pass) of the
    configuration on ``batch`` RGB images of height x width: one codec of
    three channels, or (``clrch`` 1) three codecs of one plane each."""
    if cfg["clrch"] == 1:
        return _codec_layers(cfg, 1, batch, height, width) * 3
    return _codec_layers(cfg, 3, batch, height, width)


def step_flops(cfg: dict, batch: int, height: int, width: int,
               train: bool = False) -> float:
    """FLOPs of one step: forward, or with ``train`` forward, dk and dx."""
    total = 0.0
    for layer in step_layers(cfg, batch, height, width):
        n = 1 + (1 + layer.needs_dx if train else 0)
        total += n * layer.flops
    return total


def least_ms(layers, precision: str = "float32") -> float:
    """Sum over ``layers`` of each one's least time on the card, in ms, in
    the dtype ``precision``."""
    total = 0.0
    for layer in layers:
        total += max(layer.flops / PEAK_FLOPS[precision],
                     layer.bytes(BYTES[precision]) / PEAK_BYTES)
    return total * 1e3


def least_ms_by_kind(cfg: dict, batch: int, height: int, width: int
                     ) -> dict:
    """{layer kind: least ms of one eval step's layers of that kind}."""
    by_kind: dict = {}
    for x in step_layers(cfg, batch, height, width):
        by_kind.setdefault(x.kind, []).append(x)
    return {k: least_ms(v, dtype(cfg)) for k, v in by_kind.items()}
