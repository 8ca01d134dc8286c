"""The factorized bottleneck: per value, a 1-3-3-3-3-1 per-channel MLP at
v - 0.5 and v + 0.5."""

from bench_port.work import Layer


def layers(cfg, c, b, h, w):
    values = b * c * h * w
    return [Layer("matmul", 2 * values, a, f, 1, 1)
            for a, f in ((1, 3), (3, 3), (3, 3), (3, 3), (3, 1))]
