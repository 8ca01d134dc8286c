"""The GDN autoencoder: encode and decode stacks of 3x3 convs ic -> 32ic ->
64ic -> 32ic -> ic, a GDN contraction after each of the first three."""

from bench_port.work import Layer


def _stack(ic, pixels):
    out = []
    widths = [(ic, 32 * ic), (32 * ic, 64 * ic), (64 * ic, 32 * ic),
              (32 * ic, ic)]
    for i, (a, b) in enumerate(widths):
        out.append(Layer("conv3x3", pixels, a, b, 3, 1))
        if i < 3:
            out.append(Layer("gdn", pixels, b, b, 1, 1))
    return out


def layers(cfg, ic, pixels, encoder_dx):
    return _stack(ic, pixels) + _stack(ic, pixels)
