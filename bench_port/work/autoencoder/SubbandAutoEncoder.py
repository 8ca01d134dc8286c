"""The pointwise autoencoder: encode and decode stacks of grouped 1x1
convs ic -> 32ic -> 32ic -> 32ic -> ic, ``ic`` groups."""

from bench_port.work import Layer


def _stack(ic, pixels, first_dx):
    widths = [(ic, 32 * ic), (32 * ic, 32 * ic), (32 * ic, 32 * ic),
              (32 * ic, ic)]
    return [Layer("conv1x1g", pixels, a, b, 1, ic, first_dx or i > 0)
            for i, (a, b) in enumerate(widths)]


def layers(cfg, ic, pixels, encoder_dx):
    return _stack(ic, pixels, encoder_dx) + _stack(ic, pixels, True)
