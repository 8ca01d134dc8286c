"""Device ms a batch launched inside the transform's ``encode`` and
``decode`` (learned lifting or the 9/7 ladders, and the colour planes'
packing), less what its subband autoencoders' spans cover."""

SPANS = [
    {"span": "transform", "attr": "transform",
     "methods": ["encode", "decode"]},
    {"span": "subband_ae",
     "classes": ["SubbandAutoEncoder", "SubbandAutoEncoderBerk"],
     "methods": ["encode", "decode"]},
]


def read(t):
    whole = t.span_ms("transform")
    if whole is None or not t.requests:
        return None
    return (whole - (t.span_ms("subband_ae") or 0.0)) / t.requests
