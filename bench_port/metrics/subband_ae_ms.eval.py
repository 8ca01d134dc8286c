"""Device ms a batch launched inside the subband autoencoders' ``encode``
and ``decode`` (the GDN companders or the pointwise grouped ones)."""

SPANS = [
    {"span": "subband_ae",
     "classes": ["SubbandAutoEncoder", "SubbandAutoEncoderBerk"],
     "methods": ["encode", "decode"]},
]


def read(t):
    ms = t.span_ms("subband_ae")
    return None if ms is None or not t.requests else ms / t.requests
