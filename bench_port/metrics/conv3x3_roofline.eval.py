"""Share of its roofline that the dense 3x3 conv layer reaches: the least
time of a batch's dense 3x3 convs, counted from the configuration's shapes
(``work``), over the device time a batch under the ``FastConv3x3``
layers (kernel 1 and the bias add). The work is the same whatever
implements it."""

SPANS = [{"span": "conv3x3", "classes": ["FastConv3x3"],
          "methods": ["forward"]}]


def read(t):
    ms, work = t.span_ms("conv3x3"), t.work
    least = work["least_ms"].get("conv3x3", 0.0) if work else 0.0
    if ms is None or not t.requests or least <= 0:
        return None
    return 100.0 * least / (ms / t.requests)
