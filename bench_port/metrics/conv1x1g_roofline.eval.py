"""Share of its roofline that the grouped 1x1 conv layer reaches (ZTsep's
cgp fusion stacks, the pointwise autoencoders): the least time of a
batch's grouped 1x1 convs from the configuration's shapes (``work``)
over the device time a batch under those layers, layout transposes
included."""

SPANS = [{"span": "conv1x1g", "classes": ["Conv2d"], "kernel": 1,
          "grouped": True, "methods": ["forward"]}]


def read(t):
    ms, work = t.span_ms("conv1x1g"), t.work
    least = work["least_ms"].get("conv1x1g", 0.0) if work else 0.0
    if ms is None or not t.requests or least <= 0:
        return None
    return 100.0 * least / (ms / t.requests)
