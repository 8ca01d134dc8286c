"""The whole train step's share of the card's peak FLOP/s for the
configuration's dtype (``work.peak_flops``; float32: 67 TFLOP/s, TF32
off): FLOPs of a chunk's k steps (forward, dk, dx) from the
configuration's shapes (``work``), times the chunks completed, over the
traced window."""


def read(t):
    work = t.work
    if not work or not t.requests or t.window_s <= 0:
        return None
    return 100.0 * work["flops"] * t.requests \
        / (t.window_s * work["peak_flops"])
