"""Share of the traced window in which no operation ran on the device:
100 x (1 - the union of the device's activity intervals / the window)."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
