"""Host ms a call of the eval step spends inside the program's
``eval.step`` span (the enqueue of the upload, the colour conversion, the
codecs and the loss, and any wait on the device inside them), the mean
over the window's calls."""

from bench_port.harness import program


def read(t):
    return program.host_ms(t, "eval.step")
