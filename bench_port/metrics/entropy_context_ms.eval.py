"""Device ms a batch launched inside the program's ``entropy.context``
span: the context networks that give (sigma, mu) (ZTsep's plc, csc and
cgp stacks with their fusion, and both PixelCNNs). None where the entropy
model has none (the factorized bottlenecks)."""

from bench_port.harness import program


def read(t):
    ms = program.device_ms(t, "entropy.context")
    return None if ms is None or not t.requests else ms / t.requests
