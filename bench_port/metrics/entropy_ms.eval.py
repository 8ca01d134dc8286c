"""Device ms a batch launched inside the entropy model's forward (ZTsep's
context stacks and Gaussian likelihoods, or the factorized bottlenecks)."""

SPANS = [{"span": "entropy", "attr": "entropymodel", "methods": ["forward"]}]


def read(t):
    ms = t.span_ms("entropy")
    return None if ms is None or not t.requests else ms / t.requests
