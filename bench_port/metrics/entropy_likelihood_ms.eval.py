"""Device ms a batch launched inside the program's ``entropy.likelihood``
span: the Gaussian bin likelihoods and their bits, or the factorized
bottlenecks' quantization, cumulative-logit MLP and likelihood."""

from bench_port.harness import program


def read(t):
    ms = program.device_ms(t, "entropy.likelihood")
    return None if ms is None or not t.requests else ms / t.requests
