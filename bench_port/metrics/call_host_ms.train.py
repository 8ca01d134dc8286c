"""Host ms a call of the chained train step spends inside the program's
``chain.call`` span (the wait on the last upload, the pinned copy, the
scalars, the graph's launch and the rows' copy), the mean over the
window's calls."""

from bench_port.harness import program


def read(t):
    return program.host_ms(t, "chain.call")
