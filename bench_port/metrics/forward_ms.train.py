"""Device ms a step of the captured train graph spends in its
``train.forward`` phase: the colour conversion, the codecs' forward and
the loss, timed by the pair of events the program records into the graph
around it, the mean over the steps of the replays launched while the
profiler recorded. None where the step has no graph or no timed phases."""

from bench_port.harness import program


def read(t):
    return program.phase_ms("train.forward")
