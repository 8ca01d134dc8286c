"""Device ms a step of the captured train graph spends in its
``train.backward`` phase: the loss's backward pass, timed by the pair of
events the program records into the graph around it, the mean over the
steps of the replays launched while the profiler recorded. None where
the step has no graph or no timed phases."""

from bench_port.harness import program


def read(t):
    return program.phase_ms("train.backward")
