"""Host seconds of the chained step's graph capture after its eager
warm-up: the recording of the k steps and the graph's instantiation
(``record_s`` of the program's first capture, kept in its counter
registry). The part of ``graph_capture_s.train`` that is not warm-up or
first replay. Moves ``setup_s``."""

from bench_port.harness import program


def read(t):
    c = program.counters()
    return c["captures"][0]["record_s"] if c and c["captures"] else None
