"""Seconds of the chained step's first call on the host clock: the eager
warm-up steps, the graph's recording and instantiation, and its first
replay (``train/state.py::GraphChain``). Moves ``setup_s``."""


def read(t):
    return t.host.get("graph_capture_s")
