"""Tiny sizes at which the CPU rehearses each cell: two wavelet levels,
two pool images of 64^2, batches of two 32x48 images or of two 32^2
patches, the cell's own steps a call. The cells are ``BENCHMARK.json``'s,
and each takes the sizes of its entry, so a cell added there is rehearsed
with no edit here."""

import importlib.util
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = {"config_overrides": {"dwtlevels": 2},
        "traffic": {"pool": 2, "pool_size": 64, "batch": 2, "rows": 32,
                    "cols": 48}}
TRAIN = {"config_overrides": {"dwtlevels": 2},
         "traffic": {"pool": 2, "pool_size": 64, "batch": 2, "patch": 32}}
BY_ENTRY = {"eval": EVAL, "train": TRAIN}


def cells():
    """Every cell of ``BENCHMARK.json``."""
    from bench_port.harness import common
    return [w["name"] for w in common.manifest()["workloads"]]


def overrides(cell):
    from bench_port.harness import common
    return BY_ENTRY[common.workload(cell)["entry"]]


def run_module():
    spec = importlib.util.spec_from_file_location(
        "bench_port.run", os.path.join(HERE, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rehearse(cell, seed=2 ** 31 + 17, seconds=0.5, trace=False):
    return run_module().run_cell(cell, seed, seconds, trace, "cpu",
                                 overrides=overrides(cell))
