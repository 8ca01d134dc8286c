"""Tiny sizes at which the CPU rehearses each cell: two wavelet levels,
two pool images of 64^2, batches of two 32x48 images or of two 32^2
patches, the cell's own steps a call."""

import importlib.util
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ["flagship_fp32.eval", "flagship_fp32.train", "cdf97_fp32.eval"]
EVAL = {"config_overrides": {"dwtlevels": 2},
        "traffic": {"pool": 2, "pool_size": 64, "batch": 2, "rows": 32,
                    "cols": 48}}
TRAIN = {"config_overrides": {"dwtlevels": 2},
         "traffic": {"pool": 2, "pool_size": 64, "batch": 2, "patch": 32}}


def overrides(cell):
    return EVAL if cell.endswith(".eval") else TRAIN


def run_module():
    spec = importlib.util.spec_from_file_location(
        "bench_port.run", os.path.join(HERE, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rehearse(cell, seed=2 ** 31 + 17, seconds=0.5, trace=False):
    return run_module().run_cell(cell, seed, seconds, trace, "cpu",
                                 overrides=overrides(cell))
