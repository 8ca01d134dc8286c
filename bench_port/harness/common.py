"""What every cell shares: finding a cell's files by name, the device's
description, the check that JAX stayed out of the process, and the
result's line."""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax",
          "imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    """A cell's file, ``workloads/<name>.json``."""
    return load_json(os.path.join(HERE, "workloads", f"{name}.json"))


def model_config(name: str) -> dict:
    """A configuration's file, ``configs/<name>.json``."""
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metrics this cell reports: its end-to-end ones (a metric without
    a ``workloads`` key in every cell), or with ``trace`` the per-layer
    ones whose ``workloads`` name it."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def banned_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name begins with the last)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines of standard error, and the result as
    the last line of standard output with the checks as its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = checks
    print(json.dumps(out), flush=True)
