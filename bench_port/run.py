"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, warms up, measures for ``--seconds``, checks one output of the
measured path against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers compared come last (``checks``) and again as the
last lines of standard error. A cell's files are found by its name:
``workloads/<cell>.json`` names its configuration (``configs/<name>.json``)
and its entry (``entries/<entry>.py``); a per-layer metric's reader is
``metrics/<metric>.py``. Without a CUDA device, or with fewer than the cell
asks for, it exits 2 and prints no result; if JAX, flax or the JAX package
was loaded, it exits 3.
"""

import time

T0 = time.perf_counter()   # set-up counts from the process's start

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(name, seed, seconds, trace, device="cuda", t0=None,
             overrides=None):
    """One run of cell ``name``: the result's line as a dict and the
    checks. ``overrides`` replaces entries of the cell's file (the CPU
    rehearsals' small sizes)."""
    import torch

    from bench_port.harness import checks, common
    from bench_port.harness.trace import Tracer

    bench = common.manifest()
    params = common.workload(name)
    for key, value in (overrides or {}).items():
        if isinstance(value, dict):
            params[key] = dict(params.get(key, {}), **value)
        else:
            params[key] = value
    model_cfg = common.model_config(params["config"])
    model_cfg.update(params.get("config_overrides", {}))
    wanted = common.cell_metrics(bench, name, trace)
    readers = {m["name"]: load_reader(m["name"]) for m in wanted} \
        if trace else {}
    specs = [s for r in readers.values() for s in getattr(r, "SPANS", [])]
    ctx = SimpleNamespace(
        name=name, params=params, model_cfg=model_cfg, seed=seed,
        seconds=seconds, trace=trace, device=device,
        t0=time.perf_counter() if t0 is None else t0,
        tracer=Tracer(trace, device), span_specs=specs)
    entry = importlib.import_module(f"bench_port.entries.{params['entry']}")
    out = entry.run(ctx)

    metrics = {}
    if trace:
        for m in wanted:
            value = readers[m["name"]].read(out["view"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in wanted:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu",
            "count": 1, "memory_peak_bytes": int(out["peak_bytes"])}
    if dev.type == "cuda":
        info["power_limit_w"] = common.power_limit()
    result = {"attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = out["view"].busy_s
        info["window_s"] = out["view"].window_s
        result["breakdown"] = out["view"].breakdown()
    judged = checks.judged(out["numbers"], params["limits"])
    result["correct"] = (checks.passes(judged) and out["failed"] == 0
                         and out["attempted"] > 0)
    result["numbers"] = out["numbers"]
    return result, judged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_port.harness import common

    cells = {w["name"]: w for w in common.manifest()["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result, judged = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    banned = common.banned_modules()
    if banned:
        print(f"modules loaded that the port must not load: {banned}",
              file=sys.stderr)
        return 3
    common.emit(result, judged)
    return 0


if __name__ == "__main__":
    sys.exit(main())
