"""The program's spans and counters against the harness's own readings, and
what tracing costs, on the card.

    python3 bench_port/reconcile.py --workload <cell> --seed <n> \
        [--seconds 20] [--calls 6]

In one process: one traced run of the cell (``run.py``'s ``run_cell``,
the trace's view kept) gives its per-layer metrics and, beside them, the
device ms a request under every program span, the mean host ms of each,
the counter registry, the busy device time a request, the breakdown and
every range open at the middle of its five longest idle gaps;
then, on a step built afresh from the same seed, ``--calls`` calls timed
to the device's end untraced, the same number under a profiler (host and
device, as a traced run has it), and both again, in that order. One JSON
line. The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SPANS = ["eval.step", "eval.upload", "color", "eval.loss", "codec.encode",
         "codec.decode", "subband_ae.encode", "subband_ae.decode",
         "codec.entropy", "entropy.context", "entropy.likelihood",
         "entropy.aux_loss", "conv3x3", "chain.call", "chain.upload",
         "chain.scalars", "chain.replay", "chain.rows", "train.forward",
         "train.backward", "train.optimizer"]


def traced_run(name, seed, seconds, device="cuda"):
    from bench_port import run
    from bench_port.harness import program, trace

    views = []
    read_profile = trace.read_profile

    def keep(*args, **kwargs):
        views.append(read_profile(*args, **kwargs))
        return views[-1]

    trace.read_profile = keep
    try:
        result, _ = run.run_cell(name, seed, seconds, True, device, T0)
    finally:
        trace.read_profile = read_profile
    v = views[0]
    n = max(v.requests, 1)
    spans = {}
    for s in SPANS:
        dev, host = program.device_ms(v, s), program.host_ms(v, s)
        if dev is not None or host is not None:
            spans[s] = {"device_ms_a_request": None if dev is None
                        else dev / n, "host_ms_mean": host,
                        "ranges": len(program.ranges(v, s))}
    harness = {s: v.span_ms(s) / n for s in ("entropy", "transform",
                                              "subband_ae", "conv3x3")
               if v.span_ms(s) is not None}
    gaps = []
    idle = trace.gaps_ns([(s, e) for _, s, e, _ in v.device], v.lo, v.hi)
    for lo, hi in sorted(idle, key=lambda g: g[0] - g[1])[:5]:
        mid = (lo + hi) // 2
        gaps.append({"ms": (hi - lo) / 1e6, "open": sorted(
            [(e - s) / 1e6, n] for n, s, e in v.annotations if s <= mid <= e)})
    return {"correct": result["correct"], "attempted": result["attempted"],
            "requests": v.requests, "busy_s": v.busy_s,
            "window_s": v.window_s, "busy_ms_a_request": 1e3 * v.busy_s / n,
            "metrics": {k: m["value"] for k, m in result["metrics"].items()},
            "program_spans": spans, "harness_spans_ms_a_request": harness,
            "counters": program.counters(),
            "breakdown": result["breakdown"], "gaps": gaps}


def _step(name, seed, device):
    """A call of a fresh step object of the cell that returns once the
    device has finished."""
    import torch

    from bench_port.harness import common, port
    from bench_port.harness.weights import seeded_reference
    from bench_port.traffic.generator import Traffic, stream_seed

    p = common.workload(name)
    model_cfg = common.model_config(p["config"])
    ref = seeded_reference(model_cfg, seed, device, p.get("weights"))
    tp = p["traffic"]
    if p["entry"] == "eval":
        cfg = port.config(model_cfg, {"lambda_": p["lambda"]})
        step = port.eval_step(cfg, port.model(cfg, ref.state_dict(), device),
                              device)
        x = torch.from_numpy(Traffic(tp, seed).next())
        if torch.device(device).type == "cuda":
            x = x.pin_memory()

        def call():
            out = step(x)
            out[0][0].item()
    else:
        cfg = port.config(model_cfg, {
            "lambda_": p["lambda"], "learning_rate": p["learning_rate"],
            "batch_size": tp["batch"], "patch_size": tp["patch"],
            "steps_per_call": tp["steps_per_call"]})
        step, _ = port.train_step(cfg, port.model(cfg, ref.state_dict(),
                                                  device), device)
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, "noise", 64))
        traffic = Traffic(tp, seed)
        chunk = traffic.next()

        def call():
            step(chunk, gen, p["learning_rate"], p["rate_weight"],
                 p["lambda"]).cpu()
    del ref
    return call


def tracing_cost(name, seed, calls, device="cuda"):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    call = _step(name, seed, device)
    call()      # build, plan, capture
    call()
    walls = {"untraced": [], "traced": []}
    for mode in ("untraced", "traced", "untraced", "traced"):
        prof = profile(activities=acts) if mode == "traced" else None
        if prof is not None:
            prof.start()
        for _ in range(calls):
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            walls[mode].append(1e3 * (time.perf_counter() - t))
        if prof is not None:
            prof.stop()
    return {m: {"median_ms": statistics.median(w), "ms": w}
            for m, w in walls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--calls", type=int, default=6)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("reconcile needs a CUDA device", file=sys.stderr)
        return 2
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0)}
    out.update(traced_run(args.workload, args.seed, args.seconds))
    torch.cuda.empty_cache()
    out["cost"] = tracing_cost(args.workload, args.seed, args.calls)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
