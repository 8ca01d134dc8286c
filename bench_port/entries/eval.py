"""Eval cells: the program's ``make_eval_step`` in a closed loop with one
client. The requests are the traffic generator's ring of batches, handed
to the step in turn as host float32 NCHW in page-locked memory (as a
loader with pinned memory hands them: the upload is one DMA); each
batch's RD terms are read back once the next has been handed in.
``eval_mpix_s`` is the pixels of every batch completed over the window,
from the first batch handed in to the last result read back."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import work
from ..harness import checks, port, spans, trace
from ..harness.weights import seeded_reference
from ..traffic.generator import Traffic, stream_seed


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> dict:
    p, dev = ctx.params, ctx.device
    spec = p.get("weights")     # the seeded weights' options
    lam = p["lambda"]
    cfg = port.config(ctx.model_cfg, {"lambda_": lam})
    ref = seeded_reference(ctx.model_cfg, ctx.seed, dev, spec)
    model = port.model(cfg, ref.state_dict(), dev)
    del ref
    step = port.eval_step(cfg, model, dev)
    traffic = Traffic(p["traffic"], ctx.seed)
    batches = [torch.from_numpy(b) for b in traffic.ring]
    if torch.device(dev).type == "cuda":
        batches = [b.pin_memory() for b in batches]

    # warm-up: the cell's one shape
    step(batches[0])
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    if ctx.trace:
        spans.install(model, ctx.span_specs)

    tracer = ctx.tracer
    pick = np.random.RandomState(stream_seed(ctx.seed, "sample"))
    kept, pending = None, None
    done = attempted = failed = 0

    def finish(item):
        nonlocal kept, done, failed
        out, x = item
        with tracer.phase("readback"):
            terms = torch.stack([t.reshape(()) for t in out[0][:4]]).cpu()
        if not bool(torch.isfinite(terms).all()):
            failed += 1
        done += 1
        if pick.random_sample() * done < 1.0:     # a uniform sample
            kept = ([float(t) for t in terms], out[1], x)

    with tracer.window():
        t_start = time.perf_counter()
        while True:
            with tracer.phase("prepare"):
                x = batches[attempted % len(batches)]
            with tracer.phase("step"):
                out = step(x)
            attempted += 1
            if pending is not None:
                finish(pending)
            pending = (out, x)
            if time.perf_counter() - t_start >= ctx.seconds:
                break
        finish(pending)
        _sync(dev)
        window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(dev).type == "cuda" else 0
    pending = out = None

    view = None
    if ctx.trace:
        b, h, w = (p["traffic"][k] for k in ("batch", "rows", "cols"))

        def count():
            return {"flops": work.step_flops(ctx.model_cfg, b, h, w),
                    "least_ms": work.least_ms_by_kind(ctx.model_cfg, b, h,
                                                      w),
                    "peak_flops": work.peak_flops(ctx.model_cfg)}
        view = trace.read_profile(tracer.prof, done, count, {})

    # the check, once the program's state is freed
    terms, xhat, x = kept
    xhat = xhat.cpu()
    del model, step, kept, batches
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ref = seeded_reference(ctx.model_cfg, ctx.seed, dev, spec)
    ref_terms, ref_xhat = checks.reference_eval(ref, x, lam, dev)
    numbers = checks.eval_numbers(terms, xhat, ref_terms, ref_xhat)
    return {"attempted": attempted, "failed": failed, "numbers": numbers,
            "view": view, "peak_bytes": peak,
            "e2e": {"eval_mpix_s": done * traffic.pixels() / window_s / 1e6,
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
