"""Train cells: the program's ``make_chained_train_step`` with the cell's
``steps_per_call`` k (on a card one CUDA graph of k whole steps, the
capturable Adam), in a closed loop like the agent's epoch: each chunk of k
batches is uploaded by the call, and its (k, 4) rows are read back while
the next chunk is drawn.

Set-up builds the one step object and drives it from the seeded state
through the window's own call for its first ``ceil(3 / k)`` calls (the
first of them captures the graph); the same object then runs the window.
Once the window has closed, the same object makes one more call, from its
state after the window, on the chunk the window drew last and never
stepped; the check compares both (``harness/checks.py``).
``train_mpix_s`` is the pixels of every optimizer step completed over the
window, from the first chunk handed in to the last rows read back."""

from __future__ import annotations

import time

import torch

from .. import work
from ..harness import checks, port, trace
from ..harness.weights import seeded_reference
from ..traffic.generator import Traffic, stream_seed

CHECKED_STEPS = 3


def _host(tensors):
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors}


def run(ctx) -> dict:
    p, dev = ctx.params, ctx.device
    spec = p.get("weights")     # the seeded weights' options
    tp = p["traffic"]
    lam, lr, rw = p["lambda"], p["learning_rate"], p["rate_weight"]
    k = tp["steps_per_call"]
    cfg = port.config(ctx.model_cfg, {
        "lambda_": lam, "learning_rate": lr, "batch_size": tp["batch"],
        "patch_size": tp["patch"], "steps_per_call": k})
    ref = seeded_reference(ctx.model_cfg, ctx.seed, dev, spec)
    model = port.model(cfg, ref.state_dict(), dev)
    del ref
    step, opt = port.train_step(cfg, model, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(stream_seed(ctx.seed, "noise", 64))
    gen_state = gen.get_state()
    traffic = Traffic(tp, ctx.seed)

    # the first calls, from the seeded state: the first captures the graph
    calls = -(-CHECKED_STEPS // k)
    chunks, rows0 = [], []
    for i in range(calls):
        chunks.append(traffic.next())
        t = time.perf_counter()
        rows0 += step(chunks[-1], gen, lr, rw, lam).cpu().tolist()
        if i == 0:
            first_call_s = time.perf_counter() - t
            moments = {n: opt.state[q]["exp_avg"].detach().to("cpu",
                                                              copy=True)
                       for n, q in model.named_parameters()
                       if q in opt.state}
    after = _host(model.named_parameters())
    setup_s = time.perf_counter() - ctx.t0

    tracer = ctx.tracer
    steps = attempted = failed = 0
    with tracer.window():
        chunk = traffic.next()
        t_start = time.perf_counter()
        with tracer.phase("step"):
            rows = step(chunk, gen, lr, rw, lam)
        attempted += k
        while True:
            with tracer.phase("prepare"):
                chunk = traffic.next()
            with tracer.phase("readback"):
                r = rows.cpu()
            if bool(torch.isfinite(r).all()):
                steps += k
            else:
                failed += k
            if time.perf_counter() - t_start >= ctx.seconds:
                break
            with tracer.phase("step"):
                rows = step(chunk, gen, lr, rw, lam)
            attempted += k
        window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(dev).type == "cuda" else 0

    view = None
    if ctx.trace:
        host = {"graph_capture_s": first_call_s} \
            if torch.device(dev).type == "cuda" else {}

        def count():
            return {"flops": k * work.step_flops(
                ctx.model_cfg, tp["batch"], tp["patch"], tp["patch"],
                train=True), "peak_flops": work.peak_flops(ctx.model_cfg)}
        view = trace.read_profile(tracer.prof, (steps + failed) // k,
                                  count, host)

    # the later call, outside the window, from the state the window left
    before = checks.adam_state(model, opt)
    late_gen = gen.get_state()
    late_rows = step(chunk, gen, lr, rw, lam).cpu().tolist()
    late_after = checks.adam_state(model, opt)

    del step, opt, model, rows
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ref = seeded_reference(ctx.model_cfg, ctx.seed, dev, spec)
    init = {n: q.detach().clone() for n, q in ref.named_parameters()}
    ref_rows, ref_m, ref_p = checks.reference_train(
        ref, chunks, gen_state, lr, rw, lam, dev, moment_after=k)
    first = checks.train_numbers(rows0, moments, after, init, ref_rows,
                                 ref_m, ref_p)
    del ref_m, ref_p, init
    end = {}
    ref_rows, _, _ = checks.reference_train(
        ref, [chunk], late_gen, lr, rw, lam, dev, start=before, end=end)
    late = checks.late_numbers(late_rows, before, late_after, ref_rows, end,
                               k)
    numbers = checks.merged(first, late)
    pixels = tp["batch"] * tp["patch"] ** 2
    return {"attempted": attempted, "failed": failed, "numbers": numbers,
            "view": view, "peak_bytes": peak,
            "e2e": {"train_mpix_s": steps * pixels / window_s / 1e6,
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
