"""Time a 3x3 conv kernel of the port at every shape of the main path, on
one CUDA card: the bf16 tensor-core kernel (``ops/conv_v2.py``, the
default) or, with ``--kernel conv3x3_halo``, the fp32 CUDA-core kernel
(``ops/conv3x3_halo.py``) on fp32 operands.

    python imagecompressionlearnedliftingandlearnedtreebasedmodels_torch/tools/conv_v2_bench.py [--kernel conv_v2|conv3x3_halo] [--root DIR]

``--root`` names the checkout whose port package (and ``chip_smoke.py``,
for the shapes) is imported: by default the one this file lies in. So two
versions of the kernel compare on one card by timing a copy of another
commit (``git archive`` into a directory) and this one in turns, e.g.
other, this, this, other.

Shapes: every dense 3x3 conv of the flagship's B=8 512x768 eval step
(forward) and of its B=8 256x256 train step (forward and dx, the dx as the
same kernel on Cin and Cout swapped), each with its launches a step. For
each: the kernel's ms by CUDA events around repeated launches through the
wrapper (``launch_kernel``: any padding copies, the host's work and the
kernel, what a caller pays), its device microseconds alone from
torch.profiler (the kernels named ``conv_v2_kernel`` or
``conv3x3_halo_kernel``), the wrapper's host microseconds a call, its error
against the plain version, cuDNN's ``F.conv2d`` ms in the same operand
type (the yardstick; TF32 off for fp32) and the bound (``conv_bound`` of
this file's checkout's ``chip_smoke.py``). One JSON line a shape, then the
sums a step.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time


def device_us(torch, fn, kernel, reps=10, tries=3):
    """Mean device microseconds of the kernels whose name holds ``kernel``
    in one call of ``fn``, from torch.profiler. A trace that holds no such
    kernel (the profiler drops one now and then) is taken again, up to
    ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key) / reps
        if us > 0:
            break
    return us


def host_us(torch, fn, reps=200):
    """Host microseconds a call of ``fn`` (the card keeps up at the shapes
    this is asked for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--kernel", choices=("conv_v2", "conv3x3_halo"),
                    default="conv_v2")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # the bounds from this checkout's chip_smoke.py (another root's may not
    # take an operand type)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", os.path.join(os.path.dirname(os.path.dirname(
            here)), "chip_smoke.py"))
    bounds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bounds)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("conv_v2_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
        config)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        conv3x3_halo as conv, conv_v2 as v2)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if args.kernel == "conv_v2":
        mod, dtype, dname = v2, torch.bfloat16, "bfloat16"
        plain = v2.conv_v2_plain
    else:
        mod, dtype, dname = conv, torch.float32, "float32"
        plain = lambda x, wt: conv.conv3x3_halo_plain(x, wt, dtype)  # noqa: E731
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    name = f"{args.kernel}_kernel"
    t0 = time.perf_counter()
    mod.build()
    print(json.dumps({"root": root, "source": mod.SOURCE, "card": card,
                      "torch": torch.__version__,
                      "build_s": time.perf_counter() - t0}), flush=True)
    cfg = config.flagship_config(dtype="bfloat16")
    cases = [("eval", cs.B, k, n) for k, n in sorted(cs.conv_shapes(cfg).items())]
    train = sorted(cs.conv_shapes(cfg, (cs.TRAIN_P, cs.TRAIN_P)).items())
    cases += [("train_fwd", cs.TRAIN_B, k, n) for k, n in train]
    cases += [("train_dx", cs.TRAIN_B, (h, w, co, ci), n)
              for (h, w, ci, co), n in train]
    gen = torch.Generator(device="cuda").manual_seed(1)
    cl = torch.channels_last
    sums = {}
    for path, b, (h, w, cin, cout), n in cases:
        x = torch.randn(b, cin, h, w, device="cuda", generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) \
            / (3 * cin ** 0.5)
        xl = x.to(dtype).contiguous(memory_format=cl)
        w9 = conv.tap_major(wt, dtype)
        wl = wt.to(dtype).contiguous(memory_format=cl)
        with torch.no_grad():
            got = mod.launch_kernel(xl, w9)
            want = plain(x, wt)
            torch.cuda.synchronize()
            err = ((got - want).abs().max() / want.abs().max()).item()
            del got, want
            run = lambda: mod.launch_kernel(xl, w9)  # noqa: E731
            row = {"kernel": args.kernel, "path": path, "x": [b, cin, h, w],
                   "cout": cout, "launches_per_step": n, "max_rel_err": err,
                   "ms": cs.time_ms(run, torch),
                   "device_us": device_us(torch, run, name),
                   "host_us": host_us(torch, run),
                   "library_ms": cs.time_ms(
                       lambda: F.conv2d(xl, wl, padding=1), torch),
                   "bound_ms": bounds.conv_bound(b * h * w, cin, cout,
                                                 dname)[0]}
        print(json.dumps(row), flush=True)
        for k in ("ms", "library_ms", "bound_ms"):
            sums[f"{path}:{k}"] = sums.get(f"{path}:{k}", 0.0) + n * row[k]
        sums[f"{path}:device_ms"] = sums.get(f"{path}:device_ms", 0.0) \
            + n * row["device_us"] / 1e3
        del x, wt, xl, w9, wl
    print(json.dumps({"root": root, "kernel": args.kernel, "card": card,
                      "per_step": sums}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
