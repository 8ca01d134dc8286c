"""Time the bf16 3x3 conv kernel (``ops/conv_v2.py``) at every shape of the
main path, on one CUDA card.

    python imagecompressionlearnedliftingandlearnedtreebasedmodels_torch/tools/conv_v2_bench.py [--root DIR]

``--root`` names the checkout whose port package (and ``chip_smoke.py``,
for the shapes) is imported: by default the one this file lies in. So two
versions of the kernel compare on one card by timing a copy of another
commit (``git archive`` into a directory) and this one in turns, e.g.
other, this, this, other.

Shapes: every dense 3x3 conv of the flagship's bf16 B=8 512x768 eval step
(forward) and of its B=8 256x256 train step (forward and dx, the dx as the
same kernel on Cin and Cout swapped), each with its launches a step. For
each: the kernel's ms by CUDA events around repeated launches through the
wrapper (``launch_kernel``: the padding copies, the host's work and the
kernel, what a caller pays), its device microseconds alone from
torch.profiler, the wrapper's host microseconds a call, its error against
``conv_v2_plain``, cuDNN's ``F.conv2d`` ms (the yardstick) and the bound
(``chip_smoke.conv_bound``). One JSON line a shape, then the sums a step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def device_us(torch, fn, reps=10):
    """Mean device microseconds of the kernels named ``conv_v2_kernel`` in
    one call of ``fn``, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "conv_v2_kernel" in e.key) / reps


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
    args = ap.parse_args()
    root = os.path.abspath(args.root)
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
    t0 = time.perf_counter()
    v2.build()
    print(json.dumps({"root": root, "source": v2.SOURCE, "card": card,
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
        xl = x.to(torch.bfloat16).contiguous(memory_format=cl)
        w9 = conv.tap_major(wt, torch.bfloat16)
        wl = wt.to(torch.bfloat16).contiguous(memory_format=cl)
        with torch.no_grad():
            got = v2.launch_kernel(xl, w9)
            want = v2.conv_v2_plain(x, wt)
            torch.cuda.synchronize()
            err = ((got - want).abs().max() / want.abs().max()).item()
            del got, want
            run = lambda: v2.launch_kernel(xl, w9)  # noqa: E731
            row = {"path": path, "x": [b, cin, h, w], "cout": cout,
                   "launches_per_step": n, "max_rel_err": err,
                   "ms": cs.time_ms(run, torch),
                   "device_us": device_us(torch, run),
                   "host_us": host_us(torch, run),
                   "library_ms": cs.time_ms(
                       lambda: F.conv2d(xl, wl, padding=1), torch),
                   "bound_ms": cs.conv_bound(b * h * w, cin, cout)[0]}
        print(json.dumps(row), flush=True)
        for k in ("ms", "library_ms", "bound_ms"):
            sums[f"{path}:{k}"] = sums.get(f"{path}:{k}", 0.0) + n * row[k]
        sums[f"{path}:device_ms"] = sums.get(f"{path}:device_ms", 0.0) \
            + n * row["device_us"] / 1e3
        del x, wt, xl, w9, wl
    print(json.dumps({"root": root, "card": card, "per_step": sums}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
