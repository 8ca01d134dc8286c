"""Time a kernel of the port at every shape of the main path, on one CUDA
card: the bf16 tensor-core conv (``ops/conv_v2.py``, the default), with
``--kernel conv3x3_halo`` the fp32 CUDA-core conv (``ops/conv3x3_halo.py``)
on fp32 operands, or with ``--kernel lift97`` the CDF 9/7 ladder a 2-D level
at a time (``ops/dwt97.py``, each level of the CDF97 eval and train steps).

    python imagecompressionlearnedliftingandlearnedtreebasedmodels_torch/tools/conv_v2_bench.py [--kernel conv_v2|conv3x3_halo|lift97] [--root DIR]

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


def lift97_bench(torch, cs, bounds, card, root) -> int:
    """The CDF 9/7 ladder, level by level, as the root's package runs it on
    the path: its ``ops/dwt97.py`` level forward (``level_analysis``, one
    launch, where it has one; else the three one-axis passes and the pack's
    copy) and inverse, each at every level of the CDF97 eval and train
    steps. Device time sums every kernel of the call (the copies too); the
    sums per path add one call each way a level (a train step's backward
    adds one more analysis a level)."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        dwt97, lift97)
    t0 = time.perf_counter()
    lift97.build()
    print(json.dumps({"root": root, "source": lift97.SOURCE, "card": card,
                      "torch": torch.__version__,
                      "build_s": time.perf_counter() - t0}), flush=True)
    if hasattr(dwt97, "level_analysis"):
        form = "level kernel"

        def analysis(x):
            return dwt97.level_analysis(x, lift97.FORWARD)

        def synthesis(ll, pack):
            return dwt97.level_synthesis(ll, pack, lift97.INVERSE)
    else:
        form = "three one-axis passes"

        def analysis(x):
            ll, lh, hl, hh = dwt97.dwt97_level(x)
            return ll, dwt97.pack_details(lh, hl, hh)

        def synthesis(ll, pack):
            return dwt97.idwt97_level(ll, *dwt97.unpack_details(pack))

    def plain_level(x):
        low, high = lift97.analysis_plain(x, 2)
        ll, hl = lift97.analysis_plain(low, 3)
        lh, hh = lift97.analysis_plain(high, 3)
        return ll, dwt97.pack_details(lh, hl, hh)

    levels = 4
    cases = [("eval", s) for s in bounds.level_shapes(levels, cs.B, cs.H,
                                                      cs.W)]
    cases += [("train", s) for s in bounds.level_shapes(
        levels, cs.CDF97_TRAIN_B, cs.TRAIN_P, cs.TRAIN_P)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    sums = {}
    for path, shape in cases:
        x = torch.randn(shape, device="cuda", generator=gen)
        with torch.no_grad():
            ll, pack = plain_level(x)
            got = analysis(x)
            back = synthesis(ll, pack)
            torch.cuda.synchronize()
            err = max(bounds.rel_err(got[0], ll), bounds.rel_err(got[1], pack),
                      bounds.rel_err(back, x))
            del got, back
            for way, fn in (("analysis", lambda: analysis(x)),
                            ("synthesis", lambda: synthesis(ll, pack))):
                us, source = bounds.device_us(torch, fn)
                row = {"kernel": "lift97", "form": form, "way": way,
                       "path": path, "x": list(shape), "max_rel_err": err,
                       "ms": cs.time_ms(fn, torch, min_ms=20.0),
                       "device_us": us, "device_source": source,
                       "host_us": bounds.host_us(torch, fn),
                       "bound_ms": 2 * x.numel() * 4 / bounds.PEAK_BYTES
                       * 1e3}
                print(json.dumps(row), flush=True)
                key = f"{path}:{way}"
                for k in ("ms", "bound_ms"):
                    sums[f"{key}:{k}"] = sums.get(f"{key}:{k}", 0.0) + row[k]
                sums[f"{key}:device_ms"] = sums.get(f"{key}:device_ms", 0.0) \
                    + row["device_us"] / 1e3
        del x, ll, pack
    print(json.dumps({"root": root, "kernel": "lift97", "form": form,
                      "card": card, "per_step": sums}), flush=True)
    return 0


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--kernel", choices=("conv_v2", "conv3x3_halo", "lift97"),
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
    if args.kernel == "lift97":
        return lift97_bench(torch, cs, bounds, card, root)
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
            us, source = bounds.device_us(torch, run, name)
            row = {"kernel": args.kernel, "path": path, "x": [b, cin, h, w],
                   "cout": cout, "launches_per_step": n, "max_rel_err": err,
                   "ms": cs.time_ms(run, torch),
                   "device_us": us, "device_source": source,
                   "host_us": bounds.host_us(torch, run),
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
