#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card.
Each phase prints one JSON line; any fault ends the run with a non-zero
exit code and no result line:

1. card    the card's name and power limit (nvidia-smi) and torch's name;
2. build   ``csrc/conv3x3_halo.cu``, ``csrc/conv_v2.cu`` and ``csrc/lift97.cu``
           compiled with nvcc for sm_90a and the host C++ coding libraries
           (``csrc/rans.cpp``, ``csrc/wavefront_ctx.cpp``) with g++, all at
           once, with the flags each was built with;
3. kernel  the fp32 conv kernel (conv3x3_halo, CUDA cores) launched directly
           against its plain PyTorch version at every distinct eval-path
           shape (B=8, 512x768) in bf16 and fp32 operands, with its time, the
           plain version's, cuDNN's (``F.conv2d``, the yardstick, never used
           by the port) and the card's bound for the same work;
4. kernel_bwd  the same kernel's dx (on the flipped, swapped weight) and the
           dk product at every distinct training shape (B=8, 256x256), bf16
           and fp32, against ``conv3x3_halo_bwd_plain``, by direct launches,
           with their times, the bound and cuDNN's for the same gradients
           (``torch.nn.grad.conv2d_input`` / ``conv2d_weight``);
5. conv_v2_kernel  the bf16 tensor-core conv (conv_v2) against
           ``conv_v2_plain``: forward at every eval-path shape, the conv
           Function's forward, dx and dk in bf16 at every training shape, and
           forward at ``scripts/bench_pallas_v2.py``'s three shapes; per
           shape its time, TFLOP/s, the bound, the plain version's time,
           cuDNN's bf16 ``F.conv2d``, kernel 1's bf16 time, the wrapper's
           operand copies alone (``pad_ms``), the launch plan (N tile,
           stages, dynamic shared memory) and the kernel's registers and
           spills from the build log;
6. parity  the flagship codec in fp32 on one 256x256 image, on the card and
           on the CPU (plain versions), with the committed lambda=2000
           weights: loss, mse, rates and xhat must agree;
7. train_parity  one fp32 train step of the flagship (lambda=2000 weights,
           a seeded batch of two 128x128 patches, noise from a CPU
           generator with one seed) on the card and on the CPU: loss, mse,
           rates and every gradient tensor must agree (cuDNN made
           deterministic, so the reading repeats);
8. main    the flagship codec in bf16 at full width and size (B=8 seeded
           512x768 images, lambda=2000 weights): bpp, PSNR, MP/s, ms per
           eval step, and conv_v2's launches per step (kernel 1's: none);
           checked against one fp32 step on the same batch;
9. profile one more eval step under torch.profiler: device busy time and
           the kernels that take most of it;
10. train  the flagship in bf16, B=8 patches of 256x256, from the
           lambda=2000 weights, Adam at lr 1e-4: 2 warm-up and 10 timed
           train steps (ms/step, patches/s, MP/s, every loss, conv_v2
           launches per step against the number reckoned from the model,
           peak memory), then one more step under torch.profiler;
11. agent  the CLI on a temporary copy of
           ``configs/flagship_lifting_ztsep.json`` (batch 2, patch 128,
           fp32, lambda 2000, 4 steps an epoch, 2 epochs): train, validate,
           save; then ``--resume-training`` restores epoch, iteration, lr
           and the Adam moments and takes one more epoch; then
           ``agent_test``: the CLI in ``mode: test`` on that checkpoint, a
           real bitstream of each synthetic test image;
12. bitstream  the real bitstream (``coding/codec_coder.py``: transforms on
           the card, entropy coding in host C++) of the flagship in fp32
           with the lambda=2000 weights over the 19 dead-leaves images of
           the held-out set (``synthetic_natural_images(19, 256,
           seed=9999)``), one at a time: every plane decodes to the
           encoder's writeback bit for bit, and each image's bpp and PSNR
           are held to the JAX package's on the same snapshot and images
           (``results/port_bitstream_targets.json``); the means beside
           ``results/rd_flagship.json``'s; seconds per image split into the
           transforms on the card and the host's coding; one image's
           transforms profiled (device busy time, largest device ops);
13. bitstream_bf16  the same 19 images with bf16 operands (conv_v2 in the
           analysis and synthesis): lossless, each image close to the fp32
           pass, 120 conv_v2 launches an image (60 in the analysis, 60 in
           the synthesis), one image's transforms profiled as in fp32;
           then two Kodak-size images (512x768) timed:
           s/image, coded MP/s, card and host.

Then the CDF 9/7 + factorized codec (``configs/cdf97_factorized.json`` at
full width: joint RGB, 4 levels, pointwise AEs, factorized bottlenecks,
fp32, random weights from the port's seeded init):

14. lift97_kernel  the ladder kernels in all four uses (analysis: the
           forward F and the adjoint of the inverse; synthesis: the inverse
           I and the adjoint of the forward) against their plain versions
           along H and W, at every distinct shape of the CDF97 eval path
           (B=8 512x768) and train path (B=4 256x256) and at
           ``scripts/bench_pallas.py``'s shapes; the adjoint identities on
           the card; times, the plain versions', the bound, and as the
           yardstick the same transform as one strided cuDNN conv (or
           transposed conv) with the 9/7 filters on a circularly padded
           input, never used by the port;
15. cdf97_parity  the eval step card vs CPU on one 256x256 image, then one
           train step card vs CPU with the training noise pinned to zero;
16. cdf97_main  the eval step at B=8 512x768 (ms, MP/s, bpp, PSNR, the
           ladder's launches against 24 a step), then one step profiled;
17. cdf97_train  the train step at the config's batch, 4 x 256x256, Adam at
           lr 1e-4: 2 warm-up and 10 timed steps (launches against 36 a
           step), then one step profiled;
18. cdf97_bitstream  the real bitstream of four 256x256 images: lossless,
           the real bpp within 3 % of the eval step's likelihood bpp, 24
           ladder launches an image;
19. cdf97_agent  the CLI on the config cut to 2 steps an epoch and 2
           epochs, then ``--resume-training``, then ``mode: test``.

Then a ``kernels`` line, the card's name and power limit again, and the
last line ``{"ok": true, "device": {...}}``.

TF32 is off (cuDNN and matmul) for every fp32 comparison and fp32 run:
phases 3 to 7, the fp32 step of phase 8, phases 11 and 12, 14, 15 and 18.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(HERE, "results", "ckpt_snapshots",
                        "flagship_lam2000.npz")
CONFIG = os.path.join(HERE, "configs", "flagship_lifting_ztsep.json")
CDF97_CONFIG = os.path.join(HERE, "configs", "cdf97_factorized.json")
B, H, W = 8, 512, 768            # the served workload: a batch of Kodak-size
STEPS = 3                        # timed eval steps of phase `main`
TRAIN_B, TRAIN_P = 8, 256        # the training workload: 8 patches of 256x256
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_LR = 1e-4
PARITY_B, PARITY_P = 2, 128      # the train step compared with the CPU's
AGENT = dict(batch_size=2, patch_size=128, dtype="float32", lambda_=2000.0,
             multi_agent=False, steps_per_epoch=4, max_epoch=2)
CDF97_SEED = 0                   # the port's init of the CDF97 codec
CDF97_TRAIN_B = 4                # the config's batch_size and patch_size
CDF97_AGENT = dict(multi_agent=False, steps_per_epoch=2, max_epoch=2)
BENCH_PALLAS_SHAPES = ((8, 3, 512, 768), (1, 3, 2048, 2048))  # NCHW
# scripts/bench_pallas_v2.py's SHAPES: NHWC input, Cout
BENCH_PALLAS_V2_SHAPES = (((8, 256, 384, 96), 192), ((8, 256, 384, 192), 96),
                          ((8, 128, 192, 96), 192))
TARGETS = os.path.join(HERE, "results", "port_bitstream_targets.json")
RD_FLAGSHIP = os.path.join(HERE, "results", "rd_flagship.json")
BITSTREAM_IMAGES = (19, 256, 9999)  # synthetic_natural_images(n, size, seed)
KODAK_IMAGES = 2                 # bitstream_bf16's timed 512x768 images
CDF97_BITSTREAM_IMAGES = 4       # 256x256
DEV = "cuda"
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-4   # max |kernel - plain| / max |plain|: fp32 sums of up to
                    # 9*243 exact products in another order
DK_TOL = {"float32": 1e-4,  # dk: a full-fp32 product in another order
          # bf16: B*H*W (up to 131072) exact bf16 products summed in fp32 by
          # the tensor cores, against the same products in a full-fp32
          # matmul: only the order and the rounding of the fp32 sums differ
          "bfloat16": 1e-3}
PARITY_RTOL = 1e-4  # loss, mse, rates: card vs CPU, fp32
# Gradients, card vs CPU, per tensor: max |g_card - g_cpu| / max |g_cpu|.
# The CPU's fp32 gradient is itself no reference to 1e-3: against the same
# step evaluated in float64 (tools/grad_conditioning.py) its worst tensor is
# 7.8e-3 off and 47 of the 714 are over 1e-3, the card's fp32 gradient
# likewise (7.8e-3, 65 tensors), each side off in tensors where the other is
# within 1e-5. So the two fp32 steps cannot be held to 1e-3 of each other
# (they differ by 4.4e-3 in the worst tensor; seeded random weights give
# 2.7e-3). cuDNN is made deterministic for the phase, so the reading repeats
# from run to run. The limit is 1e-2 per tensor and 1e-3 on the L2 norm of
# the difference over all gradients together.
GRAD_TOL = 1e-2
GRAD_L2_TOL = 1e-3
LADDER_TOL = 1e-5   # ladder kernel vs plain, of max |plain|: the same fp32
                    # expressions, contracted into FMAs by the compiler
ADJOINT_TOL = 1e-5  # |<Fx, y> - <x, F^T y>| / (|Fx| |y|), fp32 values
                    # summed in float64
LIBRARY_TOL = 1e-4  # the conv yardstick vs plain: 9 fp32 taps in another
                    # order (it is timed, never used by the port)
# CDF97 train step, card vs CPU, noise pinned: a shallow graph (pointwise
# AEs, per-channel MLPs, the linear ladder), held as the CPU tests hold
# the port against the JAX package at 64x64.
CDF97_GRAD_TOL = 1e-3
CDF97_GRAD_L2_TOL = 1e-4
XHAT_MEAN_TOL = 1e-5   # mean |xhat_card - xhat_cpu|
XHAT_MAX_TOL = 5e-2    # max: one rounding that flips moves a few pixels
BF16_BPP_RTOL = 5e-2   # bf16 vs fp32 step on the same batch
BF16_PSNR_TOL = 0.5    # dB
# The real bitstream in fp32 against the JAX package's on the same snapshot
# and images: the same C++ coding, subbands from another conv implementation
# (a symbol flips where a value sits within an ulp of a rounding boundary)
TARGET_BPP_RTOL = 5e-3
TARGET_PSNR_TOL = 0.02  # dB
# bf16 operands against the fp32 pass, image by image
BITSTREAM_BF16_BPP_RTOL = 2e-2
BITSTREAM_BF16_PSNR_TOL = 0.2  # dB
# CDF97: the real rate against the eval step's likelihood rate (rANS
# overhead and the escape coding past the tables' range)
CDF97_REAL_BPP_RTOL = 3e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def expect_launches(got, want, what) -> None:
    if got != want:
        raise AssertionError(f"{what} launched the kernel {got} times, "
                             f"expected {want}")


class Counts:
    """The kernel modules' launch counters, set to 0 and read together."""

    def __init__(self, conv, v2, lift):
        self.conv, self.v2, self.lift = conv, v2, lift

    def reset(self):
        self.conv.launches = self.conv.launches_dx = 0
        self.v2.launches = self.v2.launches_dx = 0
        self.lift.launches_lift = self.lift.launches_ilift = 0

    def read(self):
        return {"conv3x3_halo": self.conv.launches,
                "conv3x3_halo_dx": self.conv.launches_dx,
                "conv_v2": self.v2.launches,
                "conv_v2_dx": self.v2.launches_dx,
                "lift97": self.lift.launches_lift,
                "ilift97": self.lift.launches_ilift}


def launches_of(conv=0, conv_dx=0, v2=0, v2_dx=0, lift=0, ilift=0):
    return {"conv3x3_halo": conv, "conv3x3_halo_dx": conv_dx,
            "conv_v2": v2, "conv_v2_dx": v2_dx,
            "lift97": lift, "ilift97": ilift}


def coding_conv_launches(cfg):
    """3x3 conv launches of one image's analysis, and as many of its
    synthesis, in the real bitstream: four convs of each scaling AE (the
    down stacks, or the up stacks), one AE a level and one for LL, on every
    plane; the context convs run in host C++."""
    planes = 3 if cfg.clrch == 1 else 1
    return 4 * (cfg.dwtlevels + 1) * planes


def ladder_launches(cfg, train: bool):
    """(analysis, synthesis) kernel launches of one CDF97 step: three
    passes a level each way; a train step's backward adds the adjoint of the
    inverse (the analysis kernel). The image needs no gradient, so the
    adjoint of the forward never runs on the path."""
    per = 3 * cfg.dwtlevels
    return (2 * per if train else per), per


def ladder_shapes(levels, b, h, w):
    """Distinct (NCHW input shape of an analysis pass, dim) of a CDF97 step
    on B x 3 x H x W images, each with its passes per step (each way)."""
    out = {}
    for lvl in range(levels):
        hh, ww = h >> lvl, w >> lvl
        for key, n in ((((b, 3, hh, ww), 2), 1), (((b, 3, hh // 2, ww), 3), 2)):
            out[key] = out.get(key, 0) + n
    return out


def conv_shapes(cfg, size=None):
    """Distinct (h, w, cin, cout) of the path's dense 3x3 convs on H x W
    images, each with its forward launches per step. In a train step the
    input of every one of them needs a gradient (each lies behind the
    lifting stage's parameters), so each also launches one dx."""
    height, width = size or (H, W)
    planes = 3 if cfg.clrch == 1 else 1
    counts = {}

    def add(h, w, pairs, n):
        for cin, cout in pairs:
            key = (h, w, cin, cout)
            counts[key] = counts.get(key, 0) + n * planes

    def berk(ic):   # down and up stacks of SubbandAutoEncoderBerk
        return [(ic, ic * 32), (ic * 32, ic * 64), (ic * 64, ic * 32),
                (ic * 32, ic)]

    L = cfg.dwtlevels
    so = 3 * cfg.clrch
    for lvl in range(1, L + 1):
        add(height >> lvl, width >> lvl, berk(so), 2)
    add(height >> L, width >> L, berk(cfg.clrch), 2)
    for lvl in range(1, L):                       # plc of finer level lvl-1
        add(height >> lvl, width >> lvl, [(so, so * 81), (so * 81, so * 81)], 1)
    return counts


@contextlib.contextmanager
def tf32_off(torch, deterministic=False):
    """fp32 convs and matmuls in full fp32 (cuDNN's default is TF32);
    ``deterministic`` also keeps cuDNN off its algorithms that sum with
    atomics."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = old


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def time_ms(fn, torch, min_ms=100.0, max_reps=50):
    """Mean ms of ``fn`` on the card by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(1, min(max_reps, int(min_ms / max(start.elapsed_time(end),
                                                  1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(torch, F, conv, cfg):
    """Kernel 1 (launched directly) vs plain at every eval-path shape;
    returns per-shape rows."""
    rows = []
    gen = torch.Generator(device=DEV).manual_seed(0)
    for (h, w, cin, cout), per_step in sorted(conv_shapes(cfg).items()):
        x = torch.randn(B, cin, h, w, device=DEV, generator=gen
                        ).contiguous(memory_format=torch.channels_last)
        wt = torch.randn(cout, cin, 3, 3, device=DEV, generator=gen
                         ) / (3 * cin ** 0.5)
        for name, dt in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
            with torch.no_grad():
                # the kernel alone, on operands already cast and laid out
                xl = x.to(dt).contiguous(memory_format=torch.channels_last)
                w9 = conv.tap_major(wt, dt)
                wl = wt.to(dt).contiguous(memory_format=torch.channels_last)
                got = conv.launch_kernel(xl, w9)
                want = conv.conv3x3_halo_plain(x, wt, dt)
                torch.cuda.synchronize()
                abs_err = (got - want).abs().max().item()
                rel_err = abs_err / want.abs().max().item()
                if not rel_err <= KERNEL_TOL:
                    raise AssertionError(
                        f"conv3x3_halo {name} {(B, cin, h, w)}->{cout}: "
                        f"error {rel_err:.3e} > {KERNEL_TOL}")
                del got, want
                ms = time_ms(lambda: conv.launch_kernel(xl, w9), torch)
                plain_ms = time_ms(
                    lambda: conv.conv3x3_halo_plain(x, wt, dt), torch)
                lib_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1), torch)
                del xl, w9, wl
            dsize = 2 if name == "bfloat16" else 4
            flops = 2.0 * 9 * cin * cout * B * h * w
            nbytes = (B * h * w * cin + 9 * cin * cout) * dsize \
                + B * h * w * cout * 4
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            row = {"phase": "kernel", "dtype": name, "x": [B, cin, h, w],
                   "cout": cout, "launches_per_step": per_step,
                   "max_abs_err": abs_err, "max_rel_err": rel_err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
                   "bytes_ms": t_bytes,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "gflop": flops / 1e9, "tflops": flops / ms / 1e9}
            emit(row)
            rows.append(row)
        del x, wt
    torch.cuda.empty_cache()
    return rows


def phase_kernel_bwd(torch, conv, cfg):
    """Kernel 1's forward and dx (launched directly) and the dk product
    against the plain versions at every training shape; returns per-shape
    rows."""
    rows = []
    gen = torch.Generator(device=DEV).manual_seed(1)
    b = TRAIN_B
    shapes = conv_shapes(cfg, (TRAIN_P, TRAIN_P))
    for (h, w, cin, cout), per_step in sorted(shapes.items()):
        x = torch.randn(b, cin, h, w, device=DEV, generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device=DEV, generator=gen
                         ) / (3 * cin ** 0.5)
        dy = torch.randn(b, cout, h, w, device=DEV, generator=gen)
        for name, dt in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
            with torch.no_grad():
                cl = torch.channels_last
                xl = x.to(dt).contiguous(memory_format=cl)
                dyl = dy.to(dt).contiguous(memory_format=cl)
                w9 = conv.tap_major(wt, dt)
                w9_dx = conv.tap_major(conv.flip_swap(wt), dt)
                wl = wt.to(dt).contiguous(memory_format=cl)
                conv.launches = 0
                y = conv.launch_kernel(xl, w9)
                dx = conv.launch_kernel(dyl, w9_dx)
                dk = conv.dk_product(xl, dyl)
                torch.cuda.synchronize()
                expect_launches(conv.launches, 2, "one forward and one dx")
                want_y = conv.conv3x3_halo_plain(x, wt, dt)
                want_dx, want_dk = conv.conv3x3_halo_bwd_plain(x, wt, dy, dt)
                fwd_abs = (y - want_y).abs().max().item()
                fwd_rel = rel_err(y, want_y)
                dx_abs = (dx - want_dx).abs().max().item()
                dx_rel = rel_err(dx, want_dx)
                dk_rel = rel_err(dk, want_dk)
                if not fwd_rel <= KERNEL_TOL or not dx_rel <= KERNEL_TOL \
                        or not dk_rel <= DK_TOL[name]:
                    raise AssertionError(
                        f"conv3x3_halo {name} {(b, cin, h, w)}->{cout}: "
                        f"forward error {fwd_rel:.3e}, dx error {dx_rel:.3e} "
                        f"(limit {KERNEL_TOL}), dk error {dk_rel:.3e} "
                        f"(limit {DK_TOL[name]})")
                del y, dx, dk, want_y, want_dx, want_dk
                t = lambda fn: time_ms(fn, torch, min_ms=50.0)  # noqa: E731
                dx_ms = t(lambda: conv.launch_kernel(dyl, w9_dx))
                dk_ms = t(lambda: conv.dk_product(xl, dyl))
                fwd_ms = t(lambda: conv.launch_kernel(xl, w9))
                plain_ms = t(lambda: conv.conv3x3_halo_plain(
                    dy, conv.flip_swap(wt), dt))
                lib_dx_ms = t(lambda: torch.nn.grad.conv2d_input(
                    xl.shape, wl, dyl, padding=1))
                lib_dk_ms = t(lambda: torch.nn.grad.conv2d_weight(
                    xl, wl.shape, dyl, padding=1))
                del xl, dyl, w9, w9_dx, wl
            dsize = 2 if name == "bfloat16" else 4
            n = b * h * w
            flops = 2.0 * 9 * cin * cout * n
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            dx_bytes = (n * cout + 9 * cin * cout) * dsize + n * cin * 4
            dk_bytes = (n * cin + n * cout) * dsize + 9 * cin * cout * 4
            t_dx_bytes = dx_bytes / PEAK_BYTES * 1e3
            t_dk_bytes = dk_bytes / PEAK_BYTES * 1e3
            row = {"phase": "kernel_bwd", "dtype": name, "x": [b, cin, h, w],
                   "cout": cout, "launches_per_step": per_step,
                   "fwd_max_abs_err": fwd_abs, "fwd_max_rel_err": fwd_rel,
                   "dx_max_abs_err": dx_abs, "dx_max_rel_err": dx_rel,
                   "dk_max_rel_err": dk_rel,
                   "dx_ms": dx_ms, "dx_plain_ms": plain_ms,
                   "dx_library_ms": lib_dx_ms, "dk_ms": dk_ms,
                   "dk_library_ms": lib_dk_ms, "fwd_ms": fwd_ms,
                   "dx_bound_ms": max(t_ops, t_dx_bytes),
                   "dk_bound_ms": max(t_ops, t_dk_bytes),
                   "ops_ms": t_ops, "dx_bytes_ms": t_dx_bytes,
                   "gflop": flops / 1e9, "dx_tflops": flops / dx_ms / 1e9,
                   "dk_tflops": flops / dk_ms / 1e9}
            emit(row)
            rows.append(row)
        del x, wt, dy
    torch.cuda.empty_cache()
    return rows


def conv_bound(n, cin, cout):
    """(bound ms, ops ms, bytes ms) of one SAME 3x3 conv over ``n`` pixels
    with bf16 operands and an fp32 output: input and weight read once,
    output written once."""
    t_ops = 2.0 * 9 * cin * cout * n / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = ((n * cin + 9 * cin * cout) * 2 + n * cout * 4) \
        / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def kernel_resources(build_log):
    """{(N tile, segments): {"registers", "spill_bytes"}} of each conv_v2
    kernel instantiation, read off ptxas's ``-v`` lines (empty where this
    process found the library already built)."""
    import re
    res, key = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"conv_v2_kernelILi(\d+)ELi(\d+)E", m.group(1))
            key = (int(k.group(1)), int(k.group(2))) if k else None
            if key:
                res[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            res[key]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[key]["registers"] = int(m.group(1))
    return res


def plan_fields(v2, resources, b, h, w, cin, cout, prefix=""):
    """A launch's plan (N tile, stages, dynamic shared memory) and its
    kernel's registers and spills, as row fields."""
    plan = v2.launch_plan(b, h, w, cin, cout)
    got = resources.get((plan.n_tile, plan.segments), {})
    return plan, {f"{prefix}n_tile": plan.n_tile,
                  f"{prefix}stages": plan.stages,
                  f"{prefix}smem_bytes": plan.smem_bytes,
                  f"{prefix}registers": got.get("registers"),
                  f"{prefix}spill_bytes": got.get("spill_bytes")}


def phase_conv_v2_kernel(torch, F, conv, v2, cfg, k1_rows, k1_bwd_rows):
    """Kernel 4 (conv_v2) against ``conv_v2_plain``: forward at every
    eval-path shape (B=8 512x768), the bf16 conv Function's forward, dx and
    dk at every training shape (B=8 256x256), forward at
    ``bench_pallas_v2.py``'s shapes; returns per-shape rows. Kernel 1's
    bf16 times at the same shapes come from ``k1_rows``/``k1_bwd_rows``
    (the same call). Each row also has the wrapper's operand copies timed
    alone (``pad_ms``: ``padded_operands``, part of ``ms``), the launch
    plan and the kernel's registers and spills from the build log."""
    rows = []
    resources = kernel_resources(v2.LIBRARY.build_log)
    cl = torch.channels_last
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(4)
    k1 = {(tuple(r["x"]), r["cout"]): r for r in k1_rows
          if r["dtype"] == "bfloat16"}
    k1_bwd = {(tuple(r["x"]), r["cout"]): r for r in k1_bwd_rows
              if r["dtype"] == "bfloat16"}

    def forward_row(path, b, cin, h, w, cout, per_step):
        x = torch.randn(b, cin, h, w, device=DEV, generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device=DEV, generator=gen
                         ) / (3 * cin ** 0.5)
        with torch.no_grad():
            xl = x.to(bf16).contiguous(memory_format=cl)
            w9 = conv.tap_major(wt, bf16)
            wl = wt.to(bf16).contiguous(memory_format=cl)
            got = v2.launch_kernel(xl, w9)
            want = v2.conv_v2_plain(x, wt)
            torch.cuda.synchronize()
            abs_err = (got - want).abs().max().item()
            rel = abs_err / want.abs().max().item()
            del got, want
            if not rel <= KERNEL_TOL:
                raise AssertionError(f"conv_v2 {(b, cin, h, w)}->{cout}: "
                                     f"error {rel:.3e} > {KERNEL_TOL}")
            ms = time_ms(lambda: v2.launch_kernel(xl, w9), torch)
            plan, fields = plan_fields(v2, resources, b, h, w, cin, cout)
            pad_ms = time_ms(lambda: v2.padded_operands(xl, w9, plan), torch)
            plain_ms = time_ms(lambda: v2.conv_v2_plain(x, wt), torch)
            lib_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1), torch)
            key = ((b, cin, h, w), cout)
            k1_ms = k1[key]["ms"] if key in k1 else time_ms(
                lambda: conv.launch_kernel(xl, w9), torch)
        bound, t_ops, t_bytes = conv_bound(b * h * w, cin, cout)
        flops = 2.0 * 9 * cin * cout * b * h * w
        row = {"phase": "conv_v2_kernel", "path": path, "x": [b, cin, h, w],
               "cout": cout, "launches_per_step": per_step,
               "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
               "tflops": flops / ms / 1e9, "pad_ms": pad_ms, **fields,
               "plain_ms": plain_ms,
               "library_ms": lib_ms, "conv3x3_halo_bf16_ms": k1_ms,
               "bound_ms": bound, "ops_ms": t_ops, "bytes_ms": t_bytes,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flops / 1e9}
        emit(row)
        rows.append(row)

    for (h, w, cin, cout), n in sorted(conv_shapes(cfg).items()):
        forward_row("eval", B, cin, h, w, cout, n)
    for (b, h, w, cin), cout in BENCH_PALLAS_V2_SHAPES:
        forward_row("bench_pallas_v2", b, cin, h, w, cout, 0)

    b = TRAIN_B
    for (h, w, cin, cout), n in sorted(
            conv_shapes(cfg, (TRAIN_P, TRAIN_P)).items()):
        x = torch.randn(b, cin, h, w, device=DEV, generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device=DEV, generator=gen
                         ) / (3 * cin ** 0.5)
        dy = torch.randn(b, cout, h, w, device=DEV, generator=gen)
        xg = x.clone().requires_grad_(True)
        wg = wt.clone().requires_grad_(True)
        conv.launches = v2.launches = v2.launches_dx = 0
        y = conv.conv3x3_halo(xg, wg, bf16)
        y.backward(dy)
        torch.cuda.synchronize()
        expect_launches((v2.launches, v2.launches_dx, conv.launches),
                        (2, 1, 0), "one bf16 forward and backward "
                        "(conv_v2, its dx, conv3x3_halo)")
        with torch.no_grad():
            want_y = v2.conv_v2_plain(x, wt)
            want_dx, want_dk = conv.conv3x3_halo_bwd_plain(x, wt, dy, bf16)
            fwd_abs = (y - want_y).abs().max().item()
            fwd_rel = rel_err(y, want_y)
            dx_abs = (xg.grad - want_dx).abs().max().item()
            dx_rel = rel_err(xg.grad, want_dx)
            dk_rel = rel_err(wg.grad, want_dk)
            if not fwd_rel <= KERNEL_TOL or not dx_rel <= KERNEL_TOL \
                    or not dk_rel <= DK_TOL["bfloat16"]:
                raise AssertionError(
                    f"conv_v2 train {(b, cin, h, w)}->{cout}: forward error "
                    f"{fwd_rel:.3e}, dx error {dx_rel:.3e}, dk error "
                    f"{dk_rel:.3e}")
            del y, xg, wg, want_y, want_dx, want_dk
            dyl = dy.to(bf16).contiguous(memory_format=cl)
            xl = x.to(bf16).contiguous(memory_format=cl)
            w9 = conv.tap_major(wt, bf16)
            w9_dx = conv.tap_major(conv.flip_swap(wt), bf16)
            wl = wt.to(bf16).contiguous(memory_format=cl)
            t = lambda fn: time_ms(fn, torch, min_ms=50.0)  # noqa: E731
            dx_ms = t(lambda: v2.launch_kernel(dyl, w9_dx))
            fwd_ms = t(lambda: v2.launch_kernel(xl, w9))
            plan, fields = plan_fields(v2, resources, b, h, w, cin, cout)
            dx_plan, dx_fields = plan_fields(v2, resources, b, h, w, cout,
                                             cin, "dx_")
            pad_ms = t(lambda: v2.padded_operands(xl, w9, plan))
            dx_pad_ms = t(lambda: v2.padded_operands(dyl, w9_dx, dx_plan))
            plain_ms = t(lambda: v2.conv_v2_plain(dy, conv.flip_swap(wt)))
            lib_dx_ms = t(lambda: torch.nn.grad.conv2d_input(
                xl.shape, wl, dyl, padding=1))
            del xl, dyl, w9, w9_dx, wl
        n_px = b * h * w
        dx_bound, t_ops, dx_bytes = conv_bound(n_px, cout, cin)
        fwd_bound = conv_bound(n_px, cin, cout)[0]
        k1r = k1_bwd[((b, cin, h, w), cout)]
        row = {"phase": "conv_v2_kernel", "path": "train", "x": [b, cin, h, w],
               "cout": cout, "launches_per_step": n,
               "fwd_max_abs_err": fwd_abs, "fwd_max_rel_err": fwd_rel,
               "dx_max_abs_err": dx_abs, "dx_max_rel_err": dx_rel,
               "dk_max_rel_err": dk_rel, "fwd_ms": fwd_ms, "dx_ms": dx_ms,
               "pad_ms": pad_ms, "dx_pad_ms": dx_pad_ms, **fields,
               **dx_fields,
               "dx_plain_ms": plain_ms, "dx_library_ms": lib_dx_ms,
               "conv3x3_halo_bf16_fwd_ms": k1r["fwd_ms"],
               "conv3x3_halo_bf16_dx_ms": k1r["dx_ms"],
               "fwd_bound_ms": fwd_bound, "dx_bound_ms": dx_bound,
               "ops_ms": t_ops, "dx_bytes_ms": dx_bytes,
               "gflop": 2.0 * 9 * cin * cout * n_px / 1e9,
               "dx_tflops": 2.0 * 9 * cin * cout * n_px / dx_ms / 1e9}
        emit(row)
        rows.append(row)
        del x, wt, dy
    torch.cuda.empty_cache()
    return rows


def load_model(cfg, pkg):
    model = pkg.codec.CodecWrapper(cfg)
    pkg.weights.load_flax_params(model, pkg.weights.load_npz(SNAPSHOT))
    return model


def phase_parity(torch, pkg, conv):
    """fp32 flagship on one 256x256 image: card vs CPU."""
    cfg = pkg.config.flagship_config()
    img = pkg.data.synthetic_natural_images(1, 256, seed=0)[0]
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0
    cpu_model = load_model(cfg, pkg)
    gpu_model = copy.deepcopy(cpu_model)
    want, want_xhat = pkg.state.make_eval_step(cfg, cpu_model, "cpu")(x)
    step = pkg.state.make_eval_step(cfg, gpu_model, DEV)
    conv.launches = 0
    got, got_xhat = step(x)
    torch.cuda.synchronize()
    launches = conv.launches
    d = (got_xhat.cpu() - want_xhat).abs()
    out = {"phase": "parity", "image": [1, 3, 256, 256], "dtype": "float32",
           "launches": launches, "xhat_max_abs_err": d.max().item(),
           "xhat_mean_abs_err": d.mean().item()}
    for k in ("loss", "mse", "rate1", "rate2"):
        a, b = float(getattr(got, k)), float(getattr(want, k))
        out[k] = {"card": a, "cpu": b, "rel_err": abs(a - b) / abs(b)}
    emit(out)
    bad = [k for k in ("loss", "mse", "rate1", "rate2")
           if not out[k]["rel_err"] <= PARITY_RTOL]
    if bad or not out["xhat_mean_abs_err"] <= XHAT_MEAN_TOL \
            or not out["xhat_max_abs_err"] <= XHAT_MAX_TOL:
        raise AssertionError(f"card and CPU disagree: {bad or 'xhat'}")
    expect_launches(launches, sum(conv_shapes(cfg).values()), "parity run")
    return launches


def train_batch(torch, np, pkg, n, size, seed):
    imgs = pkg.data.synthetic_natural_images(n, size, seed=seed)
    return torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).float() / 255.0


def phase_train_parity(torch, np, pkg, conv):
    """One fp32 train step, card vs CPU: the same weights, batch and noise
    (a CPU generator with one seed feeds both)."""
    cfg = pkg.config.flagship_config(lambda_=2000.0, learning_rate=TRAIN_LR)
    batch = train_batch(torch, np, pkg, PARITY_B, PARITY_P, seed=2)
    results = {}
    for dev in ("cpu", DEV):
        model = load_model(cfg, pkg)
        step = pkg.state.make_train_step(
            cfg, model, pkg.state.make_optimizer(cfg, model), dev)
        conv.launches = conv.launches_dx = 0
        out, _ = step(batch, torch.Generator().manual_seed(3), TRAIN_LR, 1.0)
        if dev != "cpu":
            torch.cuda.synchronize()
        results[dev] = (out, {n: p.grad.detach().cpu()
                              for n, p in model.named_parameters()},
                        conv.launches, conv.launches_dx)
        del model, step
    (want, want_g, cpu_launches, _), (got, got_g, launches, dx) = (
        results["cpu"], results[DEV])
    res = {"phase": "train_parity", "batch": [PARITY_B, 3, PARITY_P, PARITY_P],
           "dtype": "float32", "launches": launches, "dx_launches": dx}
    for k in ("loss", "mse", "rate1", "rate2"):
        a, b = float(getattr(got, k)), float(getattr(want, k))
        res[k] = {"card": a, "cpu": b, "rel_err": abs(a - b) / abs(b)}
    errs = {n: rel_err(got_g[n], want_g[n]) for n in want_g}
    worst = max(errs, key=errs.get)
    l2 = (sum(float((got_g[n] - want_g[n]).double().pow(2).sum())
              for n in want_g)
          / sum(float(want_g[n].double().pow(2).sum()) for n in want_g)) ** 0.5
    res.update(grad_tensors=len(errs), grad_worst=worst,
               grad_worst_rel_err=errs[worst],
               grad_tensors_over_1e_3=sum(e > 1e-3 for e in errs.values()),
               grad_l2_rel_err=l2)
    emit(res)
    bad = [k for k in ("loss", "mse", "rate1", "rate2")
           if not res[k]["rel_err"] <= PARITY_RTOL]
    if bad or not errs[worst] <= GRAD_TOL or not l2 <= GRAD_L2_TOL:
        raise AssertionError(f"card and CPU train steps disagree: "
                             f"{bad or worst}")
    n_conv = sum(conv_shapes(cfg).values())
    expect_launches((cpu_launches, launches, dx), (0, 2 * n_conv, n_conv),
                    "train parity (cpu, card, card dx)")
    return launches, dx


def phase_main(torch, np, pkg, counts):
    """bf16 flagship at B=8 512x768 with the lambda=2000 weights: every
    dense 3x3 conv through conv_v2, none through conv3x3_halo."""
    cfg = pkg.config.flagship_config(dtype="bfloat16")
    imgs = pkg.data.synthetic_natural_images(B, W, seed=0)
    batch = torch.from_numpy(np.stack(imgs)[:, :H]).permute(0, 3, 1, 2)
    batch = batch.float().div(255.0).to(DEV)
    model = load_model(cfg, pkg)
    step = pkg.state.make_eval_step(cfg, model, DEV)
    expected = sum(conv_shapes(cfg).values())

    t0 = time.perf_counter()
    step(batch)                       # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    counts.reset()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        out, xhat = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts.read()
    expect_launches(launches, launches_of(v2=STEPS * expected),
                    f"{STEPS} bf16 eval steps")
    xs = batch - 0.5
    bpp = float(out.rate1 + out.rate2)
    psnr = float(pkg.loss.psnr(xs, xhat))
    if not all(map(lambda v: v == v and abs(v) != float("inf"),
                   (bpp, psnr, float(out.loss)))):
        raise AssertionError(f"non-finite result: bpp {bpp} psnr {psnr}")
    if tuple(xhat.shape) != (B, 3, H, W):
        raise AssertionError(f"xhat shape {tuple(xhat.shape)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same batch through the fp32 codec: bf16 must stay close
    cfg32 = pkg.config.flagship_config()
    with tf32_off(torch):
        out32, xhat32 = pkg.state.make_eval_step(
            cfg32, load_model(cfg32, pkg), DEV)(batch)
    bpp32 = float(out32.rate1 + out32.rate2)
    psnr32 = float(pkg.loss.psnr(xs, xhat32))
    del out32, xhat32

    ms = [t * 1e3 for t in times]
    res = {"phase": "main", "config": "flagship_lam2000", "dtype": "bfloat16",
           "batch": [B, 3, H, W], "steps": STEPS, "bpp": bpp, "psnr_db": psnr,
           "loss": float(out.loss), "mse": float(out.mse),
           "rate1": float(out.rate1), "rate2": float(out.rate2),
           "ms_per_step": sum(ms) / len(ms), "ms_per_step_min": min(ms),
           "ms_per_step_all": ms,
           "mp_per_s": B * H * W / 1e6 / (sum(times) / len(times)),
           "warmup_s": warm_s, "peak_mem_gb": peak_gb,
           "launches": launches,
           "conv_v2_launches_per_step": launches["conv_v2"] / STEPS,
           "fp32_bpp": bpp32, "fp32_psnr_db": psnr32}
    emit(res)
    if not abs(bpp - bpp32) <= BF16_BPP_RTOL * bpp32 \
            or not abs(psnr - psnr32) <= BF16_PSNR_TOL:
        raise AssertionError("bf16 and fp32 steps disagree")
    return res, step, batch


def phase_profile(torch, run_step, step_ms, name="profile"):
    """One step under torch.profiler: device busy ms (the sum of the
    device-side events' times; host-side ops also carry the device time of
    the kernels they launch, so they are left out) and the fifteen largest
    device-side events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(ms for _, ms, _ in events)
    top = sorted(events, key=lambda e: -e[1])[:15]
    emit({"phase": name, "device_busy_ms": busy, "step_ms": step_ms,
          "idle_share": max(0.0, 1.0 - busy / step_ms),
          "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in top]})


def phase_train(torch, np, pkg, counts):
    """bf16 flagship train steps at B=8 256x256 from the lambda=2000
    weights (forward and dx of every dense 3x3 conv through conv_v2);
    returns the result and a closure that takes one more step."""
    cfg = pkg.config.flagship_config(dtype="bfloat16", lambda_=2000.0,
                                     learning_rate=TRAIN_LR)
    batch = train_batch(torch, np, pkg, TRAIN_B, TRAIN_P, seed=1).to(DEV)
    model = load_model(cfg, pkg)
    step = pkg.state.make_train_step(
        cfg, model, pkg.state.make_optimizer(cfg, model), DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    n_conv = sum(conv_shapes(cfg, (TRAIN_P, TRAIN_P)).values())

    def run_step():
        return step(batch, gen, TRAIN_LR, 1.0)[0]

    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        run_step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    counts.reset()
    times, outs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        outs.append(run_step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts.read()
    expect_launches(launches, launches_of(v2=TRAIN_STEPS * 2 * n_conv,
                                          v2_dx=TRAIN_STEPS * n_conv),
                    f"{TRAIN_STEPS} bf16 train steps")
    losses = [float(o.loss) for o in outs]
    last = [float(v) for v in outs[-1]]
    if not all(np.isfinite(losses)) or not all(np.isfinite(last)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("non-finite parameter after training")
    ms = [t * 1e3 for t in times]
    mean_s = sum(times) / len(times)
    res = {"phase": "train", "config": "flagship_lam2000", "dtype": "bfloat16",
           "batch": [TRAIN_B, 3, TRAIN_P, TRAIN_P], "lr": TRAIN_LR,
           "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "ms_per_step": mean_s * 1e3, "ms_per_step_min": min(ms),
           "ms_per_step_all": ms, "steps_per_s": 1.0 / mean_s,
           "patches_per_s": TRAIN_B / mean_s,
           "mp_per_s": TRAIN_B * TRAIN_P * TRAIN_P / 1e6 / mean_s,
           "loss": losses, "mse": last[1], "rate1": last[2], "rate2": last[3],
           "warmup_s": warm_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "conv_v2_launches_per_step": launches["conv_v2"] / TRAIN_STEPS,
           "reckoned_launches_per_step": 2 * n_conv}
    emit(res)
    return res, run_step


@contextlib.contextmanager
def working_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def phase_agent(torch, pkg, counts, config_path, overrides, reckon,
                reckon_test, name="agent"):
    """The CLI on a copy of a config cut by ``overrides``: two epochs, then
    a resumed run. ``reckon(cfg, n_valid)`` gives the kernels' launches in
    the first run. What the resumed run restored is read from the
    checkpoint files: between the runs the saved learning rate is halved,
    so that a restored value can be told from the config's. Then
    ``{name}_test``: the CLI's agent in ``mode: test`` on the saved
    checkpoint, a real bitstream of each test image; ``reckon_test(cfg)``
    gives the kernels' launches of one image."""
    with open(config_path) as fh:
        raw = json.load(fh)
    raw.update(overrides, exp_name=f"smoke_{name}")
    steps, epochs = raw["steps_per_epoch"], raw["max_epoch"]
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        with open("agent.json", "w") as fh:
            json.dump(raw, fh)
        cfg = pkg.config.get_config_from_json("agent.json")
        ckpt_dir = os.path.join("experiments", cfg.exp_name, "checkpoints")
        n_valid = len(list(pkg.data.ImageDataLoader(cfg).valid_batches()))

        counts.reset()
        t0 = time.perf_counter()
        if pkg.cli.main(["agent.json"]) != 0:
            raise AssertionError("the CLI returned non-zero")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = counts.read()
        expect_launches(launches, reckon(cfg, n_valid), f"the {name} run")
        files = sorted(os.listdir(ckpt_dir))
        if files != ["checkpoint.pt", "model_best.pt"]:
            raise AssertionError(f"checkpoint files: {files}")
        one = pkg.checkpoint.load_checkpoint(ckpt_dir, map_location="cpu")
        half_lr = one["scheduler"]["lr"] / 2
        one["scheduler"]["lr"] = half_lr
        pkg.checkpoint.save_checkpoint(ckpt_dir, one)

        t0 = time.perf_counter()
        if pkg.cli.main(["--resume-training", "agent.json"]) != 0:
            raise AssertionError("the resumed CLI returned non-zero")
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        two = pkg.checkpoint.load_checkpoint(ckpt_dir, map_location="cpu")
        with open(os.path.join("experiments", cfg.exp_name, "summaries",
                               "metrics.jsonl")) as fh:
            rows = [json.loads(ln) for ln in fh]
        test_res = agent_test(torch, pkg, counts, raw, reckon_test,
                              f"{name}_test")

    def adam_steps(payload):
        return sorted({float(st["step"])
                       for st in payload["optimizer"]["state"].values()})

    res = {"phase": name, "config": os.path.basename(config_path),
           "batch": [cfg.batch_size, 3, cfg.patch_size, cfg.patch_size],
           "dtype": cfg.dtype,
           "first_run": {"epoch": one["epoch"], "iteration": one["iteration"],
                         "adam_steps": adam_steps(one), "seconds": first_s,
                         "launches": launches},
           "resumed_run": {"epoch": two["epoch"],
                           "iteration": two["iteration"],
                           "adam_steps": adam_steps(two),
                           "scheduler_lr": two["scheduler"]["lr"],
                           "optimizer_lr": two["optimizer"]["param_groups"][0]
                           ["lr"], "seconds": resumed_s},
           "valid_images": n_valid,
           "metrics": [{k: r[k] for k in ("typ", "step", "rd", "psnr")}
                       for r in rows]}
    emit(res)
    done = epochs * steps
    want = {"first": (epochs - 1, done, [float(done)]),
            "resumed": (epochs - 1, done + steps, [float(done + steps)])}
    got = {"first": (one["epoch"], one["iteration"], adam_steps(one)),
           "resumed": (two["epoch"], two["iteration"], adam_steps(two))}
    if got != want:
        raise AssertionError(f"{name} counters {got}, expected {want}")
    if two["scheduler"]["lr"] != half_lr \
            or two["optimizer"]["param_groups"][0]["lr"] != half_lr:
        raise AssertionError("the resumed run did not restore the lr")
    if [r["typ"] for r in rows] != ["tr", "va"] * (epochs + 1) \
            or not all(r["rd"] == r["rd"] and abs(r["rd"]) != float("inf")
                       for r in rows):
        raise AssertionError(f"agent metrics: {rows}")
    return res, test_res


def agent_test(torch, pkg, counts, raw, reckon_test, name):
    """The CLI's agent in ``mode: test`` (run in the working directory of
    the training run, whose checkpoint it restores)."""
    with open("agent_test.json", "w") as fh:
        json.dump(dict(raw, mode="test"), fh)
    cfg = pkg.config.process_config("agent_test.json")
    n_test = len(list(pkg.data.ImageDataLoader(cfg).test_batches()))
    counts.reset()
    t0 = time.perf_counter()
    agent = pkg.cli.run_agent(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts.read()
    per = agent.last_test_per_image
    res = {"phase": name, "config": cfg.exp_name, "dtype": cfg.dtype,
           "test_images": n_test, "seconds": seconds,
           "seconds_per_image": seconds / n_test, "launches": launches,
           "mean_bpp": sum(r["bpp"] for r in per) / len(per),
           "mean_psnr_db": sum(r["psnr"] for r in per) / len(per),
           "restored_iteration": agent.current_iteration}
    emit(res)
    want = {k: v * n_test for k, v in reckon_test(cfg).items()}
    expect_launches(launches, want, f"the {name} run")
    if len(per) != n_test or agent.current_iteration == 0 or not all(
            math.isfinite(r["bpp"]) and math.isfinite(r["psnr"])
            for r in per):
        raise AssertionError(f"{name}: {per}")
    return res

def timing_split(coder, h, w, wall_s):
    """One image's round trip as encode and decode seconds, each split into
    the transforms on the card (CUDA events) and the host's coding (the
    planes' host times summed; they run on threads after the first image)."""
    t = coder.last_timing
    return {"wall_s": wall_s,
            "encode_s": (t["analysis_ms"] + t["encode_host_ms"]) / 1e3,
            "decode_s": (t["decode_host_ms"] + t["synthesis_ms"]) / 1e3,
            "analysis_card_ms": t["analysis_ms"],
            "synthesis_card_ms": t["synthesis_ms"],
            "encode_host_ms": t["encode_host_ms"],
            "decode_host_ms": t["decode_host_ms"],
            "host_wall_ms": t["host_wall_ms"],
            "coded_mp_per_s": h * w / 1e6 / wall_s}


def code_images(torch, pkg, counts, coder, images, want, name):
    """Each image (uint8 HWC) through ``compress_decompress`` alone, its
    launches counted; ``want`` is the launches of one image. A plane that
    does not decode to the encoder's writeback raises in the coder."""
    rows = []
    for k, img in enumerate(images):
        batch = img[None].astype("float32") / 255.0
        counts.reset()
        t0 = time.perf_counter()
        res = coder.compress_decompress(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.read()
        expect_launches(launches, want, f"{name} image {k}")
        if res.xhat.shape != batch.shape or not (
                math.isfinite(res.bpp) and math.isfinite(res.psnr)):
            raise AssertionError(f"{name} image {k}: bpp {res.bpp}, psnr "
                                 f"{res.psnr}, xhat {res.xhat.shape}")
        rows.append({"image": k, "bpp": res.bpp, "psnr": res.psnr,
                     "bytes": sum(st.nbytes() for st in res.streams),
                     **timing_split(coder, *img.shape[:2], wall)})
    return rows


def mean(rows, key, skip=0):
    vals = [r[key] for r in rows[skip:]]
    return sum(vals) / len(vals)


def profile_transforms(torch, np, pkg, coder, image, name):
    """One image's transforms on the card as the coder runs them (the three
    planes' analysis, then their synthesis from the rounded subbands): the
    host clock around them, then the same work under torch.profiler, its
    device busy time and largest device ops."""
    x = torch.from_numpy(image).permute(2, 0, 1)[None].float().div(255.0)

    def run():
        ycbcr = pkg.color.shift_ycbcr(pkg.color.rgb_to_ycbcr(x.to(DEV)))
        subbands = [coder.analysis(p, ycbcr[:, p:p + 1]) for p in range(3)]
        for p, (xe, xo) in enumerate(subbands):
            coder.synthesis(p, np.round(xe), [np.round(t) for t in xo])

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    phase_profile(torch, run, (time.perf_counter() - t0) * 1e3, name)


def phase_bitstream(torch, np, pkg, counts):
    """The flagship's real bitstream in fp32 with the lambda=2000 weights
    over the 19 dead-leaves images of the held-out set, against the JAX
    package's on the same snapshot and images."""
    cfg = pkg.config.flagship_config(lambda_=2000.0)
    coder = pkg.codec_coder.CodecCoder(cfg, load_model(cfg, pkg), DEV)
    n, size, seed = BITSTREAM_IMAGES
    images = pkg.data.synthetic_natural_images(n, size, seed=seed)
    rows = code_images(torch, pkg, counts, coder, images,
                       launches_of(conv=2 * coding_conv_launches(cfg)),
                       "bitstream")
    profile_transforms(torch, np, pkg, coder, images[0], "bitstream_profile")
    with open(TARGETS) as fh:
        targets = json.load(fh)["per_image"]
    with open(RD_FLAGSHIP) as fh:
        rd = json.load(fh)
    names = sorted(rd["eval_set"])
    rd_rows = [r for name, r in zip(names, rd["points"]["2000"]["per_image"])
               if name.startswith(f"natural_{seed}_")]
    bad = []
    for r, t in zip(rows, targets):
        r["target_bpp"], r["target_psnr"] = t["bpp"], t["psnr"]
        if not abs(r["bpp"] - t["bpp"]) <= TARGET_BPP_RTOL * t["bpp"] \
                or not abs(r["psnr"] - t["psnr"]) <= TARGET_PSNR_TOL:
            bad.append(r["image"])
        emit({"phase": "bitstream_image", **r})
    res = {"phase": "bitstream", "config": "flagship_lam2000",
           "dtype": "float32", "images": [n, 3, size, size],
           "cpu_count": os.cpu_count(),
           "mean_bpp": mean(rows, "bpp"), "mean_psnr_db": mean(rows, "psnr"),
           "target_mean_bpp": mean(targets, "bpp"),
           "target_mean_psnr_db": mean(targets, "psnr"),
           "max_bpp_rel_gap": max(abs(r["bpp"] - r["target_bpp"])
                                  / r["target_bpp"] for r in rows),
           "max_psnr_gap_db": max(abs(r["psnr"] - r["target_psnr"])
                                  for r in rows),
           "rd_flagship_rows_1_19_mean_bpp": mean(rd_rows, "bpp"),
           "rd_flagship_rows_1_19_mean_psnr_db": mean(rd_rows, "psnr"),
           "launches_per_image": 2 * coding_conv_launches(cfg),
           # the first image builds the coding tables and runs its planes
           # one after another; the means leave it out
           "first_image_s": rows[0]["wall_s"],
           **{f"mean_{k}": mean(rows, k, skip=1) for k in (
               "wall_s", "encode_s", "decode_s", "analysis_card_ms",
               "synthesis_card_ms", "encode_host_ms", "decode_host_ms",
               "coded_mp_per_s")}}
    res["gap_to_rd_flagship_bpp"] = res["mean_bpp"] \
        - res["rd_flagship_rows_1_19_mean_bpp"]
    res["gap_to_rd_flagship_psnr_db"] = res["mean_psnr_db"] \
        - res["rd_flagship_rows_1_19_mean_psnr_db"]
    emit(res)
    if bad:
        raise AssertionError(f"bitstream: images {bad} off the JAX targets "
                             f"(bpp {TARGET_BPP_RTOL}, psnr {TARGET_PSNR_TOL} "
                             "dB)")
    return res, rows


def phase_bitstream_bf16(torch, np, pkg, counts, fp32_rows):
    """The same 19 images with bf16 operands (conv_v2 in the analysis and
    synthesis), held to the fp32 pass; then two Kodak-size images timed."""
    cfg = pkg.config.flagship_config(lambda_=2000.0, dtype="bfloat16")
    coder = pkg.codec_coder.CodecCoder(cfg, load_model(cfg, pkg), DEV)
    n, size, seed = BITSTREAM_IMAGES
    want = launches_of(v2=2 * coding_conv_launches(cfg))
    images = pkg.data.synthetic_natural_images(n, size, seed=seed)
    rows = code_images(torch, pkg, counts, coder, images, want,
                       "bitstream_bf16")
    bad = [r["image"] for r, f in zip(rows, fp32_rows)
           if not abs(r["bpp"] - f["bpp"]) <= BITSTREAM_BF16_BPP_RTOL * f["bpp"]
           or not abs(r["psnr"] - f["psnr"]) <= BITSTREAM_BF16_PSNR_TOL]
    # the first image's analysis and synthesis apart: half the launches each
    x = torch.from_numpy(images[0]).permute(2, 0, 1)[None].float().div(255.0)
    ycbcr = pkg.color.shift_ycbcr(pkg.color.rgb_to_ycbcr(x.to(DEV)))
    half = launches_of(v2=coding_conv_launches(cfg))
    counts.reset()
    subbands = [coder.analysis(p, ycbcr[:, p:p + 1]) for p in range(3)]
    torch.cuda.synchronize()
    expect_launches(counts.read(), half, "bitstream_bf16 analysis")
    counts.reset()
    for p, (xe, xo) in enumerate(subbands):
        coder.synthesis(p, np.round(xe), [np.round(t) for t in xo])
    torch.cuda.synchronize()
    expect_launches(counts.read(), half, "bitstream_bf16 synthesis")
    profile_transforms(torch, np, pkg, coder, images[0],
                       "bitstream_bf16_profile")
    kodak = np.stack(pkg.data.synthetic_natural_images(KODAK_IMAGES, W,
                                                       seed=0))[:, :H]
    big = code_images(torch, pkg, counts, coder, kodak, want,
                      "bitstream_bf16 512x768")
    res = {"phase": "bitstream_bf16", "config": "flagship_lam2000",
           "dtype": "bfloat16", "images": [n, 3, size, size],
           "cpu_count": os.cpu_count(),
           "mean_bpp": mean(rows, "bpp"), "mean_psnr_db": mean(rows, "psnr"),
           "fp32_mean_bpp": mean(fp32_rows, "bpp"),
           "fp32_mean_psnr_db": mean(fp32_rows, "psnr"),
           "max_bpp_rel_gap_to_fp32": max(
               abs(r["bpp"] - f["bpp"]) / f["bpp"]
               for r, f in zip(rows, fp32_rows)),
           "max_psnr_gap_to_fp32_db": max(
               abs(r["psnr"] - f["psnr"]) for r, f in zip(rows, fp32_rows)),
           "launches_per_image": want, "launches_analysis": half,
           "launches_synthesis": half,
           **{f"mean_{k}": mean(rows, k, skip=1) for k in (
               "wall_s", "encode_s", "decode_s", "analysis_card_ms",
               "synthesis_card_ms", "encode_host_ms", "decode_host_ms",
               "coded_mp_per_s")},
           "kodak": {"images": [KODAK_IMAGES, 3, H, W], "per_image": big}}
    emit(res)
    if bad:
        raise AssertionError(f"bitstream_bf16: images {bad} off the fp32 "
                             "pass")
    return res


# --- the CDF 9/7 + factorized codec ------------------------------------------

def ladder_filters(torch, lift):
    """The filters that the 9/7 ladder implies, read off its plain version
    in float64 with unit impulses: the analysis taps of (low_i, high_i) over
    x[2i-4 .. 2i+4] as a (2, 9) weight, and the synthesis taps of pair i's
    low and high sample over x[2i+r0 ..] as a (2, K) weight, with r0."""
    n, i = 64, 16
    eye = torch.eye(n, dtype=torch.float64)
    lo, hi = lift.analysis_plain(eye, 1)             # [k, i]: impulse at k
    wa = torch.stack([lo[2 * i - 4:2 * i + 5, i], hi[2 * i - 4:2 * i + 5, i]])
    if int((lo[:, i].abs() > 1e-12).sum() + (hi[:, i].abs() > 1e-12).sum()) \
            != int((wa.abs() > 1e-12).sum()):
        raise AssertionError("the 9/7 analysis reaches beyond 9 taps")
    eye_m = torch.eye(n // 2, dtype=torch.float64)
    zero = torch.zeros_like(eye_m)
    sl = lift.synthesis_plain(eye_m, zero, 1)        # [i, k]: pair i's low
    sh = lift.synthesis_plain(zero, eye_m, 1)
    nz = ((sl[i].abs() > 1e-12) | (sh[i].abs() > 1e-12)).nonzero().flatten()
    r0, r1 = int(nz.min()) - 2 * i, int(nz.max()) - 2 * i
    ws = torch.stack([sl[i, 2 * i + r0:2 * i + r1 + 1],
                      sh[i, 2 * i + r0:2 * i + r1 + 1]])
    return wa.float(), ws.float(), r0


def library_analysis(F, x, dim, wa):
    """The analysis as one strided conv on a circularly padded input:
    low and high come back as the two channels."""
    if dim == 3:
        xx = x.reshape(-1, 1, x.shape[3])
        return F.conv1d(F.pad(xx, (4, 4), mode="circular"),
                        wa.view(2, 1, 9), stride=2)
    xx = x.reshape(-1, 1, x.shape[2], x.shape[3])
    return F.conv2d(F.pad(xx, (0, 0, 4, 4), mode="circular"),
                    wa.view(2, 1, 9, 1), stride=(2, 1))


def library_synthesis(torch, F, lo, hi, dim, ws, r0, pad=4):
    """The synthesis as one strided transposed conv of the stacked, in
    pairs circularly padded bands; ``x_k`` is output ``k + 2 pad - r0``."""
    k, m = ws.shape[1], lo.shape[dim]
    at = 2 * pad - r0
    if dim == 3:
        st = torch.stack([lo.reshape(-1, m), hi.reshape(-1, m)], 1)
        out = F.conv_transpose1d(F.pad(st, (pad, pad), mode="circular"),
                                 ws.view(2, 1, k), stride=2)
        return out[:, 0, at:at + 2 * m]
    w = lo.shape[3]
    st = torch.stack([lo.reshape(-1, m, w), hi.reshape(-1, m, w)], 1)
    out = F.conv_transpose2d(F.pad(st, (0, 0, pad, pad), mode="circular"),
                             ws.view(2, 1, k, 1), stride=(2, 1))
    return out[:, 0, at:at + 2 * m]


def fdot(a, b) -> float:
    return float((a.double() * b.double()).sum())


def fnorm(ts) -> float:
    return math.sqrt(sum(fdot(t, t) for t in ts))


def phase_lift97_kernel(torch, F, lift, cfg):
    """The ladder kernels in their four uses against the plain versions at
    every distinct shape of the CDF97 eval and train paths and of
    ``bench_pallas.py``, along the dim each pass lifts (both dims for the
    bench shapes); the adjoint identities; times. Returns one row per shape
    and use."""
    eval_keys = ladder_shapes(cfg.dwtlevels, B, H, W)
    train_keys = ladder_shapes(cfg.dwtlevels, CDF97_TRAIN_B, TRAIN_P, TRAIN_P)
    keys = list(dict.fromkeys(
        list(eval_keys) + list(train_keys)
        + [(s, d) for s in BENCH_PALLAS_SHAPES for d in (2, 3)]))
    wa, ws, r0 = ladder_filters(torch, lift)
    wa, ws = wa.to(DEV), ws.to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(2)
    t = lambda fn: time_ms(fn, torch, min_ms=20.0)  # noqa: E731
    rows = []
    for shape, dim in keys:
        x = torch.randn(shape, device=DEV, generator=gen)
        half = list(shape)
        half[dim] //= 2
        lo = torch.randn(half, device=DEV, generator=gen)
        hi = torch.randn(half, device=DEV, generator=gen)
        n = x.numel()
        # each fp32 sample read once and written once; 4 steps of 3 flops on
        # half the samples, and a gain on each
        t_bytes = 2 * n * 4 / PEAK_BYTES * 1e3
        t_ops = 7 * n / PEAK_FLOPS["float32"] * 1e3
        with torch.no_grad():
            fx = lift.launch_analysis(x, dim, lift.FORWARD)
            fty = lift.launch_synthesis(lo, hi, dim, lift.FORWARD_T)
            ix = lift.launch_synthesis(lo, hi, dim, lift.INVERSE)
            itx = lift.launch_analysis(x, dim, lift.INVERSE_T)
            torch.cuda.synchronize()
            adjoint = {
                "F": abs(fdot(fx[0], lo) + fdot(fx[1], hi) - fdot(x, fty))
                / (fnorm(fx) * fnorm((lo, hi))),
                "I": abs(fdot(ix, x) - fdot(lo, itx[0]) - fdot(hi, itx[1]))
                / (fnorm((ix,)) * fnorm((x,)))}
            got = {"F": fx, "F_T": (fty,), "I": (ix,), "I_T": itx}
            want = {"F": lift.analysis_plain(x, dim, lift.FORWARD),
                    "F_T": (lift.synthesis_plain(lo, hi, dim, lift.FORWARD_T),),
                    "I": (lift.synthesis_plain(lo, hi, dim, lift.INVERSE),),
                    "I_T": lift.analysis_plain(x, dim, lift.INVERSE_T)}
            lib_a = library_analysis(F, x, dim, wa)
            lib_s = library_synthesis(torch, F, lo, hi, dim, ws, r0)
            lib_err = max(rel_err(lib_a[:, 0].reshape(half), want["F"][0]),
                          rel_err(lib_a[:, 1].reshape(half), want["F"][1]),
                          rel_err(lib_s.reshape(shape), want["I"][0]))
            lib_ms = {"analysis": t(lambda: library_analysis(F, x, dim, wa)),
                      "synthesis": t(lambda: library_synthesis(
                          torch, F, lo, hi, dim, ws, r0))}
            del lib_a, lib_s
            for use, ladder in (("F", lift.FORWARD), ("I_T", lift.INVERSE_T),
                                ("I", lift.INVERSE),
                                ("F_T", lift.FORWARD_T)):
                analysis = use in ("F", "I_T")
                abs_err = max((g - w).abs().max().item()
                              for g, w in zip(got[use], want[use]))
                rel = max(rel_err(g, w) for g, w in zip(got[use], want[use]))
                if analysis:
                    ms = t(lambda: lift.launch_analysis(x, dim, ladder))
                    plain_ms = t(lambda: lift.analysis_plain(x, dim, ladder))
                else:
                    ms = t(lambda: lift.launch_synthesis(lo, hi, dim, ladder))
                    plain_ms = t(lambda: lift.synthesis_plain(lo, hi, dim,
                                                              ladder))
                row = {"phase": "lift97_kernel", "use": use,
                       "kernel": "lift97" if analysis else "ilift97",
                       "x": list(shape), "dim": dim,
                       "launches_eval_step": eval_keys.get((shape, dim), 0)
                       if use in ("F", "I") else 0,
                       "launches_train_step": train_keys.get((shape, dim), 0)
                       if use != "F_T" else 0,
                       "max_abs_err": abs_err, "max_rel_err": rel,
                       "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms["analysis" if analysis
                                            else "synthesis"],
                       "library_rel_err": lib_err,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations",
                       "gb_per_s": 2 * n * 4 / ms / 1e6,
                       "adjoint_err": adjoint.get(use)}
                emit(row)
                rows.append(row)
                if not rel <= LADDER_TOL:
                    raise AssertionError(
                        f"lift97 {use} {shape} dim {dim}: error {rel:.3e} > "
                        f"{LADDER_TOL}")
            if not max(adjoint.values()) <= ADJOINT_TOL:
                raise AssertionError(f"lift97 {shape} dim {dim}: adjoint "
                                     f"identity off by {adjoint}")
            if not lib_err <= LIBRARY_TOL:
                raise AssertionError(f"the conv yardstick is off by {lib_err}")
            del got, want, fx, fty, ix, itx
        del x, lo, hi
    torch.cuda.empty_cache()
    return rows


def cdf97_config(pkg):
    return pkg.config.get_config_from_json(CDF97_CONFIG)


def cdf97_model(torch, pkg, cfg):
    return pkg.codec.CodecWrapper(
        cfg, generator=torch.Generator().manual_seed(CDF97_SEED))


@contextlib.contextmanager
def zero_noise(bottleneck):
    """The bottlenecks' training noise pinned to zero (both devices then
    quantize alike)."""
    old = bottleneck.quantize_noise
    bottleneck.quantize_noise = lambda x, generator=None: x
    try:
        yield
    finally:
        bottleneck.quantize_noise = old


def phase_cdf97_parity(torch, np, pkg, counts):
    """The fp32 CDF97 codec on one 256x256 image, card vs CPU, the same
    seeded init on both; then one train step card vs CPU, noise pinned."""
    cfg = cdf97_config(pkg)
    img = pkg.data.synthetic_natural_images(1, 256, seed=0)[0]
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0
    cpu_model = cdf97_model(torch, pkg, cfg)
    gpu_model = copy.deepcopy(cpu_model)
    want, want_xhat = pkg.state.make_eval_step(cfg, cpu_model, "cpu")(x)
    step = pkg.state.make_eval_step(cfg, gpu_model, DEV)
    counts.reset()
    got, got_xhat = step(x)
    torch.cuda.synchronize()
    eval_launches = counts.read()
    d = (got_xhat.cpu() - want_xhat).abs()
    lift_n, ilift_n = ladder_launches(cfg, False)
    res = {"phase": "cdf97_parity", "image": [1, 3, 256, 256],
           "dtype": "float32", "launches": eval_launches,
           "xhat_max_abs_err": d.max().item(),
           "xhat_mean_abs_err": d.mean().item()}
    for k in ("loss", "mse", "rate1", "rate2"):
        a, b = float(getattr(got, k)), float(getattr(want, k))
        res[k] = {"card": a, "cpu": b, "rel_err": abs(a - b) / abs(b)}
    bad = [k for k in ("loss", "mse", "rate1", "rate2")
           if not res[k]["rel_err"] <= PARITY_RTOL]
    if not res["xhat_mean_abs_err"] <= XHAT_MEAN_TOL:
        bad.append("xhat")
    del cpu_model, gpu_model, step

    batch = train_batch(torch, np, pkg, PARITY_B, 256, seed=2)
    results = {}
    with zero_noise(pkg.bottleneck):
        for dev in ("cpu", DEV):
            model = cdf97_model(torch, pkg, cfg)
            tstep = pkg.state.make_train_step(
                cfg, model, pkg.state.make_optimizer(cfg, model), dev)
            counts.reset()
            out, aux = tstep(batch, torch.Generator().manual_seed(3),
                             TRAIN_LR, 1.0)
            if dev != "cpu":
                torch.cuda.synchronize()
            results[dev] = (out, float(aux), counts.read(),
                            {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()})
            del model, tstep
    (t_want, aux_want, cpu_counts, want_g), (t_got, aux_got, train_counts,
                                             got_g) = results["cpu"], \
        results[DEV]
    tr = {"batch": [PARITY_B, 3, 256, 256], "launches": train_counts,
          "aux": {"card": aux_got, "cpu": aux_want}}
    for k in ("loss", "mse", "rate1", "rate2"):
        a, b = float(getattr(t_got, k)), float(getattr(t_want, k))
        tr[k] = {"card": a, "cpu": b, "rel_err": abs(a - b) / abs(b)}
        if not tr[k]["rel_err"] <= PARITY_RTOL:
            bad.append(f"train {k}")
    errs = {n: rel_err(got_g[n], want_g[n]) for n in want_g}
    worst = max(errs, key=errs.get)
    l2 = (sum(float((got_g[n] - want_g[n]).double().pow(2).sum())
              for n in want_g)
          / sum(float(want_g[n].double().pow(2).sum()) for n in want_g)) ** 0.5
    tr.update(grad_tensors=len(errs), grad_worst=worst,
              grad_worst_rel_err=errs[worst],
              grad_tensors_over_1e_4=sum(e > 1e-4 for e in errs.values()),
              grad_l2_rel_err=l2)
    res["train"] = tr
    emit(res)
    if not errs[worst] <= CDF97_GRAD_TOL or not l2 <= CDF97_GRAD_L2_TOL:
        bad.append(f"gradient {worst}")
    if bad:
        raise AssertionError(f"CDF97 card and CPU disagree: {bad}")
    lift_t, ilift_t = ladder_launches(cfg, True)
    expect_launches((eval_launches, cpu_counts, train_counts),
                    (launches_of(lift=lift_n, ilift=ilift_n), launches_of(),
                     launches_of(lift=lift_t, ilift=ilift_t)),
                    "CDF97 parity (eval card, train cpu, train card)")


def phase_cdf97_main(torch, np, pkg, counts):
    """The fp32 CDF97 eval step at B=8 512x768, seeded random weights."""
    cfg = cdf97_config(pkg)
    imgs = pkg.data.synthetic_natural_images(B, W, seed=0)
    batch = torch.from_numpy(np.stack(imgs)[:, :H]).permute(0, 3, 1, 2)
    batch = batch.float().div(255.0).to(DEV)
    step = pkg.state.make_eval_step(cfg, cdf97_model(torch, pkg, cfg), DEV)
    lift_n, ilift_n = ladder_launches(cfg, False)

    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        out, xhat = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts.read()
    expect_launches(launches, launches_of(lift=STEPS * lift_n,
                                          ilift=STEPS * ilift_n),
                    f"{STEPS} CDF97 eval steps")
    bpp = float(out.rate1 + out.rate2)
    psnr = float(pkg.loss.psnr(batch - 0.5, xhat))
    if not all(math.isfinite(v) for v in (bpp, psnr, float(out.loss))):
        raise AssertionError(f"non-finite result: bpp {bpp} psnr {psnr}")
    if tuple(xhat.shape) != (B, 3, H, W):
        raise AssertionError(f"xhat shape {tuple(xhat.shape)}")
    ms = [t * 1e3 for t in times]
    mean_s = sum(times) / len(times)
    res = {"phase": "cdf97_main", "config": "cdf97_factorized",
           "dtype": "float32", "batch": [B, 3, H, W], "steps": STEPS,
           "bpp": bpp, "psnr_db": psnr, "loss": float(out.loss),
           "mse": float(out.mse), "rate1": float(out.rate1),
           "rate2": float(out.rate2), "ms_per_step": mean_s * 1e3,
           "ms_per_step_min": min(ms), "ms_per_step_all": ms,
           "mp_per_s": B * H * W / 1e6 / mean_s, "warmup_s": warm_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "ladder_launches_per_step": (launches["lift97"]
                                        + launches["ilift97"]) / STEPS}
    emit(res)
    return res, step, batch


def phase_cdf97_train(torch, np, pkg, counts):
    """The fp32 CDF97 train step at the config's batch, 4 x 256x256, Adam
    at lr 1e-4, seeded random weights; returns the result and a closure
    that takes one more step."""
    cfg = cdf97_config(pkg)
    batch = train_batch(torch, np, pkg, CDF97_TRAIN_B, TRAIN_P, seed=1).to(DEV)
    model = cdf97_model(torch, pkg, cfg)
    step = pkg.state.make_train_step(
        cfg, model, pkg.state.make_optimizer(cfg, model), DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    lift_n, ilift_n = ladder_launches(cfg, True)

    def run_step():
        return step(batch, gen, TRAIN_LR, 1.0)

    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        run_step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    times, outs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        outs.append(run_step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts.read()
    expect_launches(launches, launches_of(lift=TRAIN_STEPS * lift_n,
                                          ilift=TRAIN_STEPS * ilift_n),
                    f"{TRAIN_STEPS} CDF97 train steps")
    losses = [float(o.loss) for o, _ in outs]
    aux = [float(a) for _, a in outs]
    last = [float(v) for v in outs[-1][0]]
    if not all(math.isfinite(v) for v in losses + aux + last):
        raise AssertionError(f"non-finite training loss: {losses} {aux}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError("non-finite parameter after training")
    ms = [t * 1e3 for t in times]
    mean_s = sum(times) / len(times)
    res = {"phase": "cdf97_train", "config": "cdf97_factorized",
           "dtype": "float32", "batch": [CDF97_TRAIN_B, 3, TRAIN_P, TRAIN_P],
           "lr": TRAIN_LR, "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "ms_per_step": mean_s * 1e3, "ms_per_step_min": min(ms),
           "ms_per_step_all": ms, "steps_per_s": 1.0 / mean_s,
           "patches_per_s": CDF97_TRAIN_B / mean_s,
           "mp_per_s": CDF97_TRAIN_B * TRAIN_P * TRAIN_P / 1e6 / mean_s,
           "loss": losses, "aux": aux, "mse": last[1], "rate1": last[2],
           "rate2": last[3], "warmup_s": warm_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "ladder_launches_per_step": (launches["lift97"]
                                        + launches["ilift97"]) / TRAIN_STEPS}
    emit(res)
    return res, run_step


def phase_cdf97_bitstream(torch, np, pkg, counts):
    """The CDF97 codec's real bitstream (seeded random weights) on four
    256x256 images: lossless, the real rate near the eval step's
    likelihood rate, 24 ladder launches an image."""
    cfg = cdf97_config(pkg)
    model = cdf97_model(torch, pkg, cfg)
    step = pkg.state.make_eval_step(cfg, model, DEV)
    coder = pkg.codec_coder.CodecCoder(cfg, model, DEV)
    lift_n, ilift_n = ladder_launches(cfg, False)
    images = pkg.data.synthetic_natural_images(CDF97_BITSTREAM_IMAGES, 256,
                                               seed=5)
    likelihood = []
    for img in images:
        out, _ = step(torch.from_numpy(img).permute(2, 0, 1)[None].float()
                      / 255.0)
        likelihood.append(float(out.rate1 + out.rate2))
    rows = code_images(torch, pkg, counts, coder, images,
                       launches_of(lift=lift_n, ilift=ilift_n),
                       "cdf97_bitstream")
    for r, lik in zip(rows, likelihood):
        r["likelihood_bpp"] = lik
    res = {"phase": "cdf97_bitstream", "config": "cdf97_factorized",
           "dtype": "float32", "images": [len(images), 3, 256, 256],
           "per_image": [{k: r[k] for k in ("bpp", "likelihood_bpp", "psnr",
                                            "wall_s", "encode_s", "decode_s",
                                            "analysis_card_ms",
                                            "synthesis_card_ms")}
                         for r in rows],
           "max_bpp_rel_gap": max(abs(r["bpp"] - r["likelihood_bpp"])
                                  / r["likelihood_bpp"] for r in rows)}
    emit(res)
    if not res["max_bpp_rel_gap"] <= CDF97_REAL_BPP_RTOL:
        raise AssertionError("cdf97_bitstream: real rate off the likelihood")
    return res


def reckon_coding(cfg):
    """The kernels' launches of one image's real bitstream: the scaling
    AEs' 3x3 convs for the flagship (fp32 here: conv3x3_halo), the ladder
    for CDF97."""
    if cfg.netType == "CDF97":
        lift_n, ilift_n = ladder_launches(cfg, False)
        return launches_of(lift=lift_n, ilift=ilift_n)
    n = 2 * coding_conv_launches(cfg)
    return launches_of(v2=n) if cfg.dtype == "bfloat16" \
        else launches_of(conv=n)


def reckon_flagship_agent(cfg, n_valid):
    n_conv = sum(conv_shapes(cfg).values())
    steps, epochs = AGENT["steps_per_epoch"], AGENT["max_epoch"]
    return launches_of(conv=epochs * (steps * 2 * n_conv + n_valid * n_conv),
                       conv_dx=epochs * steps * n_conv)


def reckon_cdf97_agent(cfg, n_valid):
    steps, epochs = CDF97_AGENT["steps_per_epoch"], CDF97_AGENT["max_epoch"]
    (tl, ts), (el, es) = ladder_launches(cfg, True), ladder_launches(cfg, False)
    return launches_of(lift=epochs * (steps * tl + n_valid * el),
                       ilift=epochs * (steps * ts + n_valid * es))


def ladder_entry(name, lift, rows, main_res, train_res):
    """The ``kernels`` line's entry of one ladder kernel: its launches on
    the CDF97 eval and train paths, and per eval step (its shapes times its
    launches there) its time, the plain version's, the bound and the conv
    yardstick's."""
    mine = [r for r in rows if r["kernel"] == name]

    def per(key, path="eval"):
        return sum(r[key] * r[f"launches_{path}_step"] for r in mine)

    ev, tr = main_res["launches"][name], train_res["launches"][name]
    return {"name": name, "route": "cuda",
            "source": os.path.relpath(lift.SOURCE, HERE),
            "replaces": "scripts/bench_pallas.py:"
                        + ("85" if name == "lift97" else "106"),
            "launches": ev + tr, "launches_eval_path": ev,
            "launches_train_path": tr,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per("ms"), "plain_ms": per("plain_ms"),
            "bound_ms": per("bound_ms"), "bound_by": "bytes",
            "library_ms": per("library_ms"),
            "train_step_ms": per("ms", "train"),
            "train_step_plain_ms": per("plain_ms", "train"),
            "train_step_bound_ms": per("bound_ms", "train"),
            "train_step_library_ms": per("library_ms", "train")}



def kernel_entries(conv, v2, lift97, rows, bwd_rows, v2_rows, lift_rows,
                   res):
    """The ``kernels`` line: every hand-written kernel with its launches on
    the paths (each counted with the counts set to 0 just before the run)
    and its time, the plain version's, the bound and the library call's
    over one step of its path, from this run's per-shape rows."""
    def per(rows_, key):
        return sum(r[key] * r["launches_per_step"] for r in rows_)

    def by(rows_, **kw):
        return [r for r in rows_ if all(r.get(k) == v for k, v in kw.items())]

    def bound_by(rows_, ops="ops_ms", nbytes="bytes_ms"):
        return "operations" if per(rows_, ops) >= per(rows_, nbytes) \
            else "bytes"

    k1_32, k1_16 = by(rows, dtype="float32"), by(rows, dtype="bfloat16")
    b1_32 = by(bwd_rows, dtype="float32")
    v2_eval, v2_train = by(v2_rows, path="eval"), by(v2_rows, path="train")
    fp32 = {"parity": res["parity"], "train_parity": res["train_parity"][0],
            "bitstream": res["bitstream_launches"],
            "agent": res["agent"]["first_run"]["launches"]["conv3x3_halo"],
            "agent_test": res["agent_test"]["launches"]["conv3x3_halo"]}
    bf16 = {"main": res["main"]["launches"]["conv_v2"],
            "train": res["train"]["launches"]["conv_v2"],
            "bitstream_bf16": res["bitstream_bf16_launches"]}
    tpu = "imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu/"
    ladders = [ladder_entry(k, lift97, lift_rows, res["cdf97_main"],
                            res["cdf97_train"]) for k in ("lift97", "ilift97")]
    return [{
        # kernel 1 carries the fp32 convs: its numbers per fp32 eval step
        "name": "conv3x3_halo", "route": "cuda",
        "source": os.path.relpath(conv.SOURCE, HERE),
        "replaces": tpu + "ops/pallas_conv.py:102",
        "launches": sum(fp32.values()), "launches_by_path": fp32,
        "max_abs_err": max([r["max_abs_err"] for r in rows]
                           + [r["fwd_max_abs_err"] for r in bwd_rows]),
        "dtype": "float32", "ms": per(k1_32, "ms"),
        "plain_ms": per(k1_32, "plain_ms"), "bound_ms": per(k1_32, "bound_ms"),
        "bound_by": bound_by(k1_32), "library_ms": per(k1_32, "library_ms"),
        "bf16_ms": per(k1_16, "ms"), "bf16_bound_ms": per(k1_16, "bound_ms"),
        "bf16_library_ms": per(k1_16, "library_ms")}, {
        "name": "conv3x3_halo_dx", "route": "cuda",
        "source": os.path.relpath(conv.SOURCE, HERE),
        "replaces": tpu + "ops/pallas_conv.py:137",
        "launches": res["train_parity"][1]
        + res["agent"]["first_run"]["launches"]["conv3x3_halo_dx"],
        "max_abs_err": max(r["dx_max_abs_err"] for r in bwd_rows),
        "dtype": "float32", "ms": per(b1_32, "dx_ms"),
        "plain_ms": per(b1_32, "dx_plain_ms"),
        "bound_ms": per(b1_32, "dx_bound_ms"),
        "bound_by": bound_by(b1_32, nbytes="dx_bytes_ms"),
        "library_ms": per(b1_32, "dx_library_ms")}, *ladders, {
        "name": "conv_v2", "route": "cuda",
        "source": os.path.relpath(v2.SOURCE, HERE),
        "replaces": "scripts/bench_pallas_v2.py:34",
        "launches": sum(bf16.values()), "launches_by_path": bf16,
        "launches_dx": res["train"]["launches"]["conv_v2_dx"],
        "max_abs_err": max([r["max_abs_err"] for r in v2_rows if "ms" in r]
                           + [r["fwd_max_abs_err"] for r in v2_train]
                           + [r["dx_max_abs_err"] for r in v2_train]),
        "dtype": "bfloat16", "ms": per(v2_eval, "ms"),
        "pad_ms": per(v2_eval, "pad_ms"),
        "plain_ms": per(v2_eval, "plain_ms"),
        "bound_ms": per(v2_eval, "bound_ms"), "bound_by": bound_by(v2_eval),
        "library_ms": per(v2_eval, "library_ms"),
        "conv3x3_halo_bf16_ms": per(v2_eval, "conv3x3_halo_bf16_ms"),
        "train_step_fwd_ms": per(v2_train, "fwd_ms"),
        "train_step_dx_ms": per(v2_train, "dx_ms"),
        "train_step_dx_plain_ms": per(v2_train, "dx_plain_ms"),
        "train_step_dx_bound_ms": per(v2_train, "dx_bound_ms"),
        "train_step_dx_library_ms": per(v2_train, "dx_library_ms")}]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()

    import numpy
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch.nn.functional as F
    from types import SimpleNamespace
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
        cli, config)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
        codec_coder, native_build, native_ctx, rans)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
        bottleneck)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
        codec)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        color, conv3x3_halo as conv, conv_v2 as v2, lift97)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
        weights)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
        checkpoint, data, loss, state)
    pkg = SimpleNamespace(cli=cli, config=config, codec=codec, weights=weights,
                          checkpoint=checkpoint, data=data, loss=loss,
                          state=state, bottleneck=bottleneck,
                          codec_coder=codec_coder, color=color)
    counts = Counts(conv, v2, lift97)
    t_start = time.perf_counter()

    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch_name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    kernels = (conv, v2, lift97)
    hosts = (rans.get_lib, native_ctx.ctx_fingerprint)
    with concurrent.futures.ThreadPoolExecutor(5) as pool:  # one compiler each
        for job in [pool.submit(m.build) for m in kernels] \
                + [pool.submit(f) for f in hosts]:
            job.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [{
              "source": os.path.relpath(m.SOURCE, HERE),
              "ptxas": [ln.strip() for ln in m.LIBRARY.build_log.splitlines()
                        if any(k in ln for k in ("registers", "spill",
                                                 "wgmma", "setmaxnreg"))]}
              for m in kernels] + [{
              "source": os.path.relpath(lib.source, HERE),
              "g++_flags": lib.flags_used}
              for lib in (native_build.RANS, native_build.WAVEFRONT_CTX)],
          "ctx_fp": native_ctx.ctx_fingerprint()})

    res = {}
    cfg = config.flagship_config(dtype="bfloat16")
    with tf32_off(torch):
        rows = phase_kernel(torch, F, conv, cfg)
        bwd_rows = phase_kernel_bwd(torch, conv, cfg)
        v2_rows = phase_conv_v2_kernel(torch, F, conv, v2, cfg, rows,
                                       bwd_rows)
        res["parity"] = phase_parity(torch, pkg, conv)
    with tf32_off(torch, deterministic=True):
        res["train_parity"] = phase_train_parity(torch, numpy, pkg, conv)
    main_res, step, batch = phase_main(torch, numpy, pkg, counts)
    res["main"] = main_res
    phase_profile(torch, lambda: step(batch), main_res["ms_per_step"])
    del step, batch
    torch.cuda.empty_cache()
    train_res, train_step = phase_train(torch, numpy, pkg, counts)
    res["train"] = train_res
    phase_profile(torch, train_step, train_res["ms_per_step"],
                  "train_profile")
    del train_step
    torch.cuda.empty_cache()
    with tf32_off(torch):
        res["agent"], res["agent_test"] = phase_agent(
            torch, pkg, counts, CONFIG, AGENT, reckon_flagship_agent,
            reckon_coding)
        bits, bits_rows = phase_bitstream(torch, numpy, pkg, counts)
    res["bitstream_launches"] = bits["launches_per_image"] * len(bits_rows)
    bits16 = phase_bitstream_bf16(torch, numpy, pkg, counts, bits_rows)
    res["bitstream_bf16_launches"] = bits16["launches_per_image"]["conv_v2"] \
        * (BITSTREAM_IMAGES[0] + KODAK_IMAGES)
    torch.cuda.empty_cache()

    cdf97_cfg = cdf97_config(pkg)
    with tf32_off(torch):
        lift_rows = phase_lift97_kernel(torch, F, lift97, cdf97_cfg)
    with tf32_off(torch, deterministic=True):
        phase_cdf97_parity(torch, numpy, pkg, counts)
    cdf_main, step, batch = phase_cdf97_main(torch, numpy, pkg, counts)
    res["cdf97_main"] = cdf_main
    phase_profile(torch, lambda: step(batch), cdf_main["ms_per_step"],
                  "cdf97_profile")
    del step, batch
    torch.cuda.empty_cache()
    cdf_train, train_step = phase_cdf97_train(torch, numpy, pkg, counts)
    res["cdf97_train"] = cdf_train
    phase_profile(torch, train_step, cdf_train["ms_per_step"],
                  "cdf97_train_profile")
    del train_step
    torch.cuda.empty_cache()
    with tf32_off(torch):
        phase_cdf97_bitstream(torch, numpy, pkg, counts)
    phase_agent(torch, pkg, counts, CDF97_CONFIG, CDF97_AGENT,
                reckon_cdf97_agent, reckon_coding, "cdf97_agent")

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    bwd16 = [r for r in bwd_rows if r["dtype"] == "bfloat16"]
    v2_eval = [r for r in v2_rows if r["path"] == "eval"]
    v2_train = [r for r in v2_rows if r["path"] == "train"]

    def per_step(key, rows=bf16):
        return sum(r[key] * r["launches_per_step"] for r in rows)

    emit({"phase": "kernel_per_step", "kernel": "conv3x3_halo",
          "dtype": "bfloat16",
          "launches": sum(r["launches_per_step"] for r in bf16),
          "tflop": sum(r["gflop"] * r["launches_per_step"] for r in bf16)
          / 1e3,
          "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
          "library_ms": per_step("library_ms"),
          "bound_ms": per_step("bound_ms")})
    emit({"phase": "kernel_per_train_step", "kernel": "conv3x3_halo",
          "dtype": "bfloat16",
          "launches": 2 * sum(r["launches_per_step"] for r in bwd16),
          "tflop_each_of_fwd_dx_dk": per_step("gflop", bwd16) / 1e3,
          "fwd_ms": per_step("fwd_ms", bwd16),
          "dx_ms": per_step("dx_ms", bwd16),
          "dx_plain_ms": per_step("dx_plain_ms", bwd16),
          "dx_library_ms": per_step("dx_library_ms", bwd16),
          "dx_bound_ms": per_step("dx_bound_ms", bwd16),
          "dk_ms": per_step("dk_ms", bwd16),
          "dk_library_ms": per_step("dk_library_ms", bwd16),
          "dk_bound_ms": per_step("dk_bound_ms", bwd16)})
    emit({"phase": "conv_v2_per_step", "dtype": "bfloat16",
          "launches": sum(r["launches_per_step"] for r in v2_eval),
          "tflop": sum(r["gflop"] * r["launches_per_step"] for r in v2_eval)
          / 1e3,
          "ms": per_step("ms", v2_eval), "pad_ms": per_step("pad_ms", v2_eval),
          "plain_ms": per_step("plain_ms", v2_eval),
          "library_ms": per_step("library_ms", v2_eval),
          "bound_ms": per_step("bound_ms", v2_eval),
          "conv3x3_halo_bf16_ms": per_step("conv3x3_halo_bf16_ms", v2_eval),
          "share_of_step": per_step("ms", v2_eval) / main_res["ms_per_step"],
          "train_step_fwd_ms": per_step("fwd_ms", v2_train),
          "train_step_dx_ms": per_step("dx_ms", v2_train),
          "train_step_pad_ms": per_step("pad_ms", v2_train)
          + per_step("dx_pad_ms", v2_train),
          "train_step_dx_library_ms": per_step("dx_library_ms", v2_train),
          "train_step_dx_bound_ms": per_step("dx_bound_ms", v2_train),
          "train_step_share": (per_step("fwd_ms", v2_train)
                               + per_step("dx_ms", v2_train))
          / train_res["ms_per_step"]})
    entries = kernel_entries(conv, v2, lift97, rows, bwd_rows, v2_rows,
                             lift_rows, res)
    ladders = [e for e in entries if e["name"] in ("lift97", "ilift97")]
    emit({"phase": "ladder_per_step", "dtype": "float32",
          "eval_step_ms": cdf_main["ms_per_step"],
          "train_step_ms": cdf_train["ms_per_step"],
          **{f"{e['name']}_{k}": e[k] for e in ladders
             for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "train_step_ms")},
          "share_of_eval_step": sum(e["ms"] for e in ladders)
          / cdf_main["ms_per_step"],
          "share_of_train_step": sum(e["train_step_ms"] for e in ladders)
          / cdf_train["ms_per_step"]})
    emit({"kernels": entries})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
