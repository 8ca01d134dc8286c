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
           shape (B=8, 512x768), fp32 operands, with its time, the plain
           version's, cuDNN's fp32 ``F.conv2d`` (the yardstick, never used
           by the port) and the card's bound for the same work;
4. kernel_bwd  the same kernel's dx (on the flipped, swapped weight) and the
           dk product at every distinct training shape (B=8, 256x256), fp32,
           against ``conv3x3_halo_bwd_plain``, by direct launches, with
           their times, the bound and cuDNN's for the same gradients
           (``torch.nn.grad.conv2d_input`` / ``conv2d_weight``);
5. conv_v2_kernel  the bf16 tensor-core conv (conv_v2) against
           ``conv_v2_plain``: forward at every eval-path shape, the conv
           Function's forward, dx and dk in bf16 at every training shape, and
           forward at ``scripts/bench_pallas_v2.py``'s three shapes; per
           shape its time, TFLOP/s, the bound, the plain version's time,
           cuDNN's bf16 ``F.conv2d``, the wrapper's
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
           then the same batch through the fp32 codec (the default config's
           dtype, every dense 3x3 conv through conv3x3_halo): a warm-up and
           the same number of timed steps (``fp32_ms_per_step``, MP/s,
           kernel 1's launches against 138 a step), one of them profiled
           (``profile_fp32``); bf16 checked against fp32;
9. profile one more eval step under torch.profiler: device busy time and
           the kernels that take most of it;
10. train  the flagship in bf16, B=8 patches of 256x256, from the
           lambda=2000 weights, Adam at lr 1e-4: 2 warm-up and 5 timed
           train steps (ms/step, patches/s, MP/s, every loss, conv_v2
           launches per step against the number reckoned from the model,
           peak memory), then one more step under torch.profiler;
11. agent  the CLI on a temporary copy of
           ``configs/flagship_lifting_ztsep.json`` (batch 2, patch 128,
           fp32, lambda 2000, 4 steps an epoch, 2 epochs): train, validate,
           save; then ``--resume-training`` restores epoch, iteration, lr
           and the Adam moments and takes one more epoch; then
           ``agent_test``: the CLI in ``mode: test`` on that checkpoint, a
           real bitstream of each of ``AGENT_TEST_IMAGES`` dead-leaves
           images (every agent's ``mode: test`` below codes those);
12. bitstream  the real bitstream (``coding/codec_coder.py``: transforms on
           the card, entropy coding in host C++) of the flagship in fp32
           over the 24 images of the held-out set (the 19 dead-leaves
           images ``synthetic_natural_images(19, 256, seed=9999)`` and the
           5 photographs, read from ``results/heldout_photos.npz`` where
           their packages are missing), one at a time, with the lambda=2000
           snapshot and then the lambda=6000 one: every plane decodes to
           the encoder's writeback bit for bit, and each image's bpp and
           PSNR are held to the JAX package's CPU coding of the same
           snapshot and image (``results/port_bitstream_targets.json`` and
           ``port_photo_targets.json``; ``port_flagship6000_targets.json``);
           the 24-image means beside ``results/rd_flagship.json``'s points;
           seconds per 256x256 image split into the transforms on the card
           and the host's coding; one image's transforms profiled (device
           busy time, largest device ops);
13. bitstream_bf16  the first ``SECOND_PASS_IMAGES`` of those 19 images
           with bf16 operands (conv_v2 in the
           analysis and synthesis): lossless, each image close to the fp32
           pass, 120 conv_v2 launches an image (60 in the analysis, 60 in
           the synthesis), one image's transforms profiled as in fp32;
           then a Kodak-size image (512x768) timed:
           s/image, coded MP/s, card and host.

Then the postprocess stage (the lambda=2000 flagship frozen, a restoration
net on its reconstruction; iwave, ``resnetlevel`` 6, width 64, is the
path's), tiled coding and the entry points' fp32:

13a. pp_kernel  kernel 1 (launched directly) at every restoration-net shape
           (DnCNN, iwave, IRCNN, DIDN, DUDnCNN: every stride-1 undilated
           3x3 conv): forward at B=8 512x768, forward, dx and dk at B=8
           256x256, against the plain versions, with cuDNN fp32's time and
           the bound (launches a step: iwave's);
13b. pp_parity  each net, seeded, card vs CPU: the train-mode forward and
           its running statistics, then the eval forward (1e-4 of the
           largest ``net(x) - x``); one postprocess train step card vs CPU
           (loss terms 1e-4, the net's gradients 1e-2 a tensor and 1e-3 on
           the L2), launches as reckoned (the codec's 138 and the net's);
13c. pp_main  the restored eval step at B=8 512x768 (ms, MP/s, 153 launches
           a step), the postprocess train step at B=8 256x256 (ms, 153
           launches and 14 dx a step, peak memory), one step profiled
           (``pp_train_profile``), then 50 steps from the seeded init: the
           held-out batch's restored MSE must fall;
13d. pp_agent  the CLI's ``mode: train_postprocess`` on a checkpoint of
           the lambda=2000 snapshot (2 epochs of 2 steps, validation with
           the net), then ``mode: test`` on two images;
13e. tiled_bitstream  a 1024x1024 image through the CLI's ``mode: test``
           with ``tile_size`` 256 (4 tiles), held to the JAX package's CPU
           tiled coding (``results/port_tiled_targets.json``) at 0.5 % bpp
           and 0.02 dB; a 256x256 image's 2 tiles one after another
           against the tile pool (the same bytes): s/image, MP/s, each
           tile's card/host split, peak memory;
13f. agent_tf32_default  the CLI's ``mode: test`` entered with PyTorch's
           defaults (cuDNN's TF32 on), outside ``tf32_off``: the first
           ``SECOND_PASS_IMAGES`` dead-leaves images with the lambda=2000
           snapshot against the
           ``bitstream`` gates, the flags off after the run; then onlyEZWT's
           and ZTBlock's coders round trips with TF32 forced on (do they
           still decode bit for bit?);
13g. fast_conv_forms  the JAX package's matmul conv forms at every shape
           of the bf16 eval step (B=8 512x768) that takes one: the cgp
           stacks' ``grouped_conv1x1_einsum`` and the csc conv's
           ``grouped_conv_taps`` (fp32 sums of bf16 operands, 1e-4 of max
           |plain|), each with its time, the plain version's, cuDNN's
           bf16 conv and the bound; ``conv5x5_s2d`` (not wired: the P/U
           convs take cuDNN's bf16 5x5, the same rounding) at the largest
           P/U shape, its bf16 output within half a bf16 step; the grouped
           forms at the fp32 step's shapes beside cuDNN's fp32 grouped
           convs (recorded only); the bf16 eval and train steps with
           the earlier cuDNN grouped convs, then with today's forms;
13h. dp_train_gloo, dp_train_nccl  the fp32 flagship train step (lambda=2000
           snapshot, B=8 256x256) through ``make_dp_train_step`` on two
           ranks sharing the card (gloo: NCCL refuses two ranks on one
           GPU) and on one NCCL rank, each rank against the single-device
           step (RD terms 1e-4) and its gradients against one device's of
           the same batch slices averaged (the whole batch's on one rank;
           1e-2 a tensor, 1e-3 on the L2, cuDNN deterministic; the gap to
           the whole batch's recorded), the ranks' parameters equal to
           the bit after 3 steps, the shardmap step timed, kernel 1's
           launches (forward and dx) counted in each rank;
13i. halo_eval_flagship, halo_eval_cdf97  one 2048x2048 image H-sharded
           over two gloo ranks through ``make_halo_eval_step``: RD terms
           1e-4 and xhat's mean |d| 1e-5 of the single-device eval step;
           ms and peak memory per rank, kernel 1's and the ladder
           kernels' launches;
13j. tiled_mesh  ``tiled_forward`` of a 1024x1024 image in 4 tiles over
           two ranks against one device's;
13k. agent_mesh  the CLI with ``mesh_shape: [2]`` (2 epochs of 2 steps),
           resumed as a one-device run, then ``mode: test`` on the
           ``AGENT_TEST_IMAGES`` images;
13l. supervise  the CLI under ``--supervise`` (CDF97, one epoch) to exit 0,
           its heartbeat file's age read after it.

Then the CDF 9/7 + factorized codec (``configs/cdf97_factorized.json`` at
full width: joint RGB, 4 levels, pointwise AEs, factorized bottlenecks,
fp32, random weights from the port's seeded init):

14. lift97_kernel  the ladder kernels along one axis in all four uses
           (analysis: the forward F and the adjoint of the inverse;
           synthesis: the inverse I and the adjoint of the forward) against
           their plain versions along H and W, at every distinct shape of
           the three passes that make up a level of the CDF97 eval path
           (B=8 512x768) and train path (B=4 256x256) and at
           ``scripts/bench_pallas.py``'s shapes; the adjoint identities on
           the card; times, the plain versions', the bound, and as the
           yardstick the same transform as one strided cuDNN conv (or
           transposed conv) with the 9/7 filters on a circularly padded
           input, never used by the port;
    lift97_level  the same kernels over a whole 2-D level, one launch each
           way, as the path runs them, at every level of the eval and train
           paths in all four uses: the error against the plain level, the
           adjoint identities, ms by events, device ms (torch.profiler) and
           host us a call, the same level as three one-axis launches and
           the pack's copy (the form the port ran before), the plain
           level's ms, the bound (8 bytes a sample) and the cuDNN yardstick
           (the strided convs along H, then W);
15. cdf97_parity  the eval step card vs CPU on one 256x256 image, then one
           train step card vs CPU with the training noise pinned to zero;
16. cdf97_main  the eval step at B=8 512x768 (ms, MP/s, bpp, PSNR, the
           ladder's launches against 8 a step), then one step profiled;
17. cdf97_train  the train step at the config's batch, 4 x 256x256, Adam at
           lr 1e-4: 2 warm-up and 5 timed steps (launches against 12 a
           step), then one step profiled;
18. cdf97_bitstream  the real bitstream of four 256x256 images: lossless,
           the real bpp within 3 % of the eval step's likelihood bpp, 8
           ladder launches an image;
19. cdf97_agent  the CLI on the config cut to 2 steps an epoch and 2
           epochs, then ``--resume-training``, then ``mode: test``.

Then the tree-based entropy models, onlyEZWT (prefix ``ezwt``) and ZTBlock
(``ztblock``): the flagship config with only ``entropy_layer`` changed, at
full width (three per-plane codecs, 4 levels, learned lifting, Berk AEs),
the transform from the lambda=2000 snapshot and the entropy model from the
port's seeded init (no trained weights of these models exist). For each:

20. {m}_parity  fp32 card vs CPU: the eval step on one 256x256 image (RD
           terms 1e-4, xhat mean |d| 1e-5), one train step of 2 x 128x128
           (gradients 1e-2 per tensor, ZTBlock 5e-2 (``TREE_GRAD_TOL``),
           1e-3 on the L2, cuDNN deterministic), launches as reckoned;
21. {m}_main  the B=8 512x768 eval step in fp32 and in bf16: ms a step,
           MP/s, the entropy models' own ms on the step's subbands, one
           step profiled (``{m}_profile_float32`` / ``_bfloat16``);
           launches gated (onlyEZWT: 138 of kernel 1 in fp32; 120 of
           kernel 4 and its plc's 18 of kernel 1 in bf16; ZTBlock: 120,
           its dep-nets on cuDNN);
22. {m}_train  the bf16 B=8 256x256 train step (1 warm-up, 2 timed): ms a
           step, launches gated
           (kernel 4 forward and dx; onlyEZWT's plc forward and dx on
           kernel 1), one step profiled;
23. {m}_bitstream  the entropy model fitted first (Adam on the entropy
           models alone over a seeded batch's subbands, the transform
           frozen), then the real bitstream in fp32 of the first 4 of the
           19 dead-leaves images: lossless, each image's real rate within 3 % of its
           likelihood rate under the coding path's contexts (the eval
           step's rate beside it: ZTBlock's eval forward quantizes its
           contexts otherwise), two images coded on the CPU too (0.5 %
           bpp, 0.02 dB), s/image with the card/host split, one round trip
           profiled; 156 kernel-1 launches an image for onlyEZWT (the AEs'
           120, the plc's 18 in the encoder's chain and 18 in the decoder's
           passes), 120 for ZTBlock;
24. coding_many (after ezwt_bitstream)  ``compress_decompress_many`` over
           those four images at workers 1 and 2: the streams of
           sequential coding byte for byte, s/image;
25. {m}_agent  the CLI on the flagship config with the entropy layer
           changed (one epoch of 2 steps of 2 x 64x64), resumed, then
           ``mode: test``.

Then the quincunx integer-lifting codec (``scripts/rd_sweep.py``'s preset:
'hv' split, ``lif_prec_bits`` 8, 3 levels, joint RGB, pointwise AEs,
factorized; 320,994 parameters) with its trained snapshots, fp32, every P/U
net's 3x3 conv on kernel 1:

26. quincunx_kernel  kernel 1 (launched directly) at every quincunx shape:
           forward at the B=8 512x768 eval step's 12, forward, dx and dk at
           the B=8 256x256 train step's 12 (``quincunx_kernel_bwd``), each
           against its plain version, with its time, cuDNN fp32's and the
           bound;
27. quincunx_parity  the lambda=400 snapshot card vs CPU: the eval step on
           one 256x256 image (rates 1e-4, distortion and xhat's mean |d|
           at ``QUINCUNX_DIST_RTOL`` / ``QUINCUNX_XHAT_MEAN_TOL``, rounded
           subbands equal in 99.9 %), one train step (noise from one CPU
           generator; gradients 1e-2 a tensor, 1e-3 on the L2), launches;
28. quincunx_main  the eval step at B=8 512x768 (ms, MP/s, 144 kernel-1
           launches a step) and the train step at B=8 256x256 (2 warm-up,
           ``QUINCUNX_TRAIN_STEPS`` timed, 287 launches a step of which 143
           dx, peak memory), one step of each profiled;
29. quincunx_bitstream  both snapshots over the 19 dead-leaves images of
           the held-out set, one at a time: lossless, each image within
           0.5 % bpp / 0.02 dB of the JAX package's CPU coding
           (``results/port_quincunx_targets.json``), the means beside
           ``results/rd_quincunx.json``'s, s/image split into card and
           host; the snapshot's lifting nets alone on grid-valued images
           (the same bits twice, the share back on the grid) and one
           stream decoded twice to the same bits;
30. quincunx_agent  the CLI on a temporary JSON of the preset (batch 2,
           patch 64, 2 epochs of 2 steps), resumed, then ``mode: test``;
31. alt_{basic,attention,attention_post}  BasicWavelet, AttentionWavelet
           and AttentionWaveletPostProcessing (factorized, joint RGB, 4
           levels, seeded weights): card vs CPU (eval and one train step),
           the B=8 512x768 eval step timed with the ladder kernels'
           launches gated (4 + 4 a step for the attention transforms), and
           a bitstream of two 256x256 images.

Then a ``kernels`` line, the card's name and power limit again, and the
last line ``{"ok": true, "device": {...}}``. Every other line carries
``elapsed_s``, the seconds since the script started.

The port's entry points (the CLI, the agent, ``CodecCoder``,
``make_train_step`` and ``make_eval_step``) turn TF32 off themselves (``config.full_fp32``), so every phase
runs fp32 at full precision but ``agent_tf32_default``'s start;
``tf32_off`` keeps the harness's own comparisons (the kernels against
their plain versions and cuDNN) in full fp32 whatever ran before.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import itertools
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
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
TREE_TRAIN_WARMUP = 1            # the tree models' bf16 train steps
TRAIN_LR = 1e-4
PARITY_B, PARITY_P = 2, 128      # the train step compared with the CPU's
AGENT = dict(batch_size=2, patch_size=128, dtype="float32", lambda_=2000.0,
             multi_agent=False, steps_per_epoch=4, max_epoch=2)
# the images each validation pass of an agent run in this process takes, of
# the loader's 32 synthetic ones (a pass of all 32 took 9-13 s, host-bound)
AGENT_VALID_IMAGES = 4
CDF97_SEED = 0                   # the port's init of the CDF97 codec
CDF97_TRAIN_B = 4                # the config's batch_size and patch_size
CDF97_AGENT = dict(multi_agent=False, steps_per_epoch=2, max_epoch=2)
BENCH_PALLAS_SHAPES = ((8, 3, 512, 768), (1, 3, 2048, 2048))  # NCHW
# scripts/bench_pallas_v2.py's SHAPES: NHWC input, Cout
BENCH_PALLAS_V2_SHAPES = (((8, 256, 384, 96), 192), ((8, 256, 384, 192), 96),
                          ((8, 128, 192, 96), 192))
TARGETS = os.path.join(HERE, "results", "port_bitstream_targets.json")
PHOTO_TARGETS = os.path.join(HERE, "results", "port_photo_targets.json")
RD_FLAGSHIP = os.path.join(HERE, "results", "rd_flagship.json")
# the flagship's two committed snapshots: (snapshot, lambda, the files of
# the JAX package's CPU coding of the 24 held-out images)
FLAGSHIP_POINTS = {
    "flagship_lam2000": (SNAPSHOT, 2000.0, (TARGETS, PHOTO_TARGETS)),
    "flagship_lam6000": (
        os.path.join(HERE, "results", "ckpt_snapshots", "flagship_lam6000.npz"),
        6000.0, (os.path.join(HERE, "results",
                              "port_flagship6000_targets.json"),))}
BITSTREAM_IMAGES = (19, 256, 9999)  # synthetic_natural_images(n, size, seed)
TREE_BITSTREAM_IMAGES = 4        # the first 4 of those, for the tree models
AGENT_TEST_IMAGES = (4, 128, 9999)  # every agent's mode: test (n, size, seed)
KODAK_IMAGES = 1                 # bitstream_bf16's timed 512x768 images
# the first images of the 19 that bitstream_bf16 and agent_tf32_default code
SECOND_PASS_IMAGES = 8
CDF97_BITSTREAM_IMAGES = 4       # 256x256
# the tree-based entropy models: (phase prefix, entropy_layer, Adam steps
# fitting the entropy model before the bitstream; a ZTBlock step is
# host-bound by its 216 dep-nets, ~0.44 s on the H100's host)
TREE_MODELS = (("ezwt", "onlyEZWT", 500),
               ("ztblock", "DWTConditioned2EntropyLayerZTBlock", 100))
TREE_SEED = 0                    # the entropy models' init
TREE_TRAIN_STEPS = 2             # timed bf16 train steps of each
TREE_FIT_LR = 1e-3               # the fit: Adam over the snapshot
TREE_FIT_BATCH = (8, 128)        # transform's subbands of 8 seeded patches
TREE_CPU_IMAGES = 2              # bitstream images also coded on the CPU
TREE_AGENT = dict(AGENT, steps_per_epoch=2, max_epoch=1, patch_size=64)
CODING_MANY = 4                  # images of phase coding_many (256x256)
# the quincunx integer-lifting codec: scripts/rd_sweep.py's preset (its
# nets take no compute dtype), with its two trained snapshots
QUINCUNX = dict(netType="QuincunxLifting", entropy_layer="factorized",
                autoencoder="SubbandAutoEncoder", clrch=3, dwtlevels=3,
                split_mode="hv", lif_prec_bits=8, num_lifting_perlayer=2,
                dtype="float32")
QUINCUNX_SNAPSHOTS = {"quincunx_lam400": 400.0, "quincunx_lam1600": 1600.0}
QUINCUNX_TARGETS = os.path.join(HERE, "results", "port_quincunx_targets.json")
RD_QUINCUNX = os.path.join(HERE, "results", "rd_quincunx.json")
QUINCUNX_TRAIN_STEPS = 5         # timed fp32 train steps, B=8 256x256
QUINCUNX_AGENT = dict(batch_size=2, patch_size=64, steps_per_epoch=2,
                      max_epoch=2, multi_agent=False)
# the other transforms: (phase suffix, netType), seeded weights
ALT_TRANSFORMS = (("basic", "BasicWavelet"), ("attention", "AttentionWavelet"),
                  ("attention_post", "AttentionWaveletPostProcessing"))
ALT_SEED = 0
ALT_BITSTREAM_IMAGES = 2         # 256x256
# the postprocess stage: the restoration nets (iwave is the path's), the
# card-vs-CPU batch of pp_parity (B, side), timed train steps, the steps
# from seeded init of pp_main (steps, B, side), the agent's cut
PP_KINDS = ("DnCNN", "iwave", "IRCNN", "DIDN", "DUDnCNN")
PP_RESNETLEVEL = 6
PP_PARITY = (2, 64)
PP_TRAIN_STEPS = 5
PP_CONVERGE = (50, 2, 64)
PP_AGENT = dict(AGENT, postprocess="iwave", resnetlevel=PP_RESNETLEVEL,
                steps_per_epoch=2)
# tiled coding: (side, tile_size, seed) of the image held to the JAX
# package's CPU tiled coding, and of the one coded with the tiles one after
# another and on the pool (the same bytes)
TILED = ((1024, 256, 3), (256, 128, 3))
TILED_TARGETS = os.path.join(HERE, "results", "port_tiled_targets.json")
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
# ZTBlock's dep-net gradients are worse conditioned still: against the same
# step in float64 (tools/grad_conditioning.py --entropy-layer
# DWTConditioned2EntropyLayerZTBlock --per-module, the snapshot's transform
# and the seeded entropy model, 2 x 128x128) the CPU's fp32 gradient is
# 1.2e-2 off in its worst tensor (a dep-net's one-element output bias,
# whose gradient sums a map that nearly cancels) and the card's 2.7e-2
# (dep_mu_8_0.Conv_3.bias of the Cr plane, where the CPU is within 3.2e-5),
# while the L2 of the card-CPU difference is 1.7e-4. The card's gap starts
# at one output of that conv that fp32 puts on the other side of zero than
# float64 (each conv's output and dy agree with float64 to 2e-6 until
# then): the LeakyReLU after it takes the other slope (1 against 0.01),
# and the bias gradient, a sum over that map, moves with it. Such flips
# happen on every device (39 on the CPU, 40 on the card); which tensor
# they hit decides the reading. Its per-tensor limit is twice the card's
# distance from float64.
TREE_GRAD_TOL = {"ezwt": GRAD_TOL, "ztblock": 5e-2}
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
TREE_REAL_BPP_RTOL = 3e-2        # the same gate for onlyEZWT and ZTBlock
# Integer lifting rounds every lifted value to a 1/255 grid: where the card's
# fp32 conv sums put a value within an ulp of a grid boundary from the CPU's,
# one rounding flips and moves the pixels it reaches by a grid step. So card
# against CPU is gated on means and shares, never on a maximum.
# On one 256x256 image of the lambda=400 snapshot the JAX package and the
# port, both on the CPU, differ so by 4.0e-4 in the mse (0.0017 dB) and by
# 8.3e-5 in mean |xhat| (images of seeds 0-2); the rates by 1.1e-5. The
# distortion terms (loss, mse) and xhat are held to five times that, the
# rates to PARITY_RTOL.
QUINCUNX_DIST_RTOL = 2e-3
QUINCUNX_XHAT_MEAN_TOL = 5e-4    # mean |xhat_card - xhat_cpu|
SUBBAND_EQUAL_SHARE = 0.999      # rounded subband values equal, card vs CPU
# The lifting nets alone on a grid-valued image (k/255): in fp32 the
# inverse's add undoes the forward's only to an ulp, and where a P/U output
# then sits on a rounding boundary a grid step flips and travels on. The
# JAX package's own CPU round trip of the two images returns 98.98 % of the
# pixels to 1e-6 (at most 3 grid steps off); the port's is held to 98 %,
# and to give the same bits twice.
GRID_EXACT_SHARE = 0.98


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


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
    """(analysis, synthesis) kernel launches of one CDF97 step: one level
    kernel launch a level each way; a train step's backward adds the
    adjoint of the inverse (the analysis kernel). The image needs no
    gradient, so the adjoint of the forward never runs on the path."""
    per = cfg.dwtlevels
    return (2 * per if train else per), per


def level_shapes(levels, b, h, w):
    """The NCHW input of each 2-D level of a CDF97 step on B x 3 x H x W
    images, finest first; each level launches once each way a step."""
    return [(b, 3, h >> lvl, w >> lvl) for lvl in range(levels)]


def ladder_shapes(levels, b, h, w):
    """Distinct (NCHW input shape of a 1-D analysis pass, dim) of the three
    passes that make up each 2-D level of a CDF97 step on B x 3 x H x W
    images (the parent's form of the level), each with its passes a level
    set."""
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
    if has_plc(cfg):
        for lvl in range(1, L):                   # plc of finer level lvl-1
            add(height >> lvl, width >> lvl,
                [(so, so * 81), (so * 81, so * 81)], 1)
    return counts


def has_plc(cfg):
    """Whether the entropy model has dense 3x3 parent-context stacks (two
    layers a finer level): ZTsep's in the config's dtype, onlyEZWT's in
    fp32 always; ZTBlock's dep-nets are cuDNN convs."""
    return cfg.entropy_layer in ("conditioned2ZTsepSubbands", "onlyEZWT")


def plc_launches(cfg):
    """onlyEZWT's plc launches a step or an image's coding pass: two a finer
    level on every plane, kernel 1 whatever the config's dtype."""
    if cfg.entropy_layer != "onlyEZWT":
        return 0
    planes = 3 if cfg.clrch == 1 else 1
    return 2 * (cfg.dwtlevels - 1) * planes


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


def device_us(torch, fn, kernel=None, reps=10, tries=5):
    """Mean device microseconds of one call of ``fn`` and where they come
    from. From torch.profiler: the kernels whose name holds ``kernel``, or
    every kernel. A trace that holds no such kernel (the profiler drops one
    now and then) is taken again, up to ``tries`` times; then the time
    comes from a CUDA graph of ``reps`` calls, replayed, which counts the
    gaps between its kernels too (an upper bound)."""
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
                 if e.device_type == DeviceType.CUDA
                 and (kernel is None or kernel in e.key)) / reps
        if us > 0:
            return us, "profiler"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (5 * reps), "graph"


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


def phase_kernel(torch, F, conv, cfg, shapes=None, name="kernel"):
    """Kernel 1 (launched directly) vs plain at every eval-path shape (the
    flagship's, or ``shapes``: {(h, w, cin, cout): launches a step});
    returns per-shape rows."""
    rows = []
    gen = torch.Generator(device=DEV).manual_seed(0)
    phase = name
    for (h, w, cin, cout), per_step in sorted(
            (shapes or conv_shapes(cfg)).items()):
        x = torch.randn(B, cin, h, w, device=DEV, generator=gen
                        ).contiguous(memory_format=torch.channels_last)
        wt = torch.randn(cout, cin, 3, 3, device=DEV, generator=gen
                         ) / (3 * cin ** 0.5)
        name, dt = "float32", torch.float32
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
        flops = 2.0 * 9 * cin * cout * B * h * w
        bound, t_ops, t_bytes = conv_bound(B * h * w, cin, cout, name)
        row = {"phase": phase, "dtype": name, "x": [B, cin, h, w],
               "cout": cout, "launches_per_step": per_step,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound, "ops_ms": t_ops,
               "bytes_ms": t_bytes,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flops / 1e9, "tflops": flops / ms / 1e9}
        emit(row)
        rows.append(row)
        del x, wt
    torch.cuda.empty_cache()
    return rows


def phase_kernel_bwd(torch, conv, cfg, shapes=None, name="kernel_bwd",
                     no_dx=()):
    """Kernel 1's forward and dx (launched directly) and the dk product
    against the plain versions at every training shape (the flagship's, or
    ``shapes``); returns per-shape rows. ``no_dx``: shapes whose first
    layer of a step sees the image, which needs no dx (one launch fewer a
    step)."""
    rows = []
    gen = torch.Generator(device=DEV).manual_seed(1)
    b = TRAIN_B
    shapes = shapes or conv_shapes(cfg, (TRAIN_P, TRAIN_P))
    phase = name
    for (h, w, cin, cout), per_step in sorted(shapes.items()):
        x = torch.randn(b, cin, h, w, device=DEV, generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device=DEV, generator=gen
                         ) / (3 * cin ** 0.5)
        dy = torch.randn(b, cout, h, w, device=DEV, generator=gen)
        name, dt = "float32", torch.float32
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
        dsize = 4                        # fp32 operands
        n = b * h * w
        flops = 2.0 * 9 * cin * cout * n
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        dx_bytes = (n * cout + 9 * cin * cout) * dsize + n * cin * 4
        dk_bytes = (n * cin + n * cout) * dsize + 9 * cin * cout * 4
        t_dx_bytes = dx_bytes / PEAK_BYTES * 1e3
        t_dk_bytes = dk_bytes / PEAK_BYTES * 1e3
        row = {"phase": phase, "dtype": name, "x": [b, cin, h, w],
               "cout": cout, "launches_per_step": per_step,
               "dx_launches_per_step": per_step
               - ((h, w, cin, cout) in no_dx),
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


def conv_bound(n, cin, cout, dtype="bfloat16"):
    """(bound ms, ops ms, bytes ms) of one SAME 3x3 conv over ``n`` pixels
    with ``dtype`` operands (bf16 or fp32) and an fp32 output: input and
    weight read once, output written once."""
    size = 2 if dtype == "bfloat16" else 4
    t_ops = 2.0 * 9 * cin * cout * n / PEAK_FLOPS[dtype] * 1e3
    t_bytes = ((n * cin + 9 * cin * cout) * size + n * cout * 4) \
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


def phase_conv_v2_kernel(torch, F, conv, v2, cfg):
    """Kernel 4 (conv_v2) against ``conv_v2_plain``: forward at every
    eval-path shape (B=8 512x768), the bf16 conv Function's forward, dx and
    dk at every training shape (B=8 256x256), forward at
    ``bench_pallas_v2.py``'s shapes; returns per-shape rows. Each row also
    has the wrapper's operand copies timed
    alone (``pad_ms``: ``padded_operands``, part of ``ms``), the launch
    plan and the kernel's registers and spills from the build log."""
    rows = []
    resources = kernel_resources(v2.LIBRARY.build_log)
    cl = torch.channels_last
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(4)

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
        bound, t_ops, t_bytes = conv_bound(b * h * w, cin, cout)
        flops = 2.0 * 9 * cin * cout * b * h * w
        row = {"phase": "conv_v2_kernel", "path": path, "x": [b, cin, h, w],
               "cout": cout, "launches_per_step": per_step,
               "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
               "tflops": flops / ms / 1e9, "pad_ms": pad_ms, **fields,
               "plain_ms": plain_ms,
               "library_ms": lib_ms,
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
        row = {"phase": "conv_v2_kernel", "path": "train", "x": [b, cin, h, w],
               "cout": cout, "launches_per_step": n,
               "fwd_max_abs_err": fwd_abs, "fwd_max_rel_err": fwd_rel,
               "dx_max_abs_err": dx_abs, "dx_max_rel_err": dx_rel,
               "dk_max_rel_err": dk_rel, "fwd_ms": fwd_ms, "dx_ms": dx_ms,
               "pad_ms": pad_ms, "dx_pad_ms": dx_pad_ms, **fields,
               **dx_fields,
               "dx_plain_ms": plain_ms, "dx_library_ms": lib_dx_ms,
               "fwd_bound_ms": fwd_bound, "dx_bound_ms": dx_bound,
               "ops_ms": t_ops, "dx_bytes_ms": dx_bytes,
               "gflop": 2.0 * 9 * cin * cout * n_px / 1e9,
               "dx_tflops": 2.0 * 9 * cin * cout * n_px / dx_ms / 1e9}
        emit(row)
        rows.append(row)
        del x, wt, dy
    torch.cuda.empty_cache()
    return rows


def load_model(cfg, pkg, snapshot=SNAPSHOT):
    model = pkg.codec.CodecWrapper(cfg)
    pkg.weights.load_flax_params(model, pkg.weights.load_npz(snapshot))
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
    dense 3x3 conv through conv_v2, none through conv3x3_halo. Then the
    same batch through the fp32 codec (TF32 off), timed as the bf16 steps
    are: every dense 3x3 conv through conv3x3_halo, none through conv_v2;
    one more fp32 step profiled."""
    cfg = pkg.config.flagship_config(dtype="bfloat16")
    batch = eval_batch(torch, np, pkg)
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

    # the same batch through the fp32 codec (the default config's dtype):
    # timed like the bf16 steps, and bf16 must stay close to it
    cfg32 = pkg.config.flagship_config()
    step32 = pkg.state.make_eval_step(cfg32, load_model(cfg32, pkg), DEV)
    with tf32_off(torch):
        step32(batch)                 # warm-up
        torch.cuda.synchronize()
        counts.reset()
        times32 = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            out32, xhat32 = step32(batch)
            torch.cuda.synchronize()
            times32.append(time.perf_counter() - t0)
        launches32 = counts.read()
        expect_launches(launches32, launches_of(conv=STEPS * expected),
                        f"{STEPS} fp32 eval steps")
        ms32 = [t * 1e3 for t in times32]
        phase_profile(torch, lambda: step32(batch), sum(ms32) / len(ms32),
                      "profile_fp32")
    bpp32 = float(out32.rate1 + out32.rate2)
    psnr32 = float(pkg.loss.psnr(xs, xhat32))
    del out32, xhat32, step32

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
           "fp32_bpp": bpp32, "fp32_psnr_db": psnr32,
           "fp32_ms_per_step": sum(ms32) / len(ms32),
           "fp32_ms_per_step_min": min(ms32), "fp32_ms_per_step_all": ms32,
           "fp32_mp_per_s": B * H * W / 1e6 / (sum(times32) / len(times32)),
           "fp32_launches": launches32,
           "fp32_conv3x3_halo_launches_per_step":
           launches32["conv3x3_halo"] / STEPS,
           "fp32_expected_launches_per_step": expected}
    emit(res)
    if not abs(bpp - bpp32) <= BF16_BPP_RTOL * bpp32 \
            or not abs(psnr - psnr32) <= BF16_PSNR_TOL:
        raise AssertionError("bf16 and fp32 steps disagree")
    return res, step, batch


def phase_profile(torch, run_step, step_ms, name="profile"):
    """One step under torch.profiler: device busy ms (the sum of the
    device-side events' times) and the fifteen largest device-side events.
    Only the device's activity is recorded: a host-bound step's host ops
    run to hundreds of thousands of events, whose averaging took longer
    than the step itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    a resumed run, each epoch validated on ``AGENT_VALID_IMAGES`` images.
    ``reckon(cfg, n_valid)`` gives the kernels' launches in
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
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp), \
            short_validation(pkg):
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
    the training run, whose checkpoint it restores) on
    ``AGENT_TEST_IMAGES`` dead-leaves images."""
    with open("agent_test.json", "w") as fh:
        json.dump(dict(raw, mode="test"), fh)
    cfg = pkg.config.process_config("agent_test.json")
    images = pkg.data.synthetic_natural_images(*AGENT_TEST_IMAGES)
    n_test = len(images)
    counts.reset()
    t0 = time.perf_counter()
    with cli_agents(pkg, images):
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


def flagship_targets(name):
    """``{image: row}`` of the JAX package's CPU coding of a flagship
    snapshot over the held-out set, from its targets files (a file of one
    point holds ``per_image``, one of several ``points[name]``)."""
    out = {}
    for path in FLAGSHIP_POINTS[name][2]:
        with open(path) as fh:
            t = json.load(fh)
        rows = t["points"][name]["per_image"] if "points" in t \
            else t["per_image"]
        out.update({r["image"]: r for r in rows})
    return out


def phase_bitstream(torch, np, pkg, counts):
    """The flagship's real bitstream in fp32 over the 24 images of the
    held-out set, with the lambda=2000 snapshot and then the lambda=6000
    one, each image against the JAX package's CPU coding of it; the
    24-image means beside ``rd_flagship.json``'s points. Returns the
    result and the lambda=2000 rows of the 19 dead-leaves images."""
    images = pkg.rd_heldout.heldout_images()
    names = list(images)
    if len(names) != 24:
        raise AssertionError(f"held-out set: {names}")
    with open(RD_FLAGSHIP) as fh:
        rd = json.load(fh)
    res = {"phase": "bitstream", "dtype": "float32", "images": names,
           "cpu_count": os.cpu_count(), "points": {}}
    bad, dead_rows = [], None
    for name, (snapshot, lam, _) in FLAGSHIP_POINTS.items():
        cfg = pkg.config.flagship_config(lambda_=lam)
        coder = pkg.codec_coder.CodecCoder(cfg, load_model(cfg, pkg, snapshot),
                                           DEV)
        want = launches_of(conv=2 * coding_conv_launches(cfg))
        rows = code_images(torch, pkg, counts, coder, list(images.values()),
                           want, f"bitstream {name}")
        if dead_rows is None:
            profile_transforms(torch, np, pkg, coder,
                               images[f"natural_{BITSTREAM_IMAGES[2]}_0000"],
                               "bitstream_profile")
        targets = flagship_targets(name)
        for img_name, r in zip(names, rows):
            t = targets[img_name]
            r.update(image=img_name, target_bpp=t["bpp"],
                     target_psnr=t["psnr"])
            if not abs(r["bpp"] - t["bpp"]) <= TARGET_BPP_RTOL * t["bpp"] \
                    or not abs(r["psnr"] - t["psnr"]) <= TARGET_PSNR_TOL:
                bad.append((name, img_name))
            emit({"phase": "bitstream_image", "point": name, **r})
        dead = [r for r in rows if r["image"].startswith("natural_")]
        if dead_rows is None:
            dead_rows = dead
        point = rd["points"][str(int(lam))]
        res["points"][name] = {
            "snapshot": os.path.relpath(snapshot, HERE),
            "mean_bpp": mean(rows, "bpp"), "mean_psnr_db": mean(rows, "psnr"),
            "target_mean_bpp": mean(rows, "target_bpp"),
            "target_mean_psnr_db": mean(rows, "target_psnr"),
            "rd_flagship_bpp": point["bpp"],
            "rd_flagship_psnr_db": point["psnr"],
            "gap_to_rd_flagship_bpp_rel": mean(rows, "bpp") / point["bpp"]
            - 1.0,
            "gap_to_rd_flagship_psnr_db": mean(rows, "psnr") - point["psnr"],
            "dead_leaves_mean_bpp": mean(dead, "bpp"),
            "dead_leaves_mean_psnr_db": mean(dead, "psnr"),
            "max_bpp_rel_gap": max(abs(r["bpp"] - r["target_bpp"])
                                   / r["target_bpp"] for r in rows),
            "max_psnr_gap_db": max(abs(r["psnr"] - r["target_psnr"])
                                   for r in rows),
            "launches_per_image": want,
            # the first image builds the coding tables and runs its planes
            # one after another; the means (256x256 images) leave it out
            "first_image_s": rows[0]["wall_s"],
            **{f"mean_{k}": mean(dead, k, skip=1) for k in (
                "wall_s", "encode_s", "decode_s", "analysis_card_ms",
                "synthesis_card_ms", "encode_host_ms", "decode_host_ms",
                "coded_mp_per_s")},
            "photos": {r["image"]: {k: r[k] for k in (
                "bpp", "psnr", "wall_s", "coded_mp_per_s")}
                for r in rows if not r["image"].startswith("natural_")}}
        del coder
    res["launches"] = sum(2 * coding_conv_launches(cfg) * len(names)
                          for _ in FLAGSHIP_POINTS)
    emit(res)
    if bad:
        raise AssertionError(f"bitstream: images {bad} off the JAX targets "
                             f"(bpp {TARGET_BPP_RTOL}, psnr {TARGET_PSNR_TOL} "
                             "dB)")
    return res, dead_rows


def phase_bitstream_bf16(torch, np, pkg, counts, fp32_rows):
    """The first ``SECOND_PASS_IMAGES`` of the 19 images with bf16 operands
    (conv_v2 in the analysis and synthesis), held to the fp32 pass; then
    ``KODAK_IMAGES`` Kodak-size image(s) timed."""
    cfg = pkg.config.flagship_config(lambda_=2000.0, dtype="bfloat16")
    coder = pkg.codec_coder.CodecCoder(cfg, load_model(cfg, pkg), DEV)
    _, size, seed = BITSTREAM_IMAGES
    n = SECOND_PASS_IMAGES
    want = launches_of(v2=2 * coding_conv_launches(cfg))
    images = pkg.data.synthetic_natural_images(BITSTREAM_IMAGES[0], size,
                                               seed=seed)[:n]
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


# --- the tree-based entropy models (onlyEZWT, ZTBlock) ----------------------

def tree_config(pkg, entropy_layer, **kw):
    """The flagship config with only ``entropy_layer`` changed."""
    return pkg.config.flagship_config(entropy_layer=entropy_layer, **kw)


def tree_model(torch, pkg, cfg):
    """The flagship codec with a tree-based entropy model: the transform
    from the lambda=2000 snapshot, the entropy model from the port's init
    with seed ``TREE_SEED`` (the repository holds no trained weights for
    these models)."""
    model = pkg.codec.CodecWrapper(
        cfg, generator=torch.Generator().manual_seed(TREE_SEED))
    flat = {k: v for k, v in pkg.weights.load_npz(SNAPSHOT).items()
            if "['transform']" in k}
    missing, unexpected = model.load_state_dict(
        pkg.weights.state_dict_from_flax(flat), strict=False)
    if unexpected or any(".transform." in k for k in missing):
        raise AssertionError(f"snapshot transform: missing {missing[:4]}, "
                             f"unexpected {unexpected[:4]}")
    return model


def grad_gaps(got_g, want_g):
    """Per-tensor max |g_card - g_cpu| / max |g_cpu|, and the L2 norm of the
    difference over all gradients against theirs."""
    errs = {n: rel_err(got_g[n], want_g[n]) for n in want_g}
    l2 = (sum(float((got_g[n] - want_g[n]).double().pow(2).sum())
              for n in want_g)
          / sum(float(want_g[n].double().pow(2).sum()) for n in want_g)) ** 0.5
    return errs, l2


def phase_tree_parity(torch, np, pkg, counts, key, el):
    """fp32, card vs CPU, with the same weights: the eval step on one 256x256
    image, then one train step on a seeded batch (cuDNN deterministic; noise
    from a CPU generator with one seed feeds both)."""
    cfg = tree_config(pkg, el, lambda_=2000.0, learning_rate=TRAIN_LR)
    img = pkg.data.synthetic_natural_images(1, 256, seed=0)[0]
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0
    cpu_model = tree_model(torch, pkg, cfg)
    gpu_model = copy.deepcopy(cpu_model)
    want, want_xhat = pkg.state.make_eval_step(cfg, cpu_model, "cpu")(x)
    step = pkg.state.make_eval_step(cfg, gpu_model, DEV)
    counts.reset()
    got, got_xhat = step(x)
    torch.cuda.synchronize()
    eval_launches = counts.read()
    d = (got_xhat.cpu() - want_xhat).abs()
    res = {"phase": f"{key}_parity", "entropy_layer": el,
           "image": [1, 3, 256, 256], "dtype": "float32",
           "launches": eval_launches, "xhat_max_abs_err": d.max().item(),
           "xhat_mean_abs_err": d.mean().item()}
    bad = []
    for k in ("loss", "mse", "rate1", "rate2"):
        a, b = float(getattr(got, k)), float(getattr(want, k))
        res[k] = {"card": a, "cpu": b, "rel_err": abs(a - b) / abs(b)}
        if not res[k]["rel_err"] <= PARITY_RTOL:
            bad.append(k)
    if not res["xhat_mean_abs_err"] <= XHAT_MEAN_TOL:
        bad.append("xhat")
    del cpu_model, gpu_model, step

    batch = train_batch(torch, np, pkg, PARITY_B, PARITY_P, seed=2)
    results = {}
    for dev in ("cpu", DEV):
        model = tree_model(torch, pkg, cfg)
        tstep = pkg.state.make_train_step(
            cfg, model, pkg.state.make_optimizer(cfg, model), dev)
        counts.reset()
        out, aux = tstep(batch, torch.Generator().manual_seed(3), TRAIN_LR,
                         1.0)
        if dev != "cpu":
            torch.cuda.synchronize()
        results[dev] = (out, float(aux), counts.read(),
                        {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()})
        del model, tstep
    (t_want, aux_want, cpu_counts, want_g), (t_got, aux_got, train_counts,
                                             got_g) = results["cpu"], \
        results[DEV]
    tr = {"batch": [PARITY_B, 3, PARITY_P, PARITY_P],
          "launches": train_counts, "aux": {"card": aux_got, "cpu": aux_want}}
    for k in ("loss", "mse", "rate1", "rate2"):
        a, b = float(getattr(t_got, k)), float(getattr(t_want, k))
        tr[k] = {"card": a, "cpu": b, "rel_err": abs(a - b) / abs(b)}
        if not tr[k]["rel_err"] <= PARITY_RTOL:
            bad.append(f"train {k}")
    errs, l2 = grad_gaps(got_g, want_g)
    worst = max(errs, key=errs.get)
    tr.update(grad_tensors=len(errs), grad_worst=worst,
              grad_worst_rel_err=errs[worst],
              grad_tensors_over_1e_3=sum(e > 1e-3 for e in errs.values()),
              grad_l2_rel_err=l2)
    res["train"] = tr
    emit(res)
    if not errs[worst] <= TREE_GRAD_TOL[key] or not l2 <= GRAD_L2_TOL:
        bad.append(f"gradient {worst}")
    if bad:
        raise AssertionError(f"{key}: card and CPU disagree: {bad}")
    expect_launches((eval_launches, cpu_counts, train_counts),
                    (reckon_step(cfg), launches_of(),
                     reckon_step(cfg, True, (PARITY_P, PARITY_P))),
                    f"{key} parity (eval card, train cpu, train card)")
    return res


def subband_batch(torch, pkg, model, batch):
    """The three planes' subbands of ``batch`` (no gradient): the entropy
    models' inputs."""
    ycbcr = pkg.color.shift_ycbcr(pkg.color.rgb_to_ycbcr(batch))
    with torch.inference_mode():
        return [model.codecs[p].transform.encode(ycbcr[:, p:p + 1])
                for p in range(3)]


def phase_tree_main(torch, np, pkg, counts, key, el):
    """The eval step at B=8 512x768 in fp32 (TF32 off) and in bf16: ms a
    step, MP/s, the kernels' launches against the reckoning, the entropy
    models' own time on the step's subbands, and one step profiled."""
    batch = eval_batch(torch, np, pkg)
    res = {"phase": f"{key}_main", "entropy_layer": el, "batch": [B, 3, H, W],
           "steps": STEPS}
    for dtype in ("float32", "bfloat16"):
        cfg = tree_config(pkg, el, dtype=dtype, lambda_=2000.0)
        model = tree_model(torch, pkg, cfg)
        step = pkg.state.make_eval_step(cfg, model, DEV)
        ctx = tf32_off(torch) if dtype == "float32" \
            else contextlib.nullcontext()
        with ctx:
            step(batch)                               # warm-up
            torch.cuda.synchronize()
            counts.reset()
            times = []
            for _ in range(STEPS):
                t0 = time.perf_counter()
                out, xhat = step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            launches = counts.read()
            expect_launches(launches, {k: STEPS * v for k, v in
                                       reckon_step(cfg).items()},
                            f"{key} {STEPS} {dtype} eval steps")
            subs = subband_batch(torch, pkg, model, batch)
            ems = [model.codecs[p].entropymodel for p in range(3)]

            @torch.inference_mode()
            def entropy():
                for em, (xe, xo) in zip(ems, subs):
                    em(xe, xo)

            entropy_ms = time_ms(entropy, torch, min_ms=0.0, max_reps=STEPS)
            ms = [t * 1e3 for t in times]
            phase_profile(torch, lambda: step(batch), sum(ms) / len(ms),
                          f"{key}_profile_{dtype}")
        bpp = float(out.rate1 + out.rate2)
        psnr = float(pkg.loss.psnr(batch - 0.5, xhat))
        if not all(math.isfinite(v) for v in (bpp, psnr, float(out.loss))) \
                or tuple(xhat.shape) != (B, 3, H, W):
            raise AssertionError(f"{key} {dtype}: bpp {bpp} psnr {psnr}")
        mean_s = sum(times) / len(times)
        res[dtype] = {"ms_per_step": mean_s * 1e3, "ms_per_step_min": min(ms),
                      "ms_per_step_all": ms,
                      "mp_per_s": B * H * W / 1e6 / mean_s,
                      "entropy_model_ms": entropy_ms,
                      "entropy_model_share": entropy_ms / (mean_s * 1e3),
                      "bpp": bpp, "psnr_db": psnr, "launches": launches,
                      "reckoned_per_step": reckon_step(cfg)}
        del model, step, subs, ems, out, xhat
        torch.cuda.empty_cache()
    emit(res)
    return res


def phase_tree_train(torch, np, pkg, counts, key, el):
    """bf16 train steps at B=8 256x256, Adam at lr 1e-4:
    ``TREE_TRAIN_WARMUP`` warm-up and ``TREE_TRAIN_STEPS`` timed, launches
    against the reckoning (onlyEZWT's plc forward and dx on kernel 1,
    everything else on conv_v2), then one step profiled."""
    cfg = tree_config(pkg, el, dtype="bfloat16", lambda_=2000.0,
                      learning_rate=TRAIN_LR)
    batch = train_batch(torch, np, pkg, TRAIN_B, TRAIN_P, seed=1).to(DEV)
    model = tree_model(torch, pkg, cfg)
    step = pkg.state.make_train_step(
        cfg, model, pkg.state.make_optimizer(cfg, model), DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)

    def run_step():
        return step(batch, gen, TRAIN_LR, 1.0)[0]

    for _ in range(TREE_TRAIN_WARMUP):
        run_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    times, outs = [], []
    for _ in range(TREE_TRAIN_STEPS):
        t0 = time.perf_counter()
        outs.append(run_step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts.read()
    per = reckon_step(cfg, True, (TRAIN_P, TRAIN_P))
    expect_launches(launches, {k: TREE_TRAIN_STEPS * v
                               for k, v in per.items()},
                    f"{key} {TREE_TRAIN_STEPS} bf16 train steps")
    losses = [float(o.loss) for o in outs]
    if not all(math.isfinite(v) for v in losses) or not all(
            torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f"{key}: non-finite training: {losses}")
    ms = [t * 1e3 for t in times]
    mean_s = sum(times) / len(times)
    phase_profile(torch, run_step, mean_s * 1e3, f"{key}_train_profile")
    res = {"phase": f"{key}_train", "entropy_layer": el, "dtype": "bfloat16",
           "batch": [TRAIN_B, 3, TRAIN_P, TRAIN_P], "lr": TRAIN_LR,
           "warmup_steps": TREE_TRAIN_WARMUP, "steps": TREE_TRAIN_STEPS,
           "ms_per_step": mean_s * 1e3, "ms_per_step_min": min(ms),
           "ms_per_step_all": ms,
           "mp_per_s": TRAIN_B * TRAIN_P * TRAIN_P / 1e6 / mean_s,
           "loss": losses,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "reckoned_per_step": per}
    emit(res)
    return res


def fit_entropy_models(torch, np, pkg, model, steps):
    """Adam on the three planes' entropy models alone (the transform
    frozen) over a seeded batch's subbands, ``steps`` steps of the rate
    plus the bottlenecks' aux loss: a seeded entropy model puts most
    samples in a Gaussian's far tail, where the likelihood's 1e-9 floor,
    not the coder, sets the rate. Returns the rate before and after."""
    n, size = TREE_FIT_BATCH
    batch = train_batch(torch, np, pkg, n, size, seed=4).to(DEV)
    subs = subband_batch(torch, pkg, model, batch)
    subs = [(xe.clone(), [t.clone() for t in xo]) for xe, xo in subs]
    ems = [model.codecs[p].entropymodel for p in range(3)]
    opt = torch.optim.Adam([q for em in ems for q in em.parameters()],
                           lr=TREE_FIT_LR)
    gen = torch.Generator(device=DEV).manual_seed(0)
    rates = []
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        bits, aux = 0.0, 0.0
        for em, (xe, xo) in zip(ems, subs):
            ixe, ixo, _, _ = em(xe, xo, True, gen)
            bits = bits + ixe.sum() + sum(t.sum() for t in ixo)
            aux = aux + em.aux_loss()
        rate = bits / (n * size * size)
        (rate + aux).backward()
        opt.step()
        rates.append(rate.detach())     # read after the loop: no sync a step
    rates = torch.stack(rates).tolist()
    return {"steps": steps, "lr": TREE_FIT_LR,
            "batch": [n, 3, size, size], "bpp_first": rates[0],
            "bpp_last": rates[-1], "seconds": time.perf_counter() - t0}


def coding_likelihood_bpp(torch, pkg, model, image):
    """One image's likelihood rate under the coding path's own contexts: the
    bottlenecks' (LL, coarsest details) as in the eval step, and for each
    finer level, or ZTBlock coset, -log2 of the Gaussian likelihood with the
    (sigma, mu) of the parameter pass on the writebacks ``round(x - mu) +
    mu`` of the levels and cosets before it. onlyEZWT's eval step uses the
    same contexts; ZTBlock's quantizes its cosets' contexts as ``round(x)``
    (as in the JAX package), so its eval-step rate is not the coded one."""
    em_mod = pkg.entropy_models
    x = torch.from_numpy(image).permute(2, 0, 1)[None].float().div(255.0)
    ycbcr = pkg.color.shift_ycbcr(pkg.color.rgb_to_ycbcr(x.to(DEV)))
    bits = 0.0
    with torch.inference_mode():
        for p in range(3):
            codec = model.codecs[p]
            em = codec.entropymodel
            xe, xo = codec.transform.encode(ycbcr[:, p:p + 1])
            info_xe, info_xo, _, xo_q = em(xe, xo)
            bits += float(info_xe.sum()) + float(info_xo[-1].sum())
            con = xo_q[-1]
            for step, lvl in enumerate(range(len(xo) - 2, -1, -1)):
                if isinstance(em, em_mod.OnlyEZWT):
                    sigma, mu = em.level_params_from_parent(lvl, con)
                    con, info = pkg.gaussian.self_information_bits(
                        xo[lvl], sigma, mu)
                    bits += float(info.sum())
                    continue
                parts, cosets = em_mod._cosets(xo[lvl]), []
                for k in range(4):
                    sigma, mu = em.level_coset_params(step, k, con, *cosets)
                    q, info = pkg.gaussian.self_information_bits(
                        parts[k], sigma, mu)
                    bits += float(info.sum())
                    cosets.append(q)
                con = em_mod._interleave_cosets(*cosets)
    return bits / (image.shape[0] * image.shape[1])


def profile_round_trip(torch, coder, image, name):
    """One image's whole round trip (transforms, the entropy models' device
    passes, the host's coding) under torch.profiler: the device's busy
    share of its wall time."""
    batch = image[None].astype("float32") / 255.0
    coder.compress_decompress(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coder.compress_decompress(batch)
    torch.cuda.synchronize()
    phase_profile(torch, lambda: coder.compress_decompress(batch),
                  (time.perf_counter() - t0) * 1e3, name)


def phase_tree_bitstream(torch, np, pkg, counts, key, el, fit_steps):
    """The real bitstream in fp32 of the first ``TREE_BITSTREAM_IMAGES`` of
    the 19 dead-leaves images of the held-out set: the snapshot's transform, the entropy model fitted
    (``fit_entropy_models``); every plane decodes bit for bit (the coder
    raises otherwise), each image's real rate within 3 % of its likelihood
    rate under the coding path's contexts (``coding_likelihood_bpp``; the
    eval step's rate is reported beside it), a few images coded on the CPU
    too; s/image with the card/host split; launches an image against the
    reckoning. Returns the result, the coder and the images."""
    cfg = tree_config(pkg, el, lambda_=2000.0)
    model = tree_model(torch, pkg, cfg).to(DEV)
    fit = fit_entropy_models(torch, np, pkg, model, fit_steps)
    step = pkg.state.make_eval_step(cfg, model, DEV)
    _, size, seed = BITSTREAM_IMAGES
    n = TREE_BITSTREAM_IMAGES
    images = pkg.data.synthetic_natural_images(n, size, seed=seed)
    eval_rate = []
    for img in images:
        out, _ = step(torch.from_numpy(img).permute(2, 0, 1)[None].float()
                      / 255.0)
        eval_rate.append(float(out.rate1 + out.rate2))
    likelihood = [coding_likelihood_bpp(torch, pkg, model, img)
                  for img in images]
    coder = pkg.codec_coder.CodecCoder(cfg, model, DEV)
    want = reckon_coding(cfg)
    rows = code_images(torch, pkg, counts, coder, images, want,
                       f"{key}_bitstream")
    for r, lik, ev in zip(rows, likelihood, eval_rate):
        r["likelihood_bpp"], r["eval_step_bpp"] = lik, ev
    cpu = pkg.codec_coder.CodecCoder(cfg, copy.deepcopy(model).cpu(), "cpu")
    cpu_rows = []
    for k, img in enumerate(images[:TREE_CPU_IMAGES]):
        t0 = time.perf_counter()
        r = cpu.compress_decompress(img[None].astype("float32") / 255.0)
        cpu_rows.append({"image": k, "bpp": r.bpp, "psnr": r.psnr,
                         "wall_s": time.perf_counter() - t0})
    profile_round_trip(torch, coder, images[1], f"{key}_bitstream_profile")
    res = {"phase": f"{key}_bitstream", "entropy_layer": el,
           "dtype": "float32", "images": [n, 3, size, size], "fit": fit,
           "cpu_count": os.cpu_count(),
           "mean_bpp": mean(rows, "bpp"), "mean_psnr_db": mean(rows, "psnr"),
           "mean_likelihood_bpp": mean(rows, "likelihood_bpp"),
           "mean_eval_step_bpp": mean(rows, "eval_step_bpp"),
           "max_bpp_rel_gap": max(abs(r["bpp"] - r["likelihood_bpp"])
                                  / r["likelihood_bpp"] for r in rows),
           "max_bpp_rel_gap_to_eval_step": max(
               abs(r["bpp"] - r["eval_step_bpp"]) / r["eval_step_bpp"]
               for r in rows),
           "cpu": cpu_rows,
           "cpu_max_bpp_rel_gap": max(abs(c["bpp"] - r["bpp"]) / r["bpp"]
                                      for c, r in zip(cpu_rows, rows)),
           "cpu_max_psnr_gap_db": max(abs(c["psnr"] - r["psnr"])
                                      for c, r in zip(cpu_rows, rows)),
           "launches_per_image": want,
           "first_image_s": rows[0]["wall_s"],
           **{f"mean_{k}": mean(rows, k, skip=1) for k in (
               "wall_s", "encode_s", "decode_s", "analysis_card_ms",
               "synthesis_card_ms", "encode_host_ms", "decode_host_ms",
               "coded_mp_per_s")},
           "per_image": [{k: r[k] for k in ("bpp", "likelihood_bpp",
                                            "eval_step_bpp", "psnr",
                                            "wall_s")} for r in rows]}
    emit(res)
    if not res["max_bpp_rel_gap"] <= TREE_REAL_BPP_RTOL:
        raise AssertionError(f"{key}_bitstream: real rate off the "
                             "likelihood rate")
    if not res["cpu_max_bpp_rel_gap"] <= TARGET_BPP_RTOL \
            or not res["cpu_max_psnr_gap_db"] <= TARGET_PSNR_TOL:
        raise AssertionError(f"{key}_bitstream: card and CPU disagree")
    return res, coder, images


def phase_coding_many(torch, pkg, counts, coder, images, key):
    """``compress_decompress_many`` over ``CODING_MANY`` images at workers 1
    and 2 on one coder: the streams of sequential coding, byte for byte,
    and s/image at each setting. Launches are gated at one worker; at two,
    the images' threads add to the module counters at once, so their sum
    is reported only."""
    batches = [img[None].astype("float32") / 255.0
               for img in images[:CODING_MANY]]
    t0 = time.perf_counter()
    seq = [coder.compress_decompress(b) for b in batches]
    seq_s = time.perf_counter() - t0
    res = {"phase": "coding_many", "entropy_layer": coder.cfg.entropy_layer,
           "model": key, "images": [len(batches), 3, *images[0].shape[:2]],
           "cpu_count": os.cpu_count(), "sequential_s": seq_s}
    for workers in (1, 2):
        counts.reset()
        t0 = time.perf_counter()
        out = coder.compress_decompress_many(batches, workers=workers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.read()
        same = [[(s.xe, s.xo) for s in a.streams]
                == [(s.xe, s.xo) for s in b.streams]
                for a, b in zip(out, seq)]
        res[f"workers_{workers}"] = {
            "wall_s": wall, "s_per_image": wall / len(batches),
            "identical_streams": sum(same), "launches": launches}
        if not all(same) or len(out) != len(seq):
            emit(res)
            raise AssertionError(f"coding_many: workers {workers} streams "
                                 "differ from sequential coding")
        if workers == 1:
            expect_launches(launches, {k: len(batches) * v for k, v in
                                       reckon_coding(coder.cfg).items()},
                            "coding_many workers 1")
    emit(res)
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
    """The ladder kernels along one axis in their four uses against the
    plain versions at every distinct shape of the passes that would make up
    the levels of the CDF97 eval and train paths and at ``bench_pallas.py``'s
    shapes, along the dim each pass lifts (both dims for the bench shapes);
    the adjoint identities; times. Returns one row per shape and use."""
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
                       "passes_a_level_set_eval": eval_keys.get(
                           (shape, dim), 0) if use in ("F", "I") else 0,
                       "passes_a_level_set_train": train_keys.get(
                           (shape, dim), 0) if use != "F_T" else 0,
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


def library_level_analysis(F, x, wa):
    """The level as the conv yardstick: the strided conv along H, then along
    W of both row bands -> (N*C, 2 [H parity], h/2, 2 [W parity], w/2)."""
    nc, h, w = x.shape[0] * x.shape[1], x.shape[2], x.shape[3]
    rows = library_analysis(F, x, 2, wa)             # (N*C, 2, h/2, w)
    cols = library_analysis(F, rows.reshape(nc * 2, 1, h // 2, w), 3, wa)
    return cols.reshape(nc, 2, h // 2, 2, w // 2)


def library_level_synthesis(torch, F, ll, pack, ws, r0):
    """The synthesis level as the yardstick: the strided transposed conv
    along W of each row band, then along H."""
    b, c, oh, ow = ll.shape
    lh, hl, hh = (pack.reshape(b, c, 3, oh, ow)[:, :, k] for k in range(3))
    low = library_synthesis(torch, F, ll, hl, 3, ws, r0).reshape(
        b, c, oh, 2 * ow)
    high = library_synthesis(torch, F, lh, hh, 3, ws, r0).reshape(
        b, c, oh, 2 * ow)
    return library_synthesis(torch, F, low, high, 2, ws, r0).reshape(
        b, c, 2 * oh, 2 * ow)


def three_pass_analysis(lift, dwt, x, ladder):
    """The level as the port ran it before the level kernel: three launches
    along one axis, then the pack's copy."""
    lo, hi = lift.launch_analysis(x, 2, ladder)
    ll, hl = lift.launch_analysis(lo, 3, ladder)
    lh, hh = lift.launch_analysis(hi, 3, ladder)
    return ll, dwt.pack_details(lh, hl, hh)


def three_pass_synthesis(lift, dwt, ll, pack, ladder):
    lh, hl, hh = (t.contiguous() for t in dwt.unpack_details(pack))
    low = lift.launch_synthesis(ll, hl, 3, ladder)
    high = lift.launch_synthesis(lh, hh, 3, ladder)
    return lift.launch_synthesis(low, high, 2, ladder)


def phase_lift97_level(torch, F, lift, dwt, cfg):
    """The level kernels (one launch a 2-D level each way) in their four
    uses at every level of the CDF97 eval (B=8 512x768) and train (B=4
    256x256) paths against the plain level, the adjoint identities, and
    times: events, device, host, the three-pass form, plain, yardstick.
    Returns one row per level shape and use."""
    wa, ws, r0 = ladder_filters(torch, lift)
    wa, ws = wa.to(DEV), ws.to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(3)
    t = lambda fn: time_ms(fn, torch, min_ms=20.0)  # noqa: E731
    shapes = [("eval", s) for s in level_shapes(cfg.dwtlevels, B, H, W)] \
        + [("train", s) for s in level_shapes(cfg.dwtlevels, CDF97_TRAIN_B,
                                              TRAIN_P, TRAIN_P)]
    on_path = {"eval": ("F", "I"), "train": ("F", "I_T", "I")}
    rows = []
    for path, shape in shapes:
        b, c, h, w = shape
        x = torch.randn(shape, device=DEV, generator=gen)
        ll = torch.randn((b, c, h // 2, w // 2), device=DEV, generator=gen)
        pack = torch.randn((b, 3 * c, h // 2, w // 2), device=DEV,
                           generator=gen)
        n = x.numel()
        # each fp32 sample read once and written once; 7 flops a sample on
        # each axis. The one-axis bound counted the row bands' round trip:
        # 8 bytes a sample of each of the three passes' inputs
        t_bytes = 2 * n * 4 / PEAK_BYTES * 1e3
        t_ops = 14 * n / PEAK_FLOPS["float32"] * 1e3
        with torch.no_grad():
            got = {"F": lift.launch_level_analysis(x, lift.FORWARD),
                   "I_T": lift.launch_level_analysis(x, lift.INVERSE_T),
                   "I": (lift.launch_level_synthesis(ll, pack, lift.INVERSE),),
                   "F_T": (lift.launch_level_synthesis(ll, pack,
                                                       lift.FORWARD_T),)}
            torch.cuda.synchronize()
            fx, (fty,), (ix,), itx = (got[k] for k in ("F", "F_T", "I", "I_T"))
            adjoint = {
                "F": abs(fdot(fx[0], ll) + fdot(fx[1], pack) - fdot(x, fty))
                / (fnorm(fx) * fnorm((ll, pack))),
                "I": abs(fdot(ix, x) - fdot(ll, itx[0]) - fdot(pack, itx[1]))
                / (fnorm((ix,)) * fnorm((x,)))}
            want_ll, want_pack = dwt.level_analysis_plain(x, lift.FORWARD)
            lib_a = library_level_analysis(F, x, wa)
            lib_s = library_level_synthesis(torch, F, ll, pack, ws, r0)
            lh, hl, hh = dwt.unpack_details(want_pack)
            lib_err = max(
                rel_err(lib_a[:, 0, :, 0].reshape(ll.shape), want_ll),
                rel_err(lib_a[:, 0, :, 1].reshape(ll.shape), hl),
                rel_err(lib_a[:, 1, :, 0].reshape(ll.shape), lh),
                rel_err(lib_a[:, 1, :, 1].reshape(ll.shape), hh),
                rel_err(lib_s, dwt.level_synthesis_plain(ll, pack)))
            del lib_a, lib_s, lh, hl, hh, want_ll, want_pack
            lib_ms = {
                "analysis": t(lambda: library_level_analysis(F, x, wa)),
                "synthesis": t(lambda: library_level_synthesis(
                    torch, F, ll, pack, ws, r0))}
            for use, ladder in (("F", lift.FORWARD), ("I_T", lift.INVERSE_T),
                                ("I", lift.INVERSE),
                                ("F_T", lift.FORWARD_T)):
                analysis = use in ("F", "I_T")
                if analysis:
                    want = dwt.level_analysis_plain(x, ladder)
                    run = lambda: lift.launch_level_analysis(  # noqa: E731
                        x, ladder)
                    three = lambda: three_pass_analysis(  # noqa: E731
                        lift, dwt, x, ladder)
                    plain = lambda: dwt.level_analysis_plain(  # noqa: E731
                        x, ladder)
                else:
                    want = (dwt.level_synthesis_plain(ll, pack, ladder),)
                    run = lambda: lift.launch_level_synthesis(  # noqa: E731
                        ll, pack, ladder)
                    three = lambda: three_pass_synthesis(  # noqa: E731
                        lift, dwt, ll, pack, ladder)
                    plain = lambda: dwt.level_synthesis_plain(  # noqa: E731
                        ll, pack, ladder)
                abs_err = max((g - w_).abs().max().item()
                              for g, w_ in zip(got[use], want))
                rel = max(rel_err(g, w_) for g, w_ in zip(got[use], want))
                three_out = three()
                three_out = three_out if analysis else (three_out,)
                three_err = max(rel_err(g, w_)
                                for g, w_ in zip(three_out, want))
                del want, three_out
                dev_us, dev_src = device_us(torch, run, "level_kernel")
                three_us, three_src = device_us(torch, three)
                ms = t(run)
                row = {"phase": "lift97_level", "use": use,
                       "kernel": "lift97" if analysis else "ilift97",
                       "path": path, "x": list(shape),
                       "plan": lift.launch_plan(
                           not analysis, "hw", b * c, h, w)._asdict(),
                       "launches_eval_step": int(path == "eval"
                                                 and use in on_path["eval"]),
                       "launches_train_step": int(
                           path == "train" and use in on_path["train"]),
                       "max_abs_err": abs_err, "max_rel_err": rel,
                       "three_pass_rel_err": three_err,
                       "ms": ms, "device_ms": dev_us / 1e3,
                       "device_source": dev_src,
                       "host_us": host_us(torch, run),
                       "three_pass_ms": t(three),
                       "three_pass_device_ms": three_us / 1e3,
                       "three_pass_device_source": three_src,
                       "plain_ms": t(plain),
                       "library_ms": lib_ms["analysis" if analysis
                                            else "synthesis"],
                       "library_rel_err": lib_err,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations",
                       "bound_1d_ms": 2 * t_bytes,
                       "gb_per_s": 2 * n * 4 / dev_us / 1e3,
                       "gb_per_s_events": 2 * n * 4 / ms / 1e6,
                       "adjoint_err": adjoint.get(use)}
                emit(row)
                rows.append(row)
                if not (rel <= LADDER_TOL and three_err <= LADDER_TOL):
                    raise AssertionError(
                        f"lift97 level {use} {shape}: error {rel:.3e} "
                        f"(three passes {three_err:.3e}) > {LADDER_TOL}")
            if not max(adjoint.values()) <= ADJOINT_TOL:
                raise AssertionError(f"lift97 level {shape}: adjoint "
                                     f"identity off by {adjoint}")
            if not lib_err <= LIBRARY_TOL:
                raise AssertionError(f"the level's conv yardstick is off by "
                                     f"{lib_err}")
            del got, fx, fty, ix, itx
        del x, ll, pack
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
    batch = eval_batch(torch, np, pkg)
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
    likelihood rate, 8 ladder launches an image."""
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


# --- quincunx integer lifting and the other transforms -----------------------

def quincunx_config(pkg, lam=400.0, **kw):
    return pkg.config.Config(**dict(QUINCUNX, lambda_=lam, **kw)).validate()


def quincunx_model(pkg, cfg, name="quincunx_lam400"):
    """The quincunx codec with a committed snapshot's weights."""
    model = pkg.codec.CodecWrapper(cfg)
    pkg.weights.load_flax_params(model, pkg.weights.load_npz(os.path.join(
        HERE, "results", "ckpt_snapshots", f"{name}.npz")))
    return model


def quincunx_conv_shapes(cfg, size=None):
    """Distinct (h, w, cin, cout) of the quincunx P/U nets' 3x3 convs on
    H x W images, each with its launches a step: per level a horizontal
    lifting net on the (H, W/2) halves and two vertical ones on the
    (H/2, W/2) quarters, each with ``2 * num_lifting_perlayer`` P/U nets of
    two convs (C -> hidden, hidden -> C), in the analysis and again in the
    synthesis."""
    if cfg.split_mode != "hv":
        raise ValueError("the reckoning knows the 'hv' split only")
    height, width = size or (H, W)
    c = cfg.clrch
    hid = min(c * 32, max(128, c))
    per_net = 2 * cfg.num_lifting_perlayer
    counts = {}
    for lvl in range(cfg.dwtlevels):
        h, w = height >> lvl, width >> lvl
        for hh, ww, nets in ((h, w // 2, 1), (h // 2, w // 2, 2)):
            for pair in ((c, hid), (hid, c)):
                key = (hh, ww, *pair)
                counts[key] = counts.get(key, 0) + 2 * per_net * nets
    return counts


def quincunx_first_layer(cfg, size):
    """The shape of the one conv of a train step whose input is the image
    (the level-0 horizontal prediction's first layer): it takes no dx."""
    h, w = size
    return (h, w // 2, cfg.clrch, min(cfg.clrch * 32, max(128, cfg.clrch)))


def reckon_quincunx(cfg, train=False, size=None):
    """Kernel 1's launches of one quincunx step or image: every P/U conv
    forward; in training a dx for each but the first layer, which sees the
    image."""
    n = sum(quincunx_conv_shapes(cfg, size).values())
    if train:
        return launches_of(conv=2 * n - 1, conv_dx=n - 1)
    return launches_of(conv=n)


def reckon_quincunx_agent(cfg, n_valid):
    t, e = reckon_quincunx(cfg, True), reckon_quincunx(cfg)
    steps, epochs = cfg.steps_per_epoch, cfg.max_epoch
    return launches_of(conv=epochs * (steps * t["conv3x3_halo"]
                                      + n_valid * e["conv3x3_halo"]),
                       conv_dx=epochs * steps * t["conv3x3_halo_dx"])


def eval_batch(torch, np, pkg):
    """B=8 seeded 512x768 images on the card (phase main's batch)."""
    imgs = pkg.data.synthetic_natural_images(B, W, seed=0)
    batch = torch.from_numpy(np.stack(imgs)[:, :H]).permute(0, 3, 1, 2)
    return batch.float().div(255.0).to(DEV)


def rel_gap(a, b) -> float:
    """|a - b| / |b|; a term that is 0 on both sides (the factorized
    model's rate1) agrees."""
    return 0.0 if a == b else abs(a - b) / abs(b) if b else float("inf")


def card_vs_cpu_eval(torch, pkg, cfg, cpu_model, counts, name):
    """The eval step on one 256x256 image on the card and on the CPU: the RD
    terms, xhat, the subbands' rounded values (the symbols up to the
    bottlenecks' medians), launches on the card."""
    img = pkg.data.synthetic_natural_images(1, 256, seed=0)[0]
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0
    gpu_model = copy.deepcopy(cpu_model)
    want, want_xhat = pkg.state.make_eval_step(cfg, cpu_model, "cpu")(x)
    step = pkg.state.make_eval_step(cfg, gpu_model, DEV)
    counts.reset()
    got, got_xhat = step(x)
    torch.cuda.synchronize()
    launches = counts.read()
    with torch.inference_mode():
        subs = [m.codec.transform.encode(d(x) - 0.5) for m, d in (
            (cpu_model, lambda t: t), (gpu_model, lambda t: t.to(DEV)))]
    flat = [torch.cat([s[0].flatten().cpu()] + [t.flatten().cpu()
                                                for t in s[1]])
            for s in subs]
    d = (got_xhat.cpu() - want_xhat).abs()
    res = {"phase": name, "image": [1, 3, 256, 256], "dtype": "float32",
           "launches": launches, "xhat_max_abs_err": d.max().item(),
           "xhat_mean_abs_err": d.mean().item(),
           "subband_equal_share": (flat[0] == flat[1]).double().mean().item(),
           "subband_rounded_equal_share":
           (flat[0].round() == flat[1].round()).double().mean().item()}
    for k in ("loss", "mse", "rate1", "rate2"):
        a, b = float(getattr(got, k)), float(getattr(want, k))
        res[k] = {"card": a, "cpu": b, "rel_err": rel_gap(a, b)}
    del gpu_model, step
    return res


def card_vs_cpu_train(torch, np, pkg, cfg, make_model, counts):
    """One fp32 train step on the card and on the CPU from the same weights
    and batch, the noise (bottlenecks' and integer lifting's) drawn from
    one CPU generator with one seed on both: RD terms, every gradient
    tensor (max |d| / max |g| a tensor, the worst, and the L2 of all
    differences together), launches."""
    batch = train_batch(torch, np, pkg, PARITY_B, PARITY_P, seed=2)
    results = {}
    for dev in ("cpu", DEV):
        model = make_model()
        tstep = pkg.state.make_train_step(
            cfg, model, pkg.state.make_optimizer(cfg, model), dev)
        counts.reset()
        out, _ = tstep(batch, torch.Generator().manual_seed(3), TRAIN_LR, 1.0)
        if dev != "cpu":
            torch.cuda.synchronize()
        results[dev] = (out, counts.read(),
                        {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()})
        del model, tstep
    (want, cpu_counts, want_g), (got, launches, got_g) = (results["cpu"],
                                                          results[DEV])
    tr = {"batch": [PARITY_B, 3, PARITY_P, PARITY_P], "launches": launches,
          "cpu_launches": cpu_counts}
    for k in ("loss", "mse", "rate1", "rate2"):
        a, b = float(getattr(got, k)), float(getattr(want, k))
        tr[k] = {"card": a, "cpu": b, "rel_err": rel_gap(a, b)}
    errs = {n: rel_err(got_g[n], want_g[n]) for n in want_g
            if want_g[n].abs().max() > 0}
    worst = max(errs, key=errs.get)
    l2 = (sum(float((got_g[n] - want_g[n]).double().pow(2).sum())
              for n in want_g)
          / sum(float(want_g[n].double().pow(2).sum()) for n in want_g)) ** 0.5
    tr.update(grad_tensors=len(errs), grad_worst=worst,
              grad_worst_rel_err=errs[worst],
              grad_tensors_over_1e_3=sum(e > 1e-3 for e in errs.values()),
              grad_l2_rel_err=l2)
    return tr


def parity_faults(res, xhat_mean_tol, dist_rtol=PARITY_RTOL):
    """The gates a card-vs-CPU result misses: the eval step's rates within
    PARITY_RTOL, its loss and mse within ``dist_rtol``, xhat's mean |d|;
    the train step's RD terms and gradients as the flagship's."""
    bad = [k for k in ("rate1", "rate2")
           if not res[k]["rel_err"] <= PARITY_RTOL]
    bad += [k for k in ("loss", "mse") if not res[k]["rel_err"] <= dist_rtol]
    if not res["xhat_mean_abs_err"] <= xhat_mean_tol:
        bad.append("xhat")
    tr = res["train"]
    bad += [f"train {k}" for k in ("loss", "mse", "rate1", "rate2")
            if not tr[k]["rel_err"] <= PARITY_RTOL]
    if not tr["grad_worst_rel_err"] <= GRAD_TOL \
            or not tr["grad_l2_rel_err"] <= GRAD_L2_TOL:
        bad.append(f"gradient {tr['grad_worst']}")
    return bad


def phase_quincunx_parity(torch, np, pkg, counts):
    """The quincunx codec in fp32 with the lambda=400 snapshot, card vs CPU:
    the eval step on one 256x256 image (rates, the distortion terms and
    xhat's mean |d| at QUINCUNX_DIST_RTOL / QUINCUNX_XHAT_MEAN_TOL, the
    share of equal rounded subband elements: a value within an ulp of a
    1/255 grid boundary may round the other way, so no maximum is gated),
    then one train step, its noise from one CPU generator on both
    (gradients 1e-2 a tensor, 1e-3 on the L2, as the flagship's; training
    adds noise, so nothing rounds there)."""
    cfg = quincunx_config(pkg)
    res = card_vs_cpu_eval(torch, pkg, cfg, quincunx_model(pkg, cfg), counts,
                           "quincunx_parity")
    res["train"] = card_vs_cpu_train(torch, np, pkg, cfg,
                                     lambda: quincunx_model(pkg, cfg), counts)
    emit(res)
    bad = parity_faults(res, QUINCUNX_XHAT_MEAN_TOL, QUINCUNX_DIST_RTOL)
    if not res["subband_rounded_equal_share"] >= SUBBAND_EQUAL_SHARE:
        bad.append("subbands")
    if bad:
        raise AssertionError(f"quincunx card and CPU disagree: {bad}")
    expect_launches((res["launches"], res["train"]["cpu_launches"],
                     res["train"]["launches"]),
                    (reckon_quincunx(cfg), launches_of(),
                     reckon_quincunx(cfg, True)),
                    "quincunx parity (eval card, train cpu, train card)")
    return res


def phase_quincunx_kernel(torch, F, conv, pkg):
    """Kernel 1 at every quincunx shape: forward at the B=8 512x768 eval
    step's, forward, dx and dk at the B=8 256x256 train step's (launched
    directly, fp32), each against its plain version, with its time, cuDNN
    fp32's (TF32 off) and the bound."""
    cfg = quincunx_config(pkg)
    rows = phase_kernel(torch, F, conv, cfg, quincunx_conv_shapes(cfg),
                        "quincunx_kernel")
    size = (TRAIN_P, TRAIN_P)
    bwd = phase_kernel_bwd(torch, conv, cfg, quincunx_conv_shapes(cfg, size),
                           "quincunx_kernel_bwd",
                           no_dx=(quincunx_first_layer(cfg, size),))
    return rows, bwd


def timed_steps(torch, run, steps):
    """``steps`` calls of ``run`` each ended by a synchronize: host ms."""
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_quincunx_main(torch, np, pkg, counts):
    """The quincunx codec (lambda=400 snapshot, fp32, TF32 off): the eval
    step at B=8 512x768 (ms, MP/s, bpp, PSNR, kernel 1's launches against
    the reckoning, one step profiled), then the train step at B=8 256x256,
    Adam at lr 1e-4 (2 warm-up and ``QUINCUNX_TRAIN_STEPS`` timed, launches,
    peak memory, one step profiled)."""
    cfg = quincunx_config(pkg, learning_rate=TRAIN_LR)
    batch = eval_batch(torch, np, pkg)
    step = pkg.state.make_eval_step(cfg, quincunx_model(pkg, cfg), DEV)
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    outs = []
    counts.reset()
    ms = timed_steps(torch, lambda: outs.append(step(batch)), STEPS)
    launches = counts.read()
    expect_launches(launches, {k: STEPS * v for k, v in
                               reckon_quincunx(cfg).items()},
                    f"{STEPS} quincunx eval steps")
    out, xhat = outs[-1]
    bpp, psnr = float(out.rate1 + out.rate2), float(
        pkg.loss.psnr(batch - 0.5, xhat))
    if not all(math.isfinite(v) for v in (bpp, psnr, float(out.loss))) \
            or tuple(xhat.shape) != (B, 3, H, W):
        raise AssertionError(f"quincunx eval: bpp {bpp} psnr {psnr}")
    mean_ms = sum(ms) / len(ms)
    res = {"phase": "quincunx_main", "config": "quincunx_lam400",
           "dtype": "float32", "batch": [B, 3, H, W], "steps": STEPS,
           "bpp": bpp, "psnr_db": psnr, "loss": float(out.loss),
           "ms_per_step": mean_ms, "ms_per_step_min": min(ms),
           "ms_per_step_all": ms, "mp_per_s": B * H * W / 1e3 / mean_ms,
           "warmup_s": warm_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "reckoned_per_step": reckon_quincunx(cfg)}
    del outs, out, xhat
    phase_profile(torch, lambda: step(batch), mean_ms, "quincunx_profile")
    del step, batch
    torch.cuda.empty_cache()

    tbatch = train_batch(torch, np, pkg, TRAIN_B, TRAIN_P, seed=1).to(DEV)
    model = quincunx_model(pkg, cfg)
    tstep = pkg.state.make_train_step(
        cfg, model, pkg.state.make_optimizer(cfg, model), DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    touts = []

    def run_step():
        touts.append(tstep(tbatch, gen, TRAIN_LR, 1.0)[0])

    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        run_step()
    torch.cuda.synchronize()
    twarm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    tms = timed_steps(torch, run_step, QUINCUNX_TRAIN_STEPS)
    tlaunches = counts.read()
    reck = reckon_quincunx(cfg, True, (TRAIN_P, TRAIN_P))
    expect_launches(tlaunches, {k: QUINCUNX_TRAIN_STEPS * v
                                for k, v in reck.items()},
                    f"{QUINCUNX_TRAIN_STEPS} quincunx train steps")
    losses = [float(o.loss) for o in touts]
    if not all(math.isfinite(v) for v in losses) or not all(
            torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f"quincunx train: loss {losses}")
    tmean = sum(tms) / len(tms)
    res["train"] = {"batch": [TRAIN_B, 3, TRAIN_P, TRAIN_P], "lr": TRAIN_LR,
                    "warmup_steps": TRAIN_WARMUP,
                    "steps": QUINCUNX_TRAIN_STEPS, "ms_per_step": tmean,
                    "ms_per_step_min": min(tms), "ms_per_step_all": tms,
                    "mp_per_s": TRAIN_B * TRAIN_P * TRAIN_P / 1e3 / tmean,
                    "loss": losses, "warmup_s": twarm_s,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": tlaunches, "reckoned_per_step": reck}
    emit(res)
    phase_profile(torch, run_step, tmean, "quincunx_train_profile")
    del tstep, model, touts
    torch.cuda.empty_cache()
    return res


def phase_quincunx_bitstream(torch, np, pkg, counts):
    """The real bitstream in fp32 of both quincunx snapshots over the 19
    dead-leaves images of the held-out set, one at a time: every plane
    decodes bit for bit (the coder raises otherwise), each image's bpp and
    PSNR within 0.5 % and 0.02 dB of the JAX package's CPU coding
    (``results/port_quincunx_targets.json``), the means beside
    ``results/rd_quincunx.json``'s rows of those images, s/image split into
    card and host. Then integer lifting on the card: the lambda=400
    snapshot's lifting nets alone map grid-valued images to subbands and
    back (the share of pixels back on their grid value), the subbands and
    the synthesis give the same bits twice, and one stream decodes to the
    same bits twice."""
    n, size, seed = BITSTREAM_IMAGES
    images = pkg.data.synthetic_natural_images(n, size, seed=seed)
    with open(QUINCUNX_TARGETS) as fh:
        targets = json.load(fh)["points"]
    with open(RD_QUINCUNX) as fh:
        rd = json.load(fh)
    names = sorted(rd["eval_set"])
    res = {"phase": "quincunx_bitstream", "dtype": "float32",
           "images": [n, 3, size, size], "points": {}}
    bad = []
    for name, lam in QUINCUNX_SNAPSHOTS.items():
        cfg = quincunx_config(pkg, lam)
        coder = pkg.codec_coder.CodecCoder(cfg, quincunx_model(pkg, cfg, name),
                                           DEV)
        rows = code_images(torch, pkg, counts, coder, images,
                           reckon_quincunx(cfg), f"quincunx_bitstream {name}")
        want = targets[name]["per_image"]
        rd_rows = [r for nm, r in zip(names,
                                      rd["points"][str(int(lam))]["per_image"])
                   if nm.startswith(f"natural_{seed}_")]
        for r, t in zip(rows, want):
            r["target_bpp"], r["target_psnr"] = t["bpp"], t["psnr"]
            if not abs(r["bpp"] - t["bpp"]) <= TARGET_BPP_RTOL * t["bpp"] \
                    or not abs(r["psnr"] - t["psnr"]) <= TARGET_PSNR_TOL:
                bad.append((name, r["image"]))
        res["points"][name] = {
            "mean_bpp": mean(rows, "bpp"), "mean_psnr_db": mean(rows, "psnr"),
            "target_mean_bpp": mean(want, "bpp"),
            "target_mean_psnr_db": mean(want, "psnr"),
            "max_bpp_rel_gap": max(abs(r["bpp"] - r["target_bpp"])
                                   / r["target_bpp"] for r in rows),
            "max_psnr_gap_db": max(abs(r["psnr"] - r["target_psnr"])
                                   for r in rows),
            "rd_quincunx_rows_mean_bpp": mean(rd_rows, "bpp"),
            "rd_quincunx_rows_mean_psnr_db": mean(rd_rows, "psnr"),
            "launches_per_image": reckon_quincunx(cfg),
            "first_image_s": rows[0]["wall_s"],
            **{f"mean_{k}": mean(rows, k, skip=1) for k in (
                "wall_s", "encode_s", "decode_s", "analysis_card_ms",
                "synthesis_card_ms", "encode_host_ms", "decode_host_ms",
                "coded_mp_per_s")},
            "per_image": [{k: r[k] for k in ("bpp", "target_bpp", "psnr",
                                             "target_psnr", "wall_s")}
                          for r in rows]}

    # integer lifting on the card, the lambda=400 snapshot's nets alone
    cfg = quincunx_config(pkg, autoencoder="none")
    tr = pkg.codec.CodecWrapper(cfg).codec.transform
    snap = pkg.weights.state_dict_from_flax(pkg.weights.load_npz(os.path.join(
        HERE, "results", "ckpt_snapshots", "quincunx_lam400.npz")))
    tr.load_state_dict({k[len("codec.transform."):]: v for k, v in snap.items()
                        if k.startswith("codec.transform.layers_")})
    tr.to(DEV)
    grid = torch.from_numpy(np.stack(images[:2])).permute(0, 3, 1, 2)
    grid = (grid.float() / 255.0).to(DEV)
    with torch.inference_mode():
        a = tr.encode(grid)
        b = tr.encode(grid)
        back = tr.decode(*a)
        same = all(torch.equal(u, v) for u, v in zip([a[0]] + a[1],
                                                     [b[0]] + b[1])) \
            and torch.equal(back, tr.decode(*b))
    d = (back - grid).abs()
    exact = (d <= 1e-6).double().mean().item()
    err = d.max().item()
    # one stream of the last snapshot's coder, decoded twice
    plane = torch.from_numpy(images[0]).permute(2, 0, 1)[None].float()
    streams, _, xe_hat, xo_hats = coder.compress_plane(
        0, (plane / 255.0 - 0.5).to(DEV))
    shapes = (xe_hat.shape, [t.shape for t in xo_hats])
    twice = np.array_equal(coder.decompress_plane(0, streams, *shapes),
                           coder.decompress_plane(0, streams, *shapes))
    res["integer_lifting"] = {"images": 2, "same_bits_twice": same,
                              "round_trip_exact_share": exact,
                              "round_trip_max_abs_err": err,
                              "stream_decodes_twice_equal": twice}
    emit(res)
    if bad:
        raise AssertionError(f"quincunx_bitstream: images {bad} off the JAX "
                             f"targets (bpp {TARGET_BPP_RTOL}, psnr "
                             f"{TARGET_PSNR_TOL} dB)")
    if not (same and exact >= GRID_EXACT_SHARE and twice):
        raise AssertionError(f"quincunx integer lifting on the card: "
                             f"{res['integer_lifting']}")
    return res


def phase_quincunx_agent(torch, pkg, counts):
    """The CLI on a temporary JSON of the quincunx preset (batch 2, patch
    64, 2 epochs of 2 steps), then ``--resume-training``, then ``mode:
    test``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "quincunx.json")
        with open(path, "w") as fh:
            json.dump(dict(QUINCUNX, exp_name="quincunx", lambda_=400.0),
                      fh)
        return phase_agent(torch, pkg, counts, path, QUINCUNX_AGENT,
                           reckon_quincunx_agent, reckon_coding,
                           "quincunx_agent")


def alt_config(pkg, net):
    return pkg.config.Config(netType=net, entropy_layer="factorized",
                             autoencoder="SubbandAutoEncoder", clrch=3,
                             dwtlevels=4, linearity_flag=1, lambda_=400.0,
                             learning_rate=TRAIN_LR).validate()


def reckon_alt(cfg, train=False):
    """The ladder's launches of one step or image of BasicWavelet (none) or
    an attention transform (one level kernel a 2-D level each way; the
    train step's backward adds the adjoint of the synthesis)."""
    if cfg.netType == "BasicWavelet":
        return launches_of()
    lift_n, ilift_n = ladder_launches(cfg, train)
    return launches_of(lift=lift_n, ilift=ilift_n)


def phase_alt_transforms(torch, np, pkg, counts):
    """BasicWavelet (``linearity_flag`` 1), AttentionWavelet and
    AttentionWaveletPostProcessing with the factorized model, joint RGB, 4
    levels, seeded weights, fp32 (TF32 off): card vs CPU on one 256x256
    image and one train step (as the quincunx parity), the B=8 512x768 eval
    step timed with the ladder kernels' launches gated, one train step on
    the card, and the real bitstream of two 256x256 images (lossless, the
    coder raises otherwise)."""
    out = {}
    batch = eval_batch(torch, np, pkg)
    images = pkg.data.synthetic_natural_images(ALT_BITSTREAM_IMAGES, 256,
                                               seed=5)
    for key, net in ALT_TRANSFORMS:
        cfg = alt_config(pkg, net)

        def make():
            return pkg.codec.CodecWrapper(
                cfg, generator=torch.Generator().manual_seed(ALT_SEED))

        with tf32_off(torch, deterministic=True):
            res = card_vs_cpu_eval(torch, pkg, cfg, make(), counts,
                                   f"alt_{key}")
            res["train"] = card_vs_cpu_train(torch, np, pkg, cfg, make,
                                             counts)
        bad = parity_faults(res, XHAT_MEAN_TOL)
        model = make()
        step = pkg.state.make_eval_step(cfg, model, DEV)
        step(batch)
        torch.cuda.synchronize()
        outs = []
        counts.reset()
        ms = timed_steps(torch, lambda: outs.append(step(batch)), STEPS)
        launches = counts.read()
        o, xhat = outs[-1]
        bpp, psnr = float(o.rate1 + o.rate2), float(
            pkg.loss.psnr(batch - 0.5, xhat))
        mean_ms = sum(ms) / len(ms)
        res.update(net=net, eval_batch=[B, 3, H, W], ms_per_step=mean_ms,
                   ms_per_step_all=ms, mp_per_s=B * H * W / 1e3 / mean_ms,
                   bpp=bpp, psnr_db=psnr, eval_launches=launches)
        del outs, o, xhat, step
        coder = pkg.codec_coder.CodecCoder(cfg, model, DEV)
        rows = code_images(torch, pkg, counts, coder, images,
                           reckon_alt(cfg), f"alt_{key} bitstream")
        res["bitstream"] = [{k: r[k] for k in ("bpp", "psnr", "wall_s",
                                               "analysis_card_ms",
                                               "synthesis_card_ms")}
                            for r in rows]
        emit(res)
        if bad or not all(math.isfinite(v) for v in (bpp, psnr)):
            raise AssertionError(f"alt_{key}: card and CPU disagree: {bad}")
        expect_launches(
            (res["launches"], res["train"]["launches"], launches),
            (reckon_alt(cfg), reckon_alt(cfg, True),
             {k: STEPS * v for k, v in reckon_alt(cfg).items()}),
            f"alt_{key} (parity eval, parity train, eval steps)")
        out[key] = dict(res, cfg=cfg)
        del model, coder
        torch.cuda.empty_cache()
    return out


# --- the postprocess stage, tiled coding, the fp32 defaults -------------------

def pp_config(pkg, kind="iwave", **kw):
    """The flagship config (lambda=2000, fp32) with the restoration net
    ``kind`` at ``resnetlevel`` 6 (iwave: width clrch * 64 = 64)."""
    return pkg.config.flagship_config(lambda_=2000.0, postprocess=kind,
                                      resnetlevel=PP_RESNETLEVEL, **kw)


def pp_net(torch, pkg, cfg):
    """The restoration net seeded as the agent seeds it (cfg.seed + 11)."""
    return pkg.postprocess.make_postprocess(cfg, torch.Generator().manual_seed(
        cfg.seed + pkg.pp_loop.SEED_OFFSET))


def pp_conv_shapes(cfg, b, h, w):
    """{(h, w, cin, cout): launches} of the kernel-1 convs (every stride-1,
    undilated 3x3) of ``cfg.postprocess``'s net on B x 3 x H x W images,
    read off one forward of the net on the meta device with the conv
    recorded (its other ops keep their shapes there)."""
    import torch
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
        postprocess)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        fast_conv)
    shapes = {}

    def record(x, wt, dtype):
        key = (x.shape[2], x.shape[3], x.shape[1], wt.shape[0])
        shapes[key] = shapes.get(key, 0) + 1
        return x.new_empty(x.shape[0], wt.shape[0], *x.shape[2:])

    real = fast_conv.conv3x3_halo
    fast_conv.conv3x3_halo = record
    try:
        net = postprocess.make_postprocess(cfg).to("meta")
        with torch.no_grad():
            net(torch.empty(b, 3, h, w, device="meta"), False)
    finally:
        fast_conv.conv3x3_halo = real
    return shapes


def pp_kernel_shapes(cfg, size):
    """Every restoration net's kernel-1 shapes on ``size`` images, each with
    its launches in one step of ``cfg.postprocess``'s net (0 for a shape
    only another net runs)."""
    path = pp_conv_shapes(cfg, 1, *size)
    out = {}
    for kind in PP_KINDS:
        other = type(cfg)(**{**cfg.__dict__, "postprocess": kind})
        for key in pp_conv_shapes(other, 1, *size):
            out[key] = path.get(key, 0)
    return out


def pp_first_layer(cfg, size):
    """The restoration net's first conv (its input, the codec's output,
    needs no gradient: no dx)."""
    return (*size, 3, cfg.clrch * 64)


def phase_pp_kernel(torch, F, conv, pkg):
    """Kernel 1 (launched directly) at every restoration-net shape: forward
    at B=8 512x768, forward, dx and dk at B=8 256x256, each against its
    plain version, with its time, cuDNN fp32's and the bound; launches a
    step are iwave's."""
    cfg = pp_config(pkg)
    rows = phase_kernel(torch, F, conv, cfg, pp_kernel_shapes(cfg, (H, W)),
                        "pp_kernel")
    size = (TRAIN_P, TRAIN_P)
    bwd = phase_kernel_bwd(torch, conv, cfg, pp_kernel_shapes(cfg, size),
                           "pp_kernel_bwd",
                           no_dx=(pp_first_layer(cfg, size),))
    return rows, bwd


def pp_launches(cfg, size, b=1, train=False):
    """Kernel-1 launches of one postprocess eval (or train) step of the
    flagship with ``cfg.postprocess``'s net: the frozen codec's forward and
    the net's forward, and in training the net's dx (all but its first
    layer; ``conv3x3_halo`` counts them too)."""
    n_pp = sum(pp_conv_shapes(cfg, b, *size).values())
    dx = n_pp - 1 if train else 0
    return launches_of(conv=sum(conv_shapes(cfg).values()) + n_pp + dx,
                       conv_dx=dx)


def phase_pp_parity(torch, np, pkg, counts):
    """Each restoration net, seeded, card vs CPU in fp32 on one seeded batch:
    the train-mode forward with its updated running statistics, then the
    eval forward with them; then one postprocess train step (the lambda=2000
    flagship frozen, iwave learning; the codec's noise from one CPU
    generator) card vs CPU: the loss terms and the net's gradients."""
    b, side = PP_PARITY
    x = train_batch(torch, np, pkg, b, side, seed=6)
    nets = {}
    for kind in PP_KINDS:
        cfg = pp_config(pkg, kind)
        cpu = pp_net(torch, pkg, cfg)
        card = copy.deepcopy(cpu).to(DEV)
        row, n = {}, sum(pp_conv_shapes(cfg, b, side, side).values())
        with torch.no_grad():
            for train in (True, False):
                want = cpu(x, train)
                counts.reset()
                got = card(x.to(DEV), train).cpu()
                torch.cuda.synchronize()
                expect_launches(counts.read(), launches_of(conv=n),
                                f"pp_parity {kind} forward")
                row["train" if train else "eval"] = rel_err(got - x, want - x)
        bufs = dict(cpu.named_buffers())
        row["running_stats"] = max(
            [rel_err(t.cpu(), bufs[k]) for k, t in card.named_buffers()],
            default=0.0)
        row["launches_per_forward"] = n
        nets[kind] = row

    cfg = pp_config(pkg)
    batch = train_batch(torch, np, pkg, PARITY_B, PARITY_P, seed=2)
    results = {}
    for dev in ("cpu", DEV):
        net = pp_net(torch, pkg, cfg)
        step = pkg.pp_loop.make_postprocess_train_step(
            cfg, load_model(cfg, pkg), net,
            torch.optim.Adam(net.parameters(), lr=pkg.pp_loop.LR), dev)
        counts.reset()
        out = step(batch, torch.Generator().manual_seed(3), pkg.pp_loop.LR)
        if dev != "cpu":
            torch.cuda.synchronize()
        results[dev] = (out, {k: p.grad.detach().cpu()
                              for k, p in net.named_parameters()},
                        counts.read())
    (want, want_g, _), (got, got_g, launches) = results["cpu"], results[DEV]
    errs, l2 = grad_gaps(got_g, want_g)
    worst = max(errs, key=errs.get)
    res = {"phase": "pp_parity", "nets": nets,
           "batch": [b, 3, side, side], "dtype": "float32",
           "train": {"batch": [PARITY_B, 3, PARITY_P, PARITY_P],
                     "launches": launches,
                     **{k: rel_gap(float(getattr(got, k)),
                                   float(getattr(want, k)))
                        for k in ("loss", "mse", "rate1", "rate2")},
                     "grad_tensors": len(errs), "grad_worst": worst,
                     "grad_worst_rel_err": errs[worst],
                     "grad_l2_rel_err": l2}}
    emit(res)
    bad = [k for k, r in nets.items()
           if not max(r["train"], r["eval"], r["running_stats"])
           <= PARITY_RTOL]
    bad += [k for k in ("loss", "mse", "rate1", "rate2")
            if not res["train"][k] <= PARITY_RTOL]
    if bad or not errs[worst] <= GRAD_TOL or not l2 <= GRAD_L2_TOL:
        raise AssertionError(f"pp_parity: card and CPU disagree: "
                             f"{bad or worst}")
    expect_launches(launches, pp_launches(cfg, (PARITY_P,) * 2, train=True),
                    "pp_parity train step")
    return res


def phase_pp_main(torch, np, pkg, counts):
    """The lambda=2000 flagship frozen with iwave: the restored eval step at
    B=8 512x768 (ms, MP/s, launches: the codec's 138 and iwave's 15 a
    step); the postprocess train step at B=8 256x256 (2 warm-up and
    ``PP_TRAIN_STEPS`` timed, launches, peak memory), one step profiled;
    then ``PP_CONVERGE`` train steps from the seeded init on batches of a
    seeded pool, the restored MSE of a held-out batch before and after (it
    must fall)."""
    cfg = pp_config(pkg)
    model = load_model(cfg, pkg)
    net = pp_net(torch, pkg, cfg)
    lr = pkg.pp_loop.LR
    step = pkg.pp_loop.make_postprocess_eval_step(cfg, model, net, DEV)
    batch = eval_batch(torch, np, pkg)
    step(batch)
    torch.cuda.synchronize()
    counts.reset()
    ms = timed_steps(torch, lambda: step(batch), STEPS)
    launches = counts.read()
    expect_launches(launches, {k: STEPS * v for k, v in pp_launches(
        cfg, (H, W), B).items()}, "pp_main eval steps")
    out = step(batch)
    codec_out, _ = pkg.state.make_eval_step(cfg, model, DEV)(batch)

    opt = torch.optim.Adam(net.parameters(), lr=lr)
    train = pkg.pp_loop.make_postprocess_train_step(cfg, model, net, opt, DEV)
    tb = train_batch(torch, np, pkg, TRAIN_B, TRAIN_P, seed=4).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)
    for _ in range(TRAIN_WARMUP):
        train(tb, gen, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    tms = timed_steps(torch, lambda: train(tb, gen, lr), PP_TRAIN_STEPS)
    tl = counts.read()
    expect_launches(tl, {k: PP_TRAIN_STEPS * v for k, v in pp_launches(
        cfg, (TRAIN_P, TRAIN_P), TRAIN_B, train=True).items()},
        "pp_main train steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase_profile(torch, lambda: train(tb, gen, lr), sum(tms) / len(tms),
                  "pp_train_profile")

    steps, cb, side = PP_CONVERGE
    fresh = pp_net(torch, pkg, cfg)
    conv_train = pkg.pp_loop.make_postprocess_train_step(
        cfg, model, fresh, torch.optim.Adam(fresh.parameters(), lr=lr), DEV)
    held_eval = pkg.pp_loop.make_postprocess_eval_step(cfg, model, fresh, DEV)
    pool = train_batch(torch, np, pkg, 8 * cb, side, seed=8).to(DEV)
    held = train_batch(torch, np, pkg, cb, side, seed=9).to(DEV)
    before = float(held_eval(held).mse)
    codec_mse = float(pkg.state.make_eval_step(cfg, model, DEV)(held)[0].mse)
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    mses = [float(conv_train(pool[torch.as_tensor(rng.choice(
        len(pool), cb, replace=False))], gen, lr).mse) for _ in range(steps)]
    converge_s = time.perf_counter() - t0
    after = float(held_eval(held).mse)
    psnr = lambda mse: -10.0 * math.log10(mse)  # noqa: E731
    res = {"phase": "pp_main", "config": "flagship_lam2000 + iwave",
           "postprocess": cfg.postprocess, "resnetlevel": cfg.resnetlevel,
           "pp_params": sum(p.numel() for p in net.parameters()),
           "eval": {"batch": [B, 3, H, W], "ms_per_step": sum(ms) / len(ms),
                    "ms_per_step_all": ms,
                    "mp_per_s": B * H * W / 1e6 / (sum(ms) / len(ms) / 1e3),
                    "launches": launches,
                    "restored_psnr_db": psnr(float(out.mse)),
                    "codec_psnr_db": psnr(float(codec_out.mse))},
           "train": {"batch": [TRAIN_B, 3, TRAIN_P, TRAIN_P],
                     "ms_per_step": sum(tms) / len(tms),
                     "ms_per_step_all": tms, "launches": tl,
                     "peak_mem_gb": peak_gb},
           "converge": {"steps": steps, "batch": [cb, 3, side, side],
                        "seconds": converge_s,
                        "train_mse_step_0": mses[0],
                        f"train_mse_step_{steps}": mses[-1],
                        "held_mse_step_0": before,
                        f"held_mse_step_{steps}": after,
                        "held_codec_mse": codec_mse}}
    emit(res)
    if not all(math.isfinite(v) for v in mses) or not after < before:
        raise AssertionError(f"pp_main: the held-out MSE went {before} -> "
                             f"{after} in {steps} steps")
    return res


def snapshot_checkpoint(pkg, raw, path):
    """Write ``raw`` (a config dict) to ``path`` and a checkpoint of the
    lambda=2000 snapshot (``checkpoint`` and ``model_best``) in its
    experiment directory, through an agent of the config in ``mode: train``
    (it builds the optimizer state the checkpoint holds)."""
    with open(path, "w") as fh:
        json.dump(dict(raw, mode="train"), fh)
    agent = pkg.loop.LiftingDWTAgent(pkg.config.process_config(path))
    pkg.weights.load_flax_params(agent.model, pkg.weights.load_npz(SNAPSHOT))
    import numpy
    with numpy.load(SNAPSHOT) as snap:    # the snapshot's training steps
        agent.current_iteration = int(snap["__iteration__"])
    agent.save_checkpoint(is_best=True)


@contextlib.contextmanager
def short_validation(pkg):
    """The agents this process runs validate on the first
    ``AGENT_VALID_IMAGES`` of their loader's validation images."""
    real = pkg.data.ImageDataLoader.valid_batches
    pkg.data.ImageDataLoader.valid_batches = lambda self: itertools.islice(
        real(self), AGENT_VALID_IMAGES)
    try:
        yield
    finally:
        pkg.data.ImageDataLoader.valid_batches = real


@contextlib.contextmanager
def cli_agents(pkg, test_images=None):
    """Collect the agents the CLI runs; ``test_images`` (uint8 HWC) replace
    the test set the loader reads (the card's machine has no PIL to read
    image files)."""
    agents = []
    real_run, real_test = pkg.cli.run_agent, pkg.data.ImageDataLoader.test_batches

    def run(cfg, device=None):
        agents.append(real_run(cfg, device))
        return agents[-1]

    pkg.cli.run_agent = run
    if test_images is not None:
        pkg.data.ImageDataLoader.test_batches = lambda self: (
            img[None].astype("float32") / 255.0 for img in test_images)
    try:
        yield agents
    finally:
        pkg.cli.run_agent = real_run
        pkg.data.ImageDataLoader.test_batches = real_test


def phase_pp_agent(torch, pkg, counts):
    """The CLI's ``mode: train_postprocess`` on the lambda=2000 snapshot's
    checkpoint (``--resume-training``: 2 epochs of 2 steps of 2 x 128x128,
    validation with the net applied), then ``mode: test``."""
    with open(CONFIG) as fh:
        raw = json.load(fh)
    raw.update(PP_AGENT, exp_name="smoke_pp_agent")
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp), \
            short_validation(pkg):
        snapshot_checkpoint(pkg, raw, "pp.json")
        with open("pp.json", "w") as fh:
            json.dump(dict(raw, mode="train_postprocess"), fh)
        cfg = pkg.config.process_config("pp.json")
        n_valid = len(list(pkg.data.ImageDataLoader(cfg).valid_batches()))
        counts.reset()
        t0 = time.perf_counter()
        with cli_agents(pkg) as agents:
            if pkg.cli.main(["--resume-training", "pp.json"]) != 0:
                raise AssertionError("the CLI returned non-zero")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts.read()
        agent = agents[0]
        with open(os.path.join("experiments", cfg.exp_name, "summaries",
                               "metrics.jsonl")) as fh:
            rows = [json.loads(ln) for ln in fh]
        test_res = agent_test(torch, pkg, counts, raw, reckon_coding,
                              "pp_agent_test")
    steps, epochs = cfg.steps_per_epoch, cfg.max_epoch
    side = (cfg.patch_size,) * 2
    per_train = pp_launches(cfg, side, cfg.batch_size, train=True)
    per_valid = pp_launches(cfg, side)
    want = {k: epochs * (steps * per_train[k] + n_valid * per_valid[k])
            for k in per_train}
    res = {"phase": "pp_agent", "seconds": seconds, "launches": launches,
           "valid_images": n_valid,
           "restored_iteration": agent.current_iteration,
           "pp_net": type(getattr(agent, "pp_model", None)).__name__,
           "metrics": [{k: r[k] for k in ("typ", "rd", "psnr")}
                       for r in rows]}
    emit(res)
    expect_launches(launches, want, "the pp_agent run")
    if res["pp_net"] != "PostProcessingiWave" \
            or [r["typ"] for r in rows] != ["tr", "va"] * epochs \
            or not all(math.isfinite(r["rd"]) for r in rows):
        raise AssertionError(f"pp_agent: {res}")
    return res, test_res


def streams_sha256(streams):
    """One digest of the streams in order (``tests/test_torch_tiling.py``
    writes the targets file's with it)."""
    import hashlib
    h = hashlib.sha256()
    for s in streams:
        for part in (s.xe, *s.xo):
            h.update(part)
    return h.hexdigest()


def tiled_run(torch, pkg, cfg, model, x, n_tiles, parallel):
    """One tiled round trip (``TiledCodecCoder.compress_decompress``) of
    NHWC ``x``: wall s, MP/s, bpp, PSNR, the streams' digest, peak memory
    and each tile's card/host split; the decoder's bits checked."""
    coder = pkg.tiled_coder.TiledCodecCoder(cfg, model, n_tiles,
                                            parallel=parallel, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = coder.compress_decompress(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h, w = x.shape[1:3]
    return {"parallel": parallel, "wall_s": wall, "mp_per_s": h * w / 1e6
            / wall, "bpp": res.bpp, "psnr": res.psnr,
            "sha256": streams_sha256(res.streams),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tiles": coder.last_tile_timing}


def phase_tiled_bitstream(torch, np, pkg, counts):
    """Tiled coding of high-resolution images in fp32 with the lambda=2000
    snapshot: a 1024x1024 image through the CLI's ``mode: test`` with
    ``tile_size`` 256 (the agent codes it in 4 tiles on the pool), held to
    the JAX package's CPU tiled coding (``results/port_tiled_targets.json``);
    a 256x256 image through ``TiledCodecCoder`` in 2 tiles one after
    another, then on the pool (the same bytes): s/image, MP/s, each tile's
    card/host split, peak memory."""
    with open(TILED_TARGETS) as fh:
        target = json.load(fh)
    (size, tile, seed), (small, small_tile, small_seed) = TILED
    img = pkg.data.synthetic_natural_images(1, size, seed=seed)[0]
    with open(CONFIG) as fh:
        raw = json.load(fh)
    raw.update(AGENT, exp_name="smoke_tiled", tile_size=tile)
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        snapshot_checkpoint(pkg, raw, "tiled.json")
        with open("tiled.json", "w") as fh:
            json.dump(dict(raw, mode="test"), fh)
        cfg = pkg.config.process_config("tiled.json")
        counts.reset()
        t0 = time.perf_counter()
        with cli_agents(pkg, [img]) as agents:
            if pkg.cli.main(["tiled.json"]) != 0:
                raise AssertionError("the CLI returned non-zero")
        torch.cuda.synchronize()
        agent_s = time.perf_counter() - t0
        launches = counts.read()
    (got,) = agents[0].last_test_per_image
    n_tiles = size // tile
    # a tile's planes: the analysis, and the synthesis of the decoded
    # subbands
    per_tile = launches_of(conv=2 * coding_conv_launches(cfg))
    expect_launches(launches, {k: n_tiles * v for k, v in per_tile.items()},
                    "the tiled agent test")
    model = agents[0].model
    x = pkg.data.synthetic_natural_images(1, small, seed=small_seed)[0][None]
    runs = [tiled_run(torch, pkg, cfg, model, x.astype("float32") / 255.0,
                      small // small_tile, parallel)
            for parallel in (False, True)]
    res = {"phase": "tiled_bitstream",
           "agent": {"image": target["image"], "tile_size": tile,
                     "n_tiles": n_tiles, "seconds": agent_s,
                     "launches": launches, "bpp": got["bpp"],
                     "psnr": got["psnr"], "target_bpp": target["bpp"],
                     "target_psnr": target["psnr"]},
           "sequential": runs[0], "pool": runs[1],
           "pool_image": [1, 3, small, small], "pool_tile_size": small_tile,
           "pool_speedup": runs[0]["wall_s"] / runs[1]["wall_s"]}
    emit(res)
    if not abs(got["bpp"] - target["bpp"]) <= TARGET_BPP_RTOL * target["bpp"] \
            or not abs(got["psnr"] - target["psnr"]) <= TARGET_PSNR_TOL:
        raise AssertionError(f"tiled_bitstream: {res['agent']} off the "
                             "target")
    if runs[0]["sha256"] != runs[1]["sha256"] \
            or not all(math.isfinite(r["bpp"]) and math.isfinite(r["psnr"])
                       for r in runs):
        raise AssertionError("tiled_bitstream: pool and sequential tiles "
                             "disagree, or a result is not finite")
    return res


def phase_agent_tf32_default(torch, np, pkg, counts):
    """The CLI's ``mode: test`` entered with PyTorch's own defaults (cuDNN
    may use TF32), outside ``tf32_off``: the lambda=2000 snapshot's
    checkpoint on the first ``SECOND_PASS_IMAGES`` of the 19 dead-leaves
    images, each held to the JAX
    package's CPU coding as the ``bitstream`` phase holds it, and the
    flags read after the run (the entry points turn TF32 off). Then the
    question the fix leaves: do the tree models' card round trips still
    decode bit for bit with cuDNN's TF32 on? Their coders (seeded, as the
    tree phases build them) code two images with the flags forced on after
    construction; the coder raises on a plane that does not."""
    with open(TARGETS) as fh:
        targets = json.load(fh)["per_image"]
    _, size, seed = BITSTREAM_IMAGES
    n = SECOND_PASS_IMAGES
    images = pkg.data.synthetic_natural_images(BITSTREAM_IMAGES[0], size,
                                               seed=seed)[:n]
    with open(CONFIG) as fh:
        raw = json.load(fh)
    raw.update(AGENT, exp_name="smoke_tf32_default")
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        snapshot_checkpoint(pkg, raw, "tf32.json")
        with open("tf32.json", "w") as fh:
            json.dump(dict(raw, mode="test"), fh)
        torch.backends.cudnn.allow_tf32 = True          # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            counts.reset()
            with cli_agents(pkg, images) as agents:
                if pkg.cli.main(["tf32.json"]) != 0:
                    raise AssertionError("the CLI returned non-zero")
            flags_after = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            launches = counts.read()
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = old
    per = agents[0].last_test_per_image
    rows = [{"image": t["image"], "bpp": r["bpp"], "psnr": r["psnr"],
             "bpp_rel_gap": r["bpp"] / t["bpp"] - 1.0,
             "psnr_gap_db": r["psnr"] - t["psnr"]}
            for r, t in zip(per, targets)]
    tree = {}
    for key, el, _ in TREE_MODELS:
        tcfg = tree_config(pkg, el, lambda_=2000.0)
        coder = pkg.codec_coder.CodecCoder(tcfg, tree_model(torch, pkg, tcfg),
                                           DEV)
        got = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                got[tf32] = [coder.compress_decompress(
                    img[None].astype("float32") / 255.0) for img in images[:2]]
            finally:
                torch.backends.cudnn.allow_tf32 = old[0]
        tree[key] = {"round_trips_tf32": len(got[True]),
                     "bpp_tf32": [r.bpp for r in got[True]],
                     "bpp_fp32": [r.bpp for r in got[False]],
                     "same_bytes": [
                         [s.xe for s in a.streams] == [s.xe for s in b.streams]
                         and [s.xo for s in a.streams]
                         == [s.xo for s in b.streams]
                         for a, b in zip(got[True], got[False])]}
        del coder
    res = {"phase": "agent_tf32_default", "images": [n, 3, size, size],
           "flags_after": flags_after, "launches": launches,
           "mean_bpp": mean(rows, "bpp"), "mean_psnr_db": mean(rows, "psnr"),
           "max_bpp_rel_gap": max(abs(r["bpp_rel_gap"]) for r in rows),
           "max_psnr_gap_db": max(abs(r["psnr_gap_db"]) for r in rows),
           "tree_models_tf32": tree}
    emit(res)
    expect_launches(launches, {k: n * v for k, v in reckon_coding(
        agents[0].cfg).items()}, "agent_tf32_default")
    if flags_after != (False, False) or len(rows) != n \
            or not res["max_bpp_rel_gap"] <= TARGET_BPP_RTOL \
            or not res["max_psnr_gap_db"] <= TARGET_PSNR_TOL:
        raise AssertionError(f"agent_tf32_default: {res}")
    return res


def reckon_coding(cfg):
    """The kernels' launches of one image's real bitstream: the scaling
    AEs' 3x3 convs for the flagship (conv3x3_halo in fp32, conv_v2 in
    bf16), and for onlyEZWT its plc stacks in the encoder's chain and the
    decoder's passes (kernel 1 in any dtype); the ladder for CDF97 and the
    attention transforms; the quincunx P/U convs (kernel 1, fp32 in any
    dtype); none for BasicWavelet (cuDNN convs)."""
    if cfg.netType == "CDF97":
        lift_n, ilift_n = ladder_launches(cfg, False)
        return launches_of(lift=lift_n, ilift=ilift_n)
    if cfg.netType == "QuincunxLifting":
        return reckon_quincunx(cfg)
    if cfg.netType in ("BasicWavelet", "AttentionWavelet",
                       "AttentionWaveletPostProcessing"):
        return reckon_alt(cfg)
    n = 2 * coding_conv_launches(cfg)
    plc = 2 * plc_launches(cfg)
    return launches_of(v2=n, conv=plc) if cfg.dtype == "bfloat16" \
        else launches_of(conv=n + plc)


def reckon_step(cfg, train=False, size=None):
    """The kernels' launches of one flagship-type eval or train step: every
    dense 3x3 conv forward (and in training a dx, each input lying behind
    the lifting stage's parameters), on conv_v2 in bf16 but onlyEZWT's plc
    stacks, which stay fp32 on kernel 1."""
    n = sum(conv_shapes(cfg, size).values())
    plc = plc_launches(cfg)
    f, dx = (2, 1) if train else (1, 0)
    if cfg.dtype == "bfloat16":
        return launches_of(conv=f * plc, conv_dx=dx * plc, v2=f * (n - plc),
                           v2_dx=dx * (n - plc))
    return launches_of(conv=f * n, conv_dx=dx * n)


def reckon_flagship_agent(cfg, n_valid):
    n_conv = sum(conv_shapes(cfg).values())
    steps, epochs = cfg.steps_per_epoch, cfg.max_epoch
    return launches_of(conv=epochs * (steps * 2 * n_conv + n_valid * n_conv),
                       conv_dx=epochs * steps * n_conv)


def reckon_cdf97_agent(cfg, n_valid):
    steps, epochs = CDF97_AGENT["steps_per_epoch"], CDF97_AGENT["max_epoch"]
    (tl, ts), (el, es) = ladder_launches(cfg, True), ladder_launches(cfg, False)
    return launches_of(lift=epochs * (steps * tl + n_valid * el),
                       ilift=epochs * (steps * ts + n_valid * es))


def ladder_entry(name, lift, rows, level_rows, main_res, train_res,
                 alt_launches=0):
    """The ``kernels`` line's entry of one ladder kernel: its launches on
    the CDF97 eval and train paths, and per eval step (each level shape's
    numbers times its launches there) its time by events and on the device,
    the host's time a call, the plain level's, the bound, the old one-axis
    bound, the three-pass form's and the conv yardstick's; the same per
    train step. ``alt_launches``: its launches on the attention
    transforms' paths."""
    mine = [r for r in level_rows if r["kernel"] == name]

    def per(key, path="eval"):
        return sum(r[key] * r[f"launches_{path}_step"] for r in mine)

    def mean_host(path):
        on = [r["host_us"] for r in mine if r[f"launches_{path}_step"]]
        return sum(on) / len(on)

    ev, tr = main_res["launches"][name], train_res["launches"][name]
    return {"name": name, "route": "cuda",
            "source": os.path.relpath(lift.SOURCE, HERE),
            "replaces": "scripts/bench_pallas.py:"
                        + ("85" if name == "lift97" else "106"),
            "launches": ev + tr + alt_launches, "launches_eval_path": ev,
            "launches_train_path": tr,
            "launches_attention_transforms": alt_launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine + [
                r for r in rows if r["kernel"] == name]),
            "ms": per("ms"), "device_ms": per("device_ms"),
            "host_us_per_call": mean_host("eval"),
            "plain_ms": per("plain_ms"), "bound_ms": per("bound_ms"),
            "bound_by": "bytes", "bound_1d_ms": per("bound_1d_ms"),
            "library_ms": per("library_ms"),
            "three_pass_ms": per("three_pass_ms"),
            "three_pass_device_ms": per("three_pass_device_ms"),
            "train_step_ms": per("ms", "train"),
            "train_step_device_ms": per("device_ms", "train"),
            "train_step_plain_ms": per("plain_ms", "train"),
            "train_step_bound_ms": per("bound_ms", "train"),
            "train_step_library_ms": per("library_ms", "train")}


def tree_launch_totals(res):
    """Each counter's launches over the counted runs of the tree-model
    phases (parity, main, train, bitstream, coding_many, agent)."""
    total = launches_of()

    def add(d, times=1):
        for k in total:
            total[k] += times * d[k]

    for key, _, _ in TREE_MODELS:
        add(res[f"{key}_parity"]["launches"])
        add(res[f"{key}_parity"]["train"]["launches"])
        for dtype in ("float32", "bfloat16"):
            add(res[f"{key}_main"][dtype]["launches"])
        add(res[f"{key}_train"]["launches"])
        add(res[f"{key}_bitstream"]["launches_per_image"],
            TREE_BITSTREAM_IMAGES)
        add(res[f"{key}_agent"]["first_run"]["launches"])
        add(res[f"{key}_agent_test"]["launches"])
    for workers in (1, 2):
        add(res["coding_many"][f"workers_{workers}"]["launches"])
    return total


def new_path_launch_totals(res):
    """Each counter's launches over the counted runs of the quincunx phases
    (parity, main, bitstream, agent) and of the other transforms' (parity,
    eval steps, bitstream)."""
    q, alt = launches_of(), launches_of()

    def add(total, d, times=1):
        for k in total:
            total[k] += times * d[k]

    add(q, res["quincunx_parity"]["launches"])
    add(q, res["quincunx_parity"]["train"]["launches"])
    add(q, res["quincunx_main"]["launches"])
    add(q, res["quincunx_main"]["train"]["launches"])
    for point in res["quincunx_bitstream"]["points"].values():
        add(q, point["launches_per_image"], BITSTREAM_IMAGES[0])
    add(q, res["quincunx_agent"]["first_run"]["launches"])
    add(q, res["quincunx_agent_test"]["launches"])
    for r in res["alt"].values():
        add(alt, r["launches"])
        add(alt, r["train"]["launches"])
        add(alt, r["eval_launches"])
        add(alt, reckon_coding(r["cfg"]), ALT_BITSTREAM_IMAGES)
    return q, alt


def kernel_entries(conv, v2, lift97, rows, bwd_rows, v2_rows, lift_rows,
                   level_rows, res):
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

    k1_32, b1_32 = rows, bwd_rows        # fp32 operands
    v2_eval, v2_train = by(v2_rows, path="eval"), by(v2_rows, path="train")
    tree = tree_launch_totals(res)
    quincunx, alt = new_path_launch_totals(res)
    q_fwd, q_bwd = res["quincunx_kernel"]

    def per_dx(rows_, key):
        return sum(r[key] * r["dx_launches_per_step"] for r in rows_)
    pp_fwd, pp_bwd = res["pp_kernel"]
    pp_runs = [res["pp_parity"]["train"]["launches"],
               res["pp_main"]["eval"]["launches"],
               res["pp_main"]["train"]["launches"],
               res["pp_agent"]["launches"], res["pp_agent_test"]["launches"]]
    fp32 = {"parity": res["parity"], "train_parity": res["train_parity"][0],
            "main_fp32": res["main"]["fp32_launches"]["conv3x3_halo"],
            "bitstream": res["bitstream_launches"],
            "agent": res["agent"]["first_run"]["launches"]["conv3x3_halo"],
            "agent_test": res["agent_test"]["launches"]["conv3x3_halo"],
            "postprocess": sum(r["conv3x3_halo"] for r in pp_runs)
            + sum(2 * n["launches_per_forward"]
                  for n in res["pp_parity"]["nets"].values()),
            "tiled_agent_test": res["tiled_bitstream"]["agent"]["launches"]
            ["conv3x3_halo"],
            "agent_tf32_default": res["agent_tf32_default"]["launches"]
            ["conv3x3_halo"],
            "tree_models": tree["conv3x3_halo"],
            "quincunx": quincunx["conv3x3_halo"]}
    bf16 = {"main": res["main"]["launches"]["conv_v2"],
            "train": res["train"]["launches"]["conv_v2"],
            "bitstream_bf16": res["bitstream_bf16_launches"],
            "tree_models": tree["conv_v2"]}
    tpu = "imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu/"
    ladders = [ladder_entry(k, lift97, lift_rows, level_rows,
                            res["cdf97_main"], res["cdf97_train"], alt[k])
               for k in ("lift97", "ilift97")]
    return [{
        # kernel 1 carries the fp32 convs: its numbers per fp32 eval step
        "name": "conv3x3_halo", "route": "cuda",
        "source": os.path.relpath(conv.SOURCE, HERE),
        "replaces": tpu + "ops/pallas_conv.py:102",
        "launches": sum(fp32.values()), "launches_by_path": fp32,
        "max_abs_err": max([r["max_abs_err"] for r in rows + pp_fwd]
                           + [r["fwd_max_abs_err"]
                              for r in bwd_rows + pp_bwd]),
        "dtype": "float32", "ms": per(k1_32, "ms"),
        "plain_ms": per(k1_32, "plain_ms"), "bound_ms": per(k1_32, "bound_ms"),
        "bound_by": bound_by(k1_32), "library_ms": per(k1_32, "library_ms"),
        # the quincunx P/U convs a B=8 512x768 eval step
        "quincunx_step_launches": sum(r["launches_per_step"] for r in q_fwd),
        "quincunx_step_ms": per(q_fwd, "ms"),
        "quincunx_step_plain_ms": per(q_fwd, "plain_ms"),
        "quincunx_step_bound_ms": per(q_fwd, "bound_ms"),
        "quincunx_step_library_ms": per(q_fwd, "library_ms"),
        # iwave's convs a B=8 512x768 restored eval step
        "pp_step_launches": sum(r["launches_per_step"] for r in pp_fwd),
        "pp_step_ms": per(pp_fwd, "ms"),
        "pp_step_plain_ms": per(pp_fwd, "plain_ms"),
        "pp_step_bound_ms": per(pp_fwd, "bound_ms"),
        "pp_step_library_ms": per(pp_fwd, "library_ms")}, {
        "name": "conv3x3_halo_dx", "route": "cuda",
        "source": os.path.relpath(conv.SOURCE, HERE),
        "replaces": tpu + "ops/pallas_conv.py:137",
        "launches": res["train_parity"][1]
        + res["agent"]["first_run"]["launches"]["conv3x3_halo_dx"]
        + tree["conv3x3_halo_dx"] + quincunx["conv3x3_halo_dx"]
        + sum(r["conv3x3_halo_dx"] for r in pp_runs),
        "launches_quincunx": quincunx["conv3x3_halo_dx"],
        "launches_postprocess": sum(r["conv3x3_halo_dx"] for r in pp_runs),
        "max_abs_err": max(r["dx_max_abs_err"] for r in bwd_rows + pp_bwd),
        "dtype": "float32", "ms": per(b1_32, "dx_ms"),
        "plain_ms": per(b1_32, "dx_plain_ms"),
        "bound_ms": per(b1_32, "dx_bound_ms"),
        "bound_by": bound_by(b1_32, nbytes="dx_bytes_ms"),
        "library_ms": per(b1_32, "dx_library_ms"),
        # the quincunx P/U convs' dx a B=8 256x256 train step
        "quincunx_train_step_launches": sum(r["dx_launches_per_step"]
                                            for r in q_bwd),
        "quincunx_train_step_ms": per_dx(q_bwd, "dx_ms"),
        "quincunx_train_step_plain_ms": per_dx(q_bwd, "dx_plain_ms"),
        "quincunx_train_step_bound_ms": per_dx(q_bwd, "dx_bound_ms"),
        "quincunx_train_step_library_ms": per_dx(q_bwd, "dx_library_ms"),
        # iwave's dx a B=8 256x256 postprocess train step
        "pp_train_step_launches": sum(r["dx_launches_per_step"]
                                      for r in pp_bwd),
        "pp_train_step_ms": per_dx(pp_bwd, "dx_ms"),
        "pp_train_step_plain_ms": per_dx(pp_bwd, "dx_plain_ms"),
        "pp_train_step_bound_ms": per_dx(pp_bwd, "dx_bound_ms"),
        "pp_train_step_library_ms": per_dx(pp_bwd, "dx_library_ms")},
        *ladders, {
        "name": "conv_v2", "route": "cuda",
        "source": os.path.relpath(v2.SOURCE, HERE),
        "replaces": "scripts/bench_pallas_v2.py:34",
        "launches": sum(bf16.values()), "launches_by_path": bf16,
        "launches_dx": res["train"]["launches"]["conv_v2_dx"]
        + tree["conv_v2_dx"],
        "max_abs_err": max([r["max_abs_err"] for r in v2_rows if "ms" in r]
                           + [r["fwd_max_abs_err"] for r in v2_train]
                           + [r["dx_max_abs_err"] for r in v2_train]),
        "dtype": "bfloat16", "ms": per(v2_eval, "ms"),
        "pad_ms": per(v2_eval, "pad_ms"),
        "plain_ms": per(v2_eval, "plain_ms"),
        "bound_ms": per(v2_eval, "bound_ms"), "bound_by": bound_by(v2_eval),
        "library_ms": per(v2_eval, "library_ms"),
        "train_step_fwd_ms": per(v2_train, "fwd_ms"),
        "train_step_dx_ms": per(v2_train, "dx_ms"),
        "train_step_dx_plain_ms": per(v2_train, "dx_plain_ms"),
        "train_step_dx_bound_ms": per(v2_train, "dx_bound_ms"),
        "train_step_dx_library_ms": per(v2_train, "dx_library_ms")}]


# --- scale-out and the matmul conv forms (phases fast_conv_forms to
# supervise) ------------------------------------------------------------


@contextlib.contextmanager
def earlier_conv_forms(pkg):
    """The port's conv forms before the JAX package's matmul forms came in:
    every grouped 1x1 and masked grouped conv a cuDNN bf16 conv at every
    size (the earlier forms' costs, timed against today's)."""
    fc, mc = pkg.fast_conv, pkg.masked_conv
    saved = (fc.large_plane, mc.large_plane)
    fc.large_plane = mc.large_plane = lambda x: False
    try:
        yield
    finally:
        fc.large_plane, mc.large_plane = saved


def form_shapes(cfg, b, h, w):
    """Every distinct (form, x NCHW, weight, groups) the eval step gives a
    matmul form, with its calls a step: the cgp layers and the csc conv of
    each finer level whose plane has 4096 pixels or more; then
    ``conv5x5_s2d`` at the largest P/U conv shape (level 0's row pass),
    which the step does not take (0 calls)."""
    c, so = cfg.clrch, 3 * cfg.clrch
    planes = 3 if c == 1 else 1
    wide, hid = so * 81, cfg.depth_scale * 8 * c
    fused = 2 * wide
    rows = []
    for lv in range(cfg.dwtlevels - 1):
        hl, wl = h >> (lv + 1), w >> (lv + 1)
        if hl * wl < 4096:
            continue
        for cin, cout in ((fused, fused), (fused, fused // 3),
                          (fused // 3, fused // 9), (fused // 9, 2 * so)):
            rows.append(("grouped_conv1x1_einsum", (b, cin, hl, wl),
                         (cout, cin // so, 1, 1), so, planes))
        rows.append(("grouped_conv_taps", (b, so, hl, wl), (wide, 1, 5, 5),
                     so, planes))
    rows.append(("conv5x5_s2d", (b, hid, h // 2, w), (hid, hid, 5, 5), 1,
                 0))
    return rows


def phase_fast_conv_forms(torch, F, np, pkg):
    """Each matmul form against its plain version at every bf16 shape of the
    flagship eval step (fp32 sums of the same bf16-rounded operands: 1e-4
    of max |plain|; ``conv5x5_s2d``, at one shape the step does not give
    it, rounds its output to bf16, so half a bf16 step, 2^-8 of |y| at
    most), with its time, cuDNN's bf16 conv (the port's earlier form and
    the library call) and the bound; then the grouped forms at the
    fp32 step's shapes against cuDNN's fp32 grouped convs (recorded only:
    fp32 configs keep ``F.conv2d``); then the bf16 eval and train steps
    with the earlier forms, then with today's."""
    fc = pkg.fast_conv
    cfg = pkg.config.flagship_config(dtype="bfloat16")
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows, fp32_rows = [], []
    for name, xs, ws, groups, per_step in form_shapes(cfg, B, H, W):
        x = torch.randn(xs, device=DEV, generator=gen)
        wt = torch.randn(ws, device=DEV, generator=gen) / math.sqrt(
            ws[1] * ws[2] * ws[3])
        bias = torch.randn(ws[0], device=DEV, generator=gen) * 0.1
        pad = ws[2] // 2
        if name == "grouped_conv_taps":
            wt = wt * torch.from_numpy(pkg.masked_conv.causal_mask(
                (5, 5), "A")).to(DEV)

        def form(dt=torch.bfloat16):
            if name == "conv5x5_s2d":
                return fc.conv5x5_s2d(x, wt, bias, dt)
            return getattr(fc, name)(x, wt, bias, groups, dt)

        def plain():
            return F.conv2d(x.bfloat16().float(), wt.bfloat16().float(), bias,
                            padding=pad, groups=groups)

        def library(dt=torch.bfloat16):
            return F.conv2d(x.to(dt), wt.to(dt), bias.to(dt), padding=pad,
                            groups=groups)

        got, want = form(), plain()
        err = rel_err(got, want)
        tol = 2.0 ** -8 if name == "conv5x5_s2d" else KERNEL_TOL
        n_out = xs[0] * ws[0] * xs[2] * xs[3]
        flop = 2.0 * n_out * ws[1] * ws[2] * ws[3]
        nbytes = 4.0 * (x.numel() + wt.numel() + bias.numel() + n_out)
        bound = max(nbytes / PEAK_BYTES, flop / PEAK_FLOPS["bfloat16"]) * 1e3
        row = {"form": name, "x": list(xs), "weight": list(ws),
               "groups": groups, "per_step": per_step, "max_abs_err": err,
               "tol": tol, "ms": time_ms(form, torch),
               "plain_ms": time_ms(plain, torch),
               "library_ms": time_ms(library, torch), "bound_ms": bound,
               "bound_by": "bytes" if nbytes / PEAK_BYTES
               > flop / PEAK_FLOPS["bfloat16"] else "operations"}
        rows.append(row)
        if not err <= tol:
            raise AssertionError(f"{name} at {xs}: {err} > {tol}")
        if name != "conv5x5_s2d":
            with tf32_off(torch):
                fp32_rows.append({
                    "form": name, "x": list(xs), "weight": list(ws),
                    "per_step": per_step,
                    "ms": time_ms(lambda: form(torch.float32), torch),
                    "library_ms": time_ms(lambda: library(torch.float32),
                                          torch),
                    "max_abs_err": rel_err(form(torch.float32), F.conv2d(
                        x, wt, bias, padding=pad, groups=groups))})
        del x, wt, bias, got, want

    def per_step(rs, key):
        return sum(r[key] * r["per_step"] for r in rs)

    steps = {}
    batch = eval_batch(torch, np, pkg)
    model = load_model(cfg, pkg)
    eval_step = pkg.state.make_eval_step(cfg, model, DEV)
    tcfg = pkg.config.flagship_config(dtype="bfloat16", lambda_=2000.0,
                                      learning_rate=TRAIN_LR)
    tmodel = load_model(tcfg, pkg)
    train_step = pkg.state.make_train_step(
        tcfg, tmodel, pkg.state.make_optimizer(tcfg, tmodel), DEV)
    tbatch = train_batch(torch, np, pkg, TRAIN_B, TRAIN_P, seed=1).to(DEV)
    tgen = torch.Generator(device=DEV).manual_seed(0)
    for which in ("before", "after"):
        ctx = earlier_conv_forms(pkg) if which == "before" \
            else contextlib.nullcontext()
        with ctx:
            eval_step(batch)
            train_step(tbatch, tgen, TRAIN_LR, 1.0)
            torch.cuda.synchronize()
            steps.setdefault(f"main_{which}_ms", []).extend(timed_steps(
                torch, lambda: eval_step(batch), 2))
            steps.setdefault(f"train_{which}_ms", []).extend(timed_steps(
                torch, lambda: train_step(tbatch, tgen, TRAIN_LR, 1.0), 2))
    res = {"phase": "fast_conv_forms", "dtype": "bfloat16",
           "step": [B, 3, H, W], "rows": rows,
           "per_step": {k: per_step(rows, k) for k in
                        ("ms", "plain_ms", "library_ms", "bound_ms")},
           "fp32_rows": fp32_rows,
           "fp32_per_step": {k: per_step(fp32_rows, k)
                             for k in ("ms", "library_ms")},
           **{k: sum(v) / len(v) for k, v in steps.items()},
           "step_ms_all": steps}
    emit(res)
    return res


MESH_TRAIN_SEED = 7        # the dp_train noise generator, on every rank
MESH_TRAIN_STEPS = 3       # dp_train: steps after which the ranks agree
MESH_TIMED_STEPS = 1       # timed steps of the shardmap form
HALO_SIZE = 2048           # halo_eval's one image
TILED_MESH = (1024, 4)     # tiled_mesh: image side, tiles
# validated after the second epoch only (rank 0 validates while rank 1
# waits); the resumed run takes the second epoch again and validates
AGENT_MESH = dict(AGENT, steps_per_epoch=2, max_epoch=2, validate_every=2)


def halo_models(torch, pkg):
    """(name, config, model) of halo_eval: the lambda=2000 flagship in fp32
    and CDF97 (seeded)."""
    fcfg = pkg.config.flagship_config(lambda_=2000.0)
    ccfg = cdf97_config(pkg)
    return (("flagship", fcfg, load_model(fcfg, pkg)),
            ("cdf97", ccfg, cdf97_model(torch, pkg, ccfg)))


def mesh_inputs(torch, np, pkg):
    """The scale-out phases' inputs, made the same way in every process."""
    halo = pkg.data.synthetic_natural_images(1, HALO_SIZE, seed=21)[0]
    tiled = pkg.data.synthetic_natural_images(1, TILED_MESH[0], seed=22)[0]
    return (train_batch(torch, np, pkg, TRAIN_B, TRAIN_P, seed=3),
            torch.from_numpy(halo).permute(2, 0, 1)[None].float() / 255.0,
            tiled[None].astype(np.float32) / 255.0)


def sliced_batch_grads(torch, pkg, cfg, batch, n):
    """The gradients that ``make_dp_train_step`` on ``n`` ranks averages,
    computed on one device: each rank's slice of the batch, with its slice
    of the shared noise, differentiated alone, then the mean over the
    slices in the order of the ranks' all-reduce. The same sums as the
    ranks' own, so the gate reads the exchange and not the summation
    order of the whole batch's gradient, which two half-batches summed
    apart move by up to 1e-2 in an ill-conditioned GDN tensor."""
    from types import SimpleNamespace
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.parallel.dp import (
        BatchSliceNoise)
    model = load_model(cfg, pkg).to(DEV).train()
    b = batch.shape[0] // n
    total = {}
    for r in range(n):
        model.zero_grad(set_to_none=True)
        noise = BatchSliceNoise(torch.Generator(device=DEV).manual_seed(
            MESH_TRAIN_SEED), SimpleNamespace(rank=r, size=n))
        xs, xhat, info_xe, info_xo, aux = pkg.state.apply_color_forward(
            cfg, model, batch[r * b:(r + 1) * b].to(DEV), True, noise)
        out = pkg.loss.rd_loss3(xs, xhat, info_xe, info_xo, cfg.lambda_, 1.0)
        ((out.loss + aux) / max(cfg.grad_acc_iters, 1)).backward()
        for k, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            total[k] = g.clone() if r == 0 else total[k] + g
    return {k: (g / n).cpu() for k, g in total.items()}


def scale_out_refs(torch, np, pkg, outdir):
    """The single-device results the ranks hold themselves to, written to
    ``outdir``: one fp32 flagship train step (its RD terms and gradients),
    the same gradients as two ranks' slices average them, each halo
    model's eval step at HALO_SIZE, and ``tiled_forward``."""
    tbatch, himg, timg = mesh_inputs(torch, np, pkg)
    cfg = pkg.config.flagship_config(lambda_=2000.0, learning_rate=TRAIN_LR)
    model = load_model(cfg, pkg)
    step = pkg.state.make_train_step(
        cfg, model, pkg.state.make_optimizer(cfg, model), DEV)
    out, _ = step(tbatch, torch.Generator(device=DEV).manual_seed(
        MESH_TRAIN_SEED), TRAIN_LR, 1.0)
    grads = {1: {k: p.grad.cpu() for k, p in model.named_parameters()},
             2: sliced_batch_grads(torch, pkg, cfg, tbatch, 2)}
    refs = {"train": ([float(v) for v in out], grads)}
    del model, step
    for name, hcfg, hmodel in halo_models(torch, pkg):
        out, xhat = pkg.state.make_eval_step(hcfg, hmodel, DEV)(himg)
        refs[name] = ([float(v) for v in out], xhat.cpu())
        del hmodel
    fcfg = pkg.config.flagship_config(lambda_=2000.0)
    refs["tiled"] = pkg.tiling.tiled_forward(fcfg, load_model(fcfg, pkg),
                                             timg, TILED_MESH[1], DEV)
    torch.save(refs, os.path.join(outdir, "refs.pt"))
    torch.cuda.empty_cache()


def grad_gaps_l2(got, want):
    """({name: max |got - want| / max |want|}, the L2 of the differences
    over the L2 of ``want``, every tensor together)."""
    gaps, l2_gap, l2 = {}, 0.0, 0.0
    for k, w in want.items():
        g = got[k]
        gaps[k] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
        l2_gap += float(((g - w) ** 2).sum())
        l2 += float((w ** 2).sum())
    return gaps, math.sqrt(l2_gap / l2)


def mesh_rank(mesh, outdir, phases):
    """One rank of the scale-out phases (spawned by ``phase_scale_out``, or
    its own process for a group of one):
    runs ``phases`` and writes ``<outdir>/<phase>_<backend>_rank<r>.json``.
    Every kernel launch count is this process's, set to 0 before the path
    and read after it."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from types import SimpleNamespace
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
        config)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
        codec)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        conv3x3_halo as conv, conv_v2 as v2, lift97)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.parallel import (
        dp, mesh as mesh_lib, tiling)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
        weights)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
        data, state)
    pkg = SimpleNamespace(config=config, codec=codec, weights=weights,
                          data=data, state=state, tiling=tiling)
    counts = Counts(conv, v2, lift97)
    # the gradients' references took cuDNN's deterministic algorithms, so
    # the ranks' own sums are the references' to the bit where the
    # exchange is right
    torch.backends.cudnn.deterministic = True
    refs = torch.load(os.path.join(outdir, "refs.pt"), weights_only=False)
    tbatch, himg, timg = mesh_inputs(torch, np, pkg)
    tag = f"{mesh.backend}_rank{mesh.rank}"

    def write(name, obj):
        with open(os.path.join(outdir, f"{name}_{tag}.json"), "w") as fh:
            json.dump(obj, fh)

    if "dp_train" in phases:
        cfg = pkg.config.flagship_config(lambda_=2000.0,
                                         learning_rate=TRAIN_LR)
        model = load_model(cfg, pkg)
        opt = pkg.state.make_optimizer(cfg, model)
        step, shard_state = dp.make_dp_train_step(cfg, model, opt, mesh)
        shard_state()
        gen = torch.Generator(device=mesh.device).manual_seed(MESH_TRAIN_SEED)
        counts.reset()
        out, _ = step(tbatch, gen, TRAIN_LR, 1.0)
        torch.cuda.synchronize()
        launches = counts.read()
        want_terms, want_grads = refs["train"]
        got_grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        gaps, l2_gap = grad_gaps_l2(got_grads, want_grads[mesh.size])
        whole_gaps, whole_l2_gap = grad_gaps_l2(got_grads, want_grads[1])
        for _ in range(MESH_TRAIN_STEPS - 1):
            step(tbatch, gen, TRAIN_LR, 1.0)
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        parts = mesh_lib.all_gather(mesh, flat)
        same = all(torch.equal(parts[0], p) for p in parts)
        sm_step, _ = dp.make_shardmap_train_step(cfg, model, opt, mesh)
        sgen = dp.rank_generator(MESH_TRAIN_SEED, mesh)
        sm_step(tbatch, sgen, TRAIN_LR, 1.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        ms = timed_steps(torch, lambda: sm_step(tbatch, sgen, TRAIN_LR, 1.0),
                         MESH_TIMED_STEPS)
        write("dp_train", {
            "terms": [float(v) for v in out], "want_terms": want_terms,
            "grad_ref": "whole batch" if mesh.size == 1
            else f"{mesh.size} slices averaged",
            "worst_grad": max(gaps, key=gaps.get),
            "worst_grad_rel_err": max(gaps.values()),
            "grad_l2_rel_err": l2_gap,
            "whole_batch_worst_grad": max(whole_gaps, key=whole_gaps.get),
            "whole_batch_worst_grad_rel_err": max(whole_gaps.values()),
            "whole_batch_grad_l2_rel_err": whole_l2_gap,
            "params_equal_after_steps": same, "launches": launches,
            "shardmap_ms_per_step": sum(ms) / len(ms),
            "shardmap_ms_all": ms, "shardmap_launches": counts.read(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del model, opt, step, sm_step
        torch.cuda.empty_cache()

    if "halo_eval" in phases:
        for name, cfg, model in halo_models(torch, pkg):
            step = pkg.tiling.make_halo_eval_step(cfg, model, mesh)
            step(himg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts.reset()
            t0 = time.perf_counter()
            out, xhat = step(himg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = counts.read()
            want_terms, want_xhat = refs[name]
            rows = xhat.shape[2]
            d = (xhat.cpu() - want_xhat[:, :, mesh.rank * rows:
                                       (mesh.rank + 1) * rows]).abs()
            write(f"halo_{name}", {
                "terms": [float(v) for v in out], "want_terms": want_terms,
                "xhat_mean_abs_err": float(d.mean()),
                "xhat_max_abs_err": float(d.max()), "ms": ms,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": launches})
            del model, step
            torch.cuda.empty_cache()

    if "tiled_mesh" in phases:
        cfg = pkg.config.flagship_config(lambda_=2000.0)
        model = load_model(cfg, pkg)
        counts.reset()
        t0 = time.perf_counter()
        got = pkg.tiling.tiled_forward(cfg, model, timg, TILED_MESH[1],
                                       mesh=mesh)
        ms = (time.perf_counter() - t0) * 1e3
        d = np.abs(got - refs["tiled"])
        write("tiled_mesh", {"xhat_mean_abs_err": float(d.mean()),
                             "xhat_max_abs_err": float(d.max()), "ms": ms,
                             "launches": counts.read()})


def read_ranks(outdir, name, backend, n):
    out = []
    for r in range(n):
        with open(os.path.join(outdir, f"{name}_{backend}_rank{r}.json")) \
                as fh:
            out.append(json.load(fh))
    return out


def terms_rel_err(rank):
    return max(abs(a - b) / abs(b) for a, b in zip(rank["terms"],
                                                   rank["want_terms"]))


def phase_scale_out(torch, np, pkg, card):
    """dp_train, halo_eval and tiled_mesh: two ranks sharing the card over
    gloo (NCCL refuses two ranks on one GPU), and dp_train again on one
    rank over NCCL, this process; each rank held to the single-device
    results."""
    res = {}
    with tempfile.TemporaryDirectory() as outdir:
        t0 = time.perf_counter()
        with tf32_off(torch, deterministic=True):
            scale_out_refs(torch, np, pkg, outdir)
        refs_s = time.perf_counter() - t0
        runs = (("gloo", 2, ("dp_train", "halo_eval", "tiled_mesh")),
                ("nccl", 1, ("dp_train",)))
        seconds = {}
        dev_type = torch.device(DEV).type
        for backend, n, phases in runs:
            t0 = time.perf_counter()
            if n == 1:      # a group of one: this process is its rank
                with tf32_off(torch, deterministic=True):
                    one = pkg.mesh.init_mesh(0, 1, "file://" + os.path.join(
                        outdir, "rendezvous"), dev_type)
                    try:
                        mesh_rank(one, outdir, phases)
                    finally:
                        torch.distributed.destroy_process_group()
            else:
                pkg.mesh.spawn(mesh_rank, n, dev_type, (outdir, phases))
            seconds[backend] = time.perf_counter() - t0
            if pkg.mesh.choose_backend(n, dev_type) != backend:
                raise AssertionError(f"{n} rank(s) on this machine would "
                                     f"not run {backend}")
        for backend, n, _ in runs:
            ranks = read_ranks(outdir, "dp_train", backend, n)
            name = f"dp_train_{backend}"
            res[name] = {"phase": name, "ranks": n, "backend": backend,
                         "card": card, "batch": [TRAIN_B, 3, TRAIN_P,
                                                 TRAIN_P],
                         "dtype": "float32", "seconds": seconds[backend],
                         "per_rank": ranks}
            emit(res[name])
            for r in ranks:
                if not (terms_rel_err(r) <= PARITY_RTOL
                        and r["worst_grad_rel_err"] <= GRAD_TOL
                        and r["grad_l2_rel_err"] <= GRAD_L2_TOL
                        and r["params_equal_after_steps"]):
                    raise AssertionError(f"{name}: {r}")
                if r["launches"]["conv3x3_halo"] == 0 \
                        or r["launches"]["conv3x3_halo_dx"] == 0:
                    raise AssertionError(f"{name}: kernel 1 not launched")
        for model in ("flagship", "cdf97"):
            ranks = read_ranks(outdir, f"halo_{model}", "gloo", 2)
            name = f"halo_eval_{model}"
            res[name] = {"phase": name, "ranks": 2, "backend": "gloo",
                         "image": [1, 3, HALO_SIZE, HALO_SIZE],
                         "dtype": "float32", "per_rank": ranks,
                         "refs_seconds": refs_s}
            emit(res[name])
            kernels = ("conv3x3_halo",) if model == "flagship" \
                else ("lift97", "ilift97")
            for r in ranks:
                if not (terms_rel_err(r) <= PARITY_RTOL
                        and r["xhat_mean_abs_err"] <= XHAT_MEAN_TOL
                        and r["xhat_max_abs_err"] <= XHAT_MAX_TOL):
                    raise AssertionError(f"{name}: {r}")
                if not all(r["launches"][k] > 0 for k in kernels):
                    raise AssertionError(f"{name}: {kernels} not launched")
        ranks = read_ranks(outdir, "tiled_mesh", "gloo", 2)
        res["tiled_mesh"] = {"phase": "tiled_mesh", "ranks": 2,
                             "image": [1, 3, TILED_MESH[0], TILED_MESH[0]],
                             "tiles": TILED_MESH[1], "per_rank": ranks}
        emit(res["tiled_mesh"])
        for r in ranks:
            if not (r["xhat_mean_abs_err"] <= XHAT_MEAN_TOL
                    and r["xhat_max_abs_err"] <= XHAT_MAX_TOL
                    and r["launches"]["conv3x3_halo"] > 0):
                raise AssertionError(f"tiled_mesh: {r}")
    return res


def phase_agent_mesh(torch, pkg, counts):
    """The CLI with ``mesh_shape: [2]`` (two gloo ranks sharing the card,
    2 epochs of 2 steps), resumed as a single-device run (``mesh_shape:
    [1]``) from rank 0's checkpoint, then ``mode: test`` on the
    ``AGENT_TEST_IMAGES`` images with the agent phases' gates."""
    with open(CONFIG) as fh:
        raw = json.load(fh)
    raw.update(AGENT_MESH, exp_name="smoke_agent_mesh")
    steps, epochs = raw["steps_per_epoch"], raw["max_epoch"]
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp), \
            short_validation(pkg):
        ckpt_dir = os.path.join("experiments", raw["exp_name"], "checkpoints")
        seconds, got = [], []
        for argv, mesh_shape in (([], [2]), (["--resume-training"], [1])):
            with open("agent.json", "w") as fh:
                json.dump(dict(raw, mesh_shape=mesh_shape), fh)
            t0 = time.perf_counter()
            if pkg.cli.main(argv + ["agent.json"]) != 0:
                raise AssertionError("the CLI returned non-zero")
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            saved = pkg.checkpoint.load_checkpoint(ckpt_dir,
                                                   map_location="cpu")
            if any(k.startswith("module.") for k in saved["model"]):
                raise AssertionError("a mesh checkpoint's keys are prefixed")
            got.append((saved["epoch"], saved["iteration"]))
        test_res = agent_test(torch, pkg, counts, dict(raw, mesh_shape=[1]),
                              reckon_coding, "agent_mesh_test")
    done = epochs * steps
    want = [(epochs - 1, done), (epochs - 1, done + steps)]
    res = {"phase": "agent_mesh", "mesh_shape": [2], "backend": "gloo",
           "batch": [raw["batch_size"], 3, raw["patch_size"],
                     raw["patch_size"]], "seconds": seconds,
           "counters": got}
    emit(res)
    if got != want:
        raise AssertionError(f"agent_mesh counters {got}, expected {want}")
    return res, test_res


def phase_supervise(torch, pkg):
    """The CLI under ``--supervise`` (CDF97, an epoch of 2 steps) runs to
    exit 0; the heartbeat file its run beat is read after it."""
    with open(CDF97_CONFIG) as fh:
        raw = json.load(fh)
    raw.update(CDF97_AGENT, max_epoch=1, exp_name="smoke_supervise")
    env_path = os.environ.get("PYTHONPATH")
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        with open("agent.json", "w") as fh:
            json.dump(raw, fh)
        old_tmp = tempfile.tempdir
        tempfile.tempdir = tmp             # where supervise() puts its file
        os.environ["PYTHONPATH"] = os.pathsep.join(
            p for p in (HERE, env_path) if p)
        try:
            t0 = time.perf_counter()
            rc = pkg.cli.main(["--supervise", "--stall-timeout", "600",
                               "agent.json"])
            seconds = time.perf_counter() - t0
        finally:
            tempfile.tempdir = old_tmp
            if env_path is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = env_path
        beats = [f for f in os.listdir(tmp) if f.startswith("train_hb_")]
        age = (pkg.heartbeat.age_seconds(os.path.join(tmp, beats[0]))
               if beats else None)
    res = {"phase": "supervise", "rc": rc, "seconds": seconds,
           "heartbeat_age_s": age}
    emit(res)
    if rc != 0 or age is None or not age <= seconds:
        raise AssertionError(f"supervise: {res}")
    return res


def scale_out_phases(torch, F, np, pkg, counts, card):
    """The matmul conv forms and the scale-out paths (``fast_conv_forms``
    to ``supervise``)."""
    res = {"fast_conv_forms": phase_fast_conv_forms(torch, F, np, pkg)}
    torch.cuda.empty_cache()
    res.update(phase_scale_out(torch, np, pkg, card))
    res["agent_mesh"], res["agent_mesh_test"] = phase_agent_mesh(
        torch, pkg, counts)
    res["supervise"] = phase_supervise(torch, pkg)
    torch.cuda.empty_cache()
    return res


def new_phases(torch, F, np, pkg, counts, conv):
    """The postprocess stage, tiled coding and the fp32 defaults of the
    entry points (the phases ``pp_kernel`` to ``agent_tf32_default``)."""
    res = {}
    with tf32_off(torch):
        res["pp_kernel"] = phase_pp_kernel(torch, F, conv, pkg)
    with tf32_off(torch, deterministic=True):
        res["pp_parity"] = phase_pp_parity(torch, np, pkg, counts)
    res["pp_main"] = phase_pp_main(torch, np, pkg, counts)
    torch.cuda.empty_cache()
    res["pp_agent"], res["pp_agent_test"] = phase_pp_agent(torch, pkg, counts)
    res["tiled_bitstream"] = phase_tiled_bitstream(torch, np, pkg, counts)
    torch.cuda.empty_cache()
    res["agent_tf32_default"] = phase_agent_tf32_default(torch, np, pkg,
                                                         counts)
    torch.cuda.empty_cache()
    return res


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
        bottleneck, gaussian, models as entropy_models)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
        tiled_coder)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
        codec, postprocess)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        color, conv3x3_halo as conv, conv_v2 as v2, dwt97, fast_conv, lift97,
        lifting, masked_conv)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.parallel import (
        mesh, tiling)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
        rd_heldout, weights)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
        checkpoint, data, loop, loss, postprocess_loop, state)
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.utils import (
        heartbeat)
    pkg = SimpleNamespace(cli=cli, config=config, codec=codec, weights=weights,
                          checkpoint=checkpoint, data=data, loss=loss,
                          state=state, bottleneck=bottleneck,
                          codec_coder=codec_coder, color=color,
                          gaussian=gaussian, entropy_models=entropy_models,
                          postprocess=postprocess, pp_loop=postprocess_loop,
                          tiled_coder=tiled_coder, rd_heldout=rd_heldout,
                          loop=loop, fast_conv=fast_conv, lifting=lifting,
                          masked_conv=masked_conv, mesh=mesh, tiling=tiling,
                          heartbeat=heartbeat)
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
        v2_rows = phase_conv_v2_kernel(torch, F, conv, v2, cfg)
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
    res["bitstream_launches"] = bits["launches"]
    bits16 = phase_bitstream_bf16(torch, numpy, pkg, counts, bits_rows)
    res["bitstream_bf16_launches"] = bits16["launches_per_image"]["conv_v2"] \
        * (SECOND_PASS_IMAGES + KODAK_IMAGES)
    torch.cuda.empty_cache()
    res.update(new_phases(torch, F, numpy, pkg, counts, conv))
    res.update(scale_out_phases(torch, F, numpy, pkg, counts, card))

    cdf97_cfg = cdf97_config(pkg)
    with tf32_off(torch):
        lift_rows = phase_lift97_kernel(torch, F, lift97, cdf97_cfg)
        level_rows = phase_lift97_level(torch, F, lift97, dwt97, cdf97_cfg)
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
    torch.cuda.empty_cache()

    for key, el, fit_steps in TREE_MODELS:
        with tf32_off(torch, deterministic=True):
            res[f"{key}_parity"] = phase_tree_parity(torch, numpy, pkg,
                                                     counts, key, el)
        res[f"{key}_main"] = phase_tree_main(torch, numpy, pkg, counts, key,
                                             el)
        res[f"{key}_train"] = phase_tree_train(torch, numpy, pkg, counts,
                                               key, el)
        torch.cuda.empty_cache()
        with tf32_off(torch):
            res[f"{key}_bitstream"], coder, images = phase_tree_bitstream(
                torch, numpy, pkg, counts, key, el, fit_steps)
            if key == "ezwt":
                res["coding_many"] = phase_coding_many(torch, pkg, counts,
                                                       coder, images, key)
            res[f"{key}_agent"], res[f"{key}_agent_test"] = phase_agent(
                torch, pkg, counts, CONFIG, dict(TREE_AGENT, entropy_layer=el),
                reckon_flagship_agent, reckon_coding, f"{key}_agent")
        del coder
        torch.cuda.empty_cache()

    with tf32_off(torch):
        res["quincunx_kernel"] = phase_quincunx_kernel(torch, F, conv, pkg)
    with tf32_off(torch, deterministic=True):
        res["quincunx_parity"] = phase_quincunx_parity(torch, numpy, pkg,
                                                       counts)
    with tf32_off(torch):
        res["quincunx_main"] = phase_quincunx_main(torch, numpy, pkg, counts)
        res["quincunx_bitstream"] = phase_quincunx_bitstream(torch, numpy,
                                                             pkg, counts)
        res["quincunx_agent"], res["quincunx_agent_test"] = \
            phase_quincunx_agent(torch, pkg, counts)
        res["alt"] = phase_alt_transforms(torch, numpy, pkg, counts)
    torch.cuda.empty_cache()

    v2_eval = [r for r in v2_rows if r["path"] == "eval"]
    v2_train = [r for r in v2_rows if r["path"] == "train"]

    def per_step(key, rows=rows):
        return sum(r[key] * r["launches_per_step"] for r in rows)

    emit({"phase": "kernel_per_step", "kernel": "conv3x3_halo",
          "dtype": "float32",
          "launches": sum(r["launches_per_step"] for r in rows),
          "tflop": per_step("gflop") / 1e3,
          "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
          "library_ms": per_step("library_ms"),
          "bound_ms": per_step("bound_ms"),
          "share_of_fp32_step": per_step("ms")
          / main_res["fp32_ms_per_step"]})
    emit({"phase": "kernel_per_train_step", "kernel": "conv3x3_halo",
          "dtype": "float32",
          "launches": 2 * sum(r["launches_per_step"] for r in bwd_rows),
          "tflop_each_of_fwd_dx_dk": per_step("gflop", bwd_rows) / 1e3,
          "fwd_ms": per_step("fwd_ms", bwd_rows),
          "dx_ms": per_step("dx_ms", bwd_rows),
          "dx_plain_ms": per_step("dx_plain_ms", bwd_rows),
          "dx_library_ms": per_step("dx_library_ms", bwd_rows),
          "dx_bound_ms": per_step("dx_bound_ms", bwd_rows),
          "dk_ms": per_step("dk_ms", bwd_rows),
          "dk_library_ms": per_step("dk_library_ms", bwd_rows),
          "dk_bound_ms": per_step("dk_bound_ms", bwd_rows)})
    emit({"phase": "conv_v2_per_step", "dtype": "bfloat16",
          "launches": sum(r["launches_per_step"] for r in v2_eval),
          "tflop": sum(r["gflop"] * r["launches_per_step"] for r in v2_eval)
          / 1e3,
          "ms": per_step("ms", v2_eval), "pad_ms": per_step("pad_ms", v2_eval),
          "plain_ms": per_step("plain_ms", v2_eval),
          "library_ms": per_step("library_ms", v2_eval),
          "bound_ms": per_step("bound_ms", v2_eval),
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
                             lift_rows, level_rows, res)
    ladders = [e for e in entries if e["name"] in ("lift97", "ilift97")]
    emit({"phase": "ladder_per_step", "dtype": "float32",
          "eval_step_ms": cdf_main["ms_per_step"],
          "train_step_ms": cdf_train["ms_per_step"],
          **{f"{e['name']}_{k}": e[k] for e in ladders
             for k in ("ms", "device_ms", "host_us_per_call", "plain_ms",
                       "bound_ms", "bound_1d_ms", "library_ms",
                       "three_pass_ms", "three_pass_device_ms",
                       "train_step_ms", "train_step_device_ms")},
          "share_of_eval_step": sum(e["ms"] for e in ladders)
          / cdf_main["ms_per_step"],
          "share_of_train_step": sum(e["train_step_ms"] for e in ladders)
          / cdf_train["ms_per_step"]})
    print(json.dumps({"kernels": entries}), flush=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
