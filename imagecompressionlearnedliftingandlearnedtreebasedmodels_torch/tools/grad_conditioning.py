"""How well conditioned are the fp32 gradients of one flagship train step?

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.grad_conditioning

One train step's gradients (same weights, batch and noise) are computed
three ways and compared per tensor as ``max |a - b| / max |b|``:

- ``f64``: the whole step in float64 on the CPU, the reference;
- ``cpu32``: the port's fp32 train step on the CPU (plain versions);
- ``card32``: the port's fp32 train step on the GPU (the hand-written conv
  kernel, cuDNN for the other layers, TF32 off, deterministic cuDNN), left
  out when there is no GPU or with ``--device cpu``.

It answers what limit a comparison of ``card32`` with ``cpu32`` can be held
to: no tighter than ``cpu32`` is to ``f64``. One JSON line per set of
weights (the committed lambda=2000 snapshot and seeded random weights).
``--entropy-layer onlyEZWT`` or ``DWTConditioned2EntropyLayerZTBlock``
takes the flagship config with that entropy model; its "snapshot" weights
are the snapshot's transform and the entropy model of the port's init with
seed 0 (as ``chip_smoke.py``'s tree phases build it).

The float64 step needs three things the port does not offer, so they are
patched in for its duration only: the dense 3x3 conv is a plain
``F.conv2d`` (the Function casts its operands to fp32 or bf16), the noise
is drawn in fp32 and widened (so it equals the fp32 steps' noise), and
``Tensor.float()`` leaves a float64 tensor as it is (the model calls it to
widen bf16 results).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_mod
from ..models import codec
from ..ops import fast_conv, math_utils
from ..train import data, state
from ..train.loss import rd_loss3
from . import weights

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SNAPSHOT = os.path.join(_REPO, "results", "ckpt_snapshots",
                        "flagship_lam2000.npz")
LR = 1e-4
WEIGHT_SEED, NOISE_SEED, IMAGE_SEED = 5, 3, 2


@contextlib.contextmanager
def float64_patches():
    """The three patches of the module docstring, undone on exit."""
    def noise(x, generator):
        u = torch.rand(x.shape, generator=generator, device=generator.device,
                       dtype=torch.float32)
        return (u - 0.5).to(x.device, x.dtype)

    to_float = torch.Tensor.float
    old = (fast_conv.conv3x3_halo, math_utils.uniform_noise)
    fast_conv.conv3x3_halo = lambda x, w, dtype: F.conv2d(x, w, padding=1)
    math_utils.uniform_noise = noise
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_float(t, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = to_float
        fast_conv.conv3x3_halo, math_utils.uniform_noise = old


def make_model(cfg, kind: str):
    if kind == "random":
        torch.manual_seed(WEIGHT_SEED)
        return codec.CodecWrapper(cfg)
    flat = weights.load_npz(SNAPSHOT)
    if cfg.entropy_layer == "conditioned2ZTsepSubbands":
        model = codec.CodecWrapper(cfg)
        weights.load_flax_params(model, flat)
        return model
    model = codec.CodecWrapper(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(weights.state_dict_from_flax(
        {k: v for k, v in flat.items() if "['transform']" in k}), strict=False)
    return model


def grads_fp32(cfg, model, batch, device: str):
    step = state.make_train_step(cfg, model,
                                 state.make_optimizer(cfg, model), device)
    out, _ = step(batch, torch.Generator().manual_seed(NOISE_SEED), LR, 1.0)
    return float(out.loss), {n: p.grad.detach().cpu().double()
                             for n, p in model.named_parameters()}


def grads_f64(cfg, model, batch):
    model = model.double().train()
    with float64_patches():
        xs, xhat, info_xe, info_xo, aux = state.apply_color_forward(
            cfg, model, batch.double(), True,
            torch.Generator().manual_seed(NOISE_SEED))
        out = rd_loss3(xs, xhat, info_xe, info_xo, cfg.lambda_, 1.0)
        (out.loss + aux).backward()
    if out.loss.dtype != torch.float64:
        raise AssertionError("the reference step did not stay in float64")
    return float(out.loss.detach()), {n: p.grad.detach()
                                      for n, p in model.named_parameters()}


def per_tensor_errors(got: Dict[str, torch.Tensor],
                      want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: ((got[n] - want[n]).abs().max() / want[n].abs().max()).item()
            for n in want}


def summary(errs: Dict[str, float]) -> dict:
    worst = max(errs, key=errs.get)
    return {"worst": worst, "worst_err": errs[worst],
            "tensors_over_1e-3": sum(e > 1e-3 for e in errs.values()),
            "tensors_over_1e-4": sum(e > 1e-4 for e in errs.values())}


def compare(cfg, kind: str, batch, use_card: bool) -> dict:
    loss64, g64 = grads_f64(cfg, make_model(cfg, kind), batch)
    loss_cpu, g_cpu = grads_fp32(cfg, make_model(cfg, kind), batch, "cpu")
    e_cpu = per_tensor_errors(g_cpu, g64)
    res = {"weights": kind, "batch": list(batch.shape), "tensors": len(g64),
           "loss_f64": loss64, "loss_cpu32": loss_cpu,
           "cpu32_vs_f64": summary(e_cpu)}
    if use_card:
        loss_card, g_card = grads_fp32(cfg, make_model(cfg, kind), batch,
                                       "cuda")
        e_card = per_tensor_errors(g_card, g64)
        e_both = per_tensor_errors(g_card, g_cpu)
        res.update(loss_card32=loss_card, card32_vs_f64=summary(e_card),
                   card32_vs_cpu32=summary(e_both),
                   largest_card32_vs_cpu32=[
                       {"tensor": n, "card32_vs_cpu32": e_both[n],
                        "card32_vs_f64": e_card[n], "cpu32_vs_f64": e_cpu[n]}
                       for n in sorted(e_both, key=e_both.get,
                                       reverse=True)[:8]])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu leaves the card32 step out")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=128, help="patch side")
    ap.add_argument("--weights", nargs="+", default=["snapshot", "random"],
                    choices=("snapshot", "random"))
    ap.add_argument("--entropy-layer", default="conditioned2ZTsepSubbands",
                    choices=config_mod.ENTROPY_LAYERS[1:])
    args = ap.parse_args(argv)

    use_card = args.device == "cuda"
    if use_card:
        config_mod.resolve_device()           # raises when there is no GPU
    cfg = config_mod.flagship_config(lambda_=2000.0, learning_rate=LR,
                                     entropy_layer=args.entropy_layer)
    imgs = data.synthetic_natural_images(args.batch, args.size,
                                         seed=IMAGE_SEED)
    batch = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).float() / 255.0

    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        for kind in args.weights:
            print(json.dumps(compare(cfg, kind, batch, use_card)), flush=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = old
    return 0


if __name__ == "__main__":
    sys.exit(main())
