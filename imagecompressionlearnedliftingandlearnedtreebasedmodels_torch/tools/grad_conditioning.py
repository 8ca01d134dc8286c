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

``--per-module`` finds the op behind a gap: for every module that holds a
weight it compares the module's output and the gradient at that output
(``dy``) with the float64 step's, for each fp32 step, and lists the
modules whose parameter gradients are furthest from float64 with those
gaps. A module whose output and ``dy`` agree with float64 while its own
gradients do not computed them badly itself; one whose ``dy`` is already
off inherits the gap from the ops after it. ``--no-cudnn`` runs the card
step with cuDNN off (PyTorch's own GPU convs) as a second card reading.

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
from torch import nn

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


@contextlib.contextmanager
def module_probe(model, store):
    """While active, ``store[name]`` collects ``(output, dy)`` in float64 on
    the CPU for every call of each module of ``model`` that holds a weight
    (``store`` None: nothing is recorded)."""
    handles = []

    def hook(name):
        def fwd(mod, inputs, out):
            rec = [out.detach().cpu().double(), None]
            store.setdefault(name, []).append(rec)
            if out.requires_grad:
                def grad(g):
                    rec[1] = g.detach().cpu().double()
                out.register_hook(grad)
        return fwd

    if store is not None:
        handles = [m.register_forward_hook(hook(n))
                   for n, m in model.named_modules()
                   if isinstance(getattr(m, "weight", None), nn.Parameter)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def grads_fp32(cfg, model, batch, device: str, store=None):
    step = state.make_train_step(cfg, model,
                                 state.make_optimizer(cfg, model), device)
    with module_probe(model, store):
        out, _ = step(batch, torch.Generator().manual_seed(NOISE_SEED), LR,
                      1.0)
    return float(out.loss), {n: p.grad.detach().cpu().double()
                             for n, p in model.named_parameters()}


def grads_f64(cfg, model, batch, store=None):
    model = model.double().train()
    with float64_patches(), module_probe(model, store):
        xs, xhat, info_xe, info_xo, aux = state.apply_color_forward(
            cfg, model, batch.double(), True,
            torch.Generator().manual_seed(NOISE_SEED))
        out = rd_loss3(xs, xhat, info_xe, info_xo, cfg.lambda_, 1.0)
        (out.loss + aux).backward()
    if out.loss.dtype != torch.float64:
        raise AssertionError("the reference step did not stay in float64")
    return float(out.loss.detach()), {n: p.grad.detach()
                                      for n, p in model.named_parameters()}


def _gap(got, want) -> float:
    got, want = torch.cat([t.reshape(-1) for t in got]), torch.cat(
        [t.reshape(-1) for t in want])
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-300)
            ).item()


def _flips(calls_got, calls_want) -> int:
    """Outputs on the other side of zero than float64's (where a LeakyReLU
    after the module takes the other slope)."""
    return sum(int(((g[0] > 0) != (w[0] > 0)).sum())
               for g, w in zip(calls_got, calls_want))


def total_flips(got: dict, want: dict) -> int:
    return sum(_flips(got[m], want[m]) for m in want
               if len(got.get(m, [])) == len(want[m]))


def module_gaps(got: dict, want: dict, errs: Dict[str, float],
                top: int = 8) -> list:
    """The ``top`` modules whose parameter gradients are furthest from
    float64, then every module beside the worst one (its parent's other
    children, in order), each with the gap of its output and of its
    ``dy``."""
    worst = {}
    for n, e in errs.items():
        mod = n.rsplit(".", 1)[0]
        worst[mod] = max(worst.get(mod, 0.0), e)
    ranked = sorted(worst, key=worst.get, reverse=True)[:top]
    parent = ranked[0].rsplit(".", 1)[0] + "."
    siblings = [m for m in worst if m.startswith(parent)
                and "." not in m[len(parent):] and m not in ranked]
    rows = []
    for mod in ranked + siblings:
        calls_got, calls_want = got.get(mod, []), want.get(mod, [])
        row = {"module": mod, "grad_gap": worst[mod],
               "calls": len(calls_want)}
        if calls_want and len(calls_got) == len(calls_want):
            row["output_gap"] = _gap([c[0] for c in calls_got],
                                     [c[0] for c in calls_want])
            row["sign_flips"] = _flips(calls_got, calls_want)
            if all(c[1] is not None for c in calls_got + calls_want):
                row["dy_gap"] = _gap([c[1] for c in calls_got],
                                     [c[1] for c in calls_want])
                row["dy_max_abs"] = max(c[1].abs().max().item()
                                        for c in calls_want)
        rows.append(row)
    return rows


def per_tensor_errors(got: Dict[str, torch.Tensor],
                      want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: ((got[n] - want[n]).abs().max() / want[n].abs().max()).item()
            for n in want}


def summary(errs: Dict[str, float]) -> dict:
    worst = max(errs, key=errs.get)
    return {"worst": worst, "worst_err": errs[worst],
            "tensors_over_1e-3": sum(e > 1e-3 for e in errs.values()),
            "tensors_over_1e-4": sum(e > 1e-4 for e in errs.values())}


def compare(cfg, kind: str, batch, use_card: bool, per_module: bool = False,
            no_cudnn: bool = False) -> dict:
    probes = ({}, {}, {}, {}) if per_module else (None,) * 4
    loss64, g64 = grads_f64(cfg, make_model(cfg, kind), batch, probes[0])
    loss_cpu, g_cpu = grads_fp32(cfg, make_model(cfg, kind), batch, "cpu",
                                 probes[1])
    e_cpu = per_tensor_errors(g_cpu, g64)
    res = {"weights": kind, "batch": list(batch.shape), "tensors": len(g64),
           "loss_f64": loss64, "loss_cpu32": loss_cpu,
           "cpu32_vs_f64": summary(e_cpu)}
    if per_module:
        res["cpu32_modules"] = module_gaps(probes[1], probes[0], e_cpu)
        res["cpu32_sign_flips"] = total_flips(probes[1], probes[0])
    if use_card and no_cudnn:
        torch.backends.cudnn.enabled = False
        try:
            _, g_nc = grads_fp32(cfg, make_model(cfg, kind), batch, "cuda",
                                 probes[3])
        finally:
            torch.backends.cudnn.enabled = True
        e_nc = per_tensor_errors(g_nc, g64)
        res["card32_no_cudnn_vs_f64"] = summary(e_nc)
        if per_module:
            res["card32_no_cudnn_modules"] = module_gaps(probes[3],
                                                         probes[0], e_nc)
            res["card32_no_cudnn_sign_flips"] = total_flips(probes[3],
                                                            probes[0])
    if use_card:
        loss_card, g_card = grads_fp32(cfg, make_model(cfg, kind), batch,
                                       "cuda", probes[2])
        e_card = per_tensor_errors(g_card, g64)
        e_both = per_tensor_errors(g_card, g_cpu)
        if per_module:
            res["card32_modules"] = module_gaps(probes[2], probes[0], e_card)
            res["card32_sign_flips"] = total_flips(probes[2], probes[0])
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
    ap.add_argument("--per-module", action="store_true",
                    help="each module's output and dy gaps (see above)")
    ap.add_argument("--no-cudnn", action="store_true",
                    help="also a card step with cuDNN off")
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
            print(json.dumps(compare(cfg, kind, batch, use_card,
                                     args.per_module, args.no_cudnn)),
                  flush=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = old
    return 0


if __name__ == "__main__":
    sys.exit(main())
