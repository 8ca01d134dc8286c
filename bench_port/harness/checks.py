"""What decides ``correct``: the plain reference run on the inputs the
benchmark made, and the numbers that compare the program's outputs with
it.

Eval cells compare one batch that the measured window produced, drawn from
the seed: ``rate_gap``, the larger gap of its two rates (LL and details) in
bits per pixel, and ``xhat_gap``, the batch's mean |xhat - reference xhat|
(a reconstruction is 0.5-centred RGB in [-0.5, 0.5]); the worst image's
mean (``xhat_image_gap``) and both sides' (loss, mse, rate1, rate2) are
reported beside them. Relative gaps of the terms do not separate a sound
run from the control: with seeded weights a rate can be a few hundredths
of a bit per pixel, where one rounding flip moves it by 1e-4 of itself,
and the loss and mse move as much under one flip as under TF32.

Train cells compare two calls of the train step: the set-up's first calls
(at least three steps, from the seeded state, through the same object the
window then drives), and one more call once the window has closed, from
the program's own state after the window (its parameters, Adam's moments
and step counts and the generator's state, read just before it), on a
chunk the window drew and never stepped. The reference follows that call
from the same state, so faults that show only from the second call on (a
replay that reuses its first noise, a static input that is not refilled)
are seen. For each call: ``loss_gap``, the largest relative gap of its
(loss, mse, rate1, rate2) rows; ``grad_gap`` and ``step_gap``, by the
worst leaf, the gap between the program's and the reference's norms of
Adam's first moment after the first call (one step: the first gradient
as the optimizer holds it; a chained call of k steps: its k gradients'
moving average) and of the parameters' change after all the checked
steps, each against the reference's norm of that leaf or of the median
leaf, whichever is larger (in the later call, the moment that the call
added, m_after - 0.9^k m_before, on both sides). Leaves whose reference
moment is under a thousandth of the median leaf's are left out of both
(their gradient is nought to rounding, so Adam moves them by round-off
alone). The same two gaps of the median leaf (``grad_gap_median``,
``step_gap_median``) are compared beside them: the worst leaf's gap swings
by two orders of magnitude from seed to seed, as the leaf most sensitive
to rounding changes, and the median leaf's does not, so the worst leaf's
limits catch a gross fault in one leaf and the median's a small one in
all. Each compared number is the larger of the two calls'.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..reference.model import rd_terms

SMALL_LEAF = 1e-3


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 convs and matmuls in full fp32, or (the control) in TF32."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32(torch.autograd.Function):
    """fp32 rounded to TF32's 10 mantissa bits, to nearest even; the
    gradient passes rounded alike."""

    @staticmethod
    def forward(ctx, t):
        return _round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    return _TF32.apply(t)


def lower_precision(ref) -> None:
    """Make ``ref`` the control: every conv's and product's operands
    rounded to TF32, as a TF32 kernel rounds them. The card's own TF32
    flags (:func:`precision`) do not reach its fp32 grouped convs or the
    bottleneck's narrow products, which run on FFMA kernels whatever they
    say, so the control rounds the operands itself."""
    for m in ref.modules():
        if hasattr(m, "operand_round"):
            m.operand_round = tf32_round


def _unit(u8: np.ndarray) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in [0, 1], divided in IEEE float32."""
    x = torch.from_numpy(np.ascontiguousarray(u8)).float() / 255.0
    return x.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def reference_eval(ref, x: torch.Tensor, lam: float, device, tf32=False):
    """(loss, mse, rate1, rate2) and clipped xhat of one batch."""
    with precision(tf32):
        xs, xhat, bits_xe, info = ref(x.to(device))
        xhat = torch.clamp(xhat, -0.5, 0.5)
        terms = rd_terms(xs, xhat, bits_xe, info, lam, 1.0)
    return [float(t) for t in terms], xhat


def reference_train(ref, chunks, gen_state, lr, rate_weight, lam, device,
                    tf32=False, batch_slice=slice(None), moment_after=1,
                    start=None, end=None):
    """Adam steps (betas 0.9, 0.999, eps 1e-8) on every batch of
    ``chunks`` (uint8 ``(k, B, P, P, 3)`` each), the noise drawn from a
    generator set to ``gen_state``. Returns the rows, {name: first moment}
    after ``moment_after`` steps and {name: parameters} after them all.
    ``batch_slice`` takes part of each batch (a fault's reading).

    ``start`` ({name: (parameter, first moment, second moment, steps
    taken)}, as :func:`adam_state` reads them) sets the parameters and
    Adam's state to go on from; ``end``, a dict, receives the same of the
    last step, and the generator's state under ``"generator"``."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    names = [n for n, _ in ref.named_parameters()]
    params = [p for _, p in ref.named_parameters()]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    taken = [0] * len(params)
    if start is not None:
        with torch.no_grad():
            for i, (n, p) in enumerate(zip(names, params)):
                q, mi, vi, t = start[n]
                p.copy_(q)
                m[i].copy_(mi)
                v[i].copy_(vi)
                taken[i] = int(t)
    b1, b2, eps = 0.9, 0.999, 1e-8
    rows, moments = [], None
    batches = [b for chunk in chunks for b in chunk]
    with precision(tf32):
        for t in range(1, len(batches) + 1):
            x = _unit(batches[t - 1][batch_slice]).to(device)
            xs, xhat, bits_xe, info = ref(x, True, gen)
            terms = rd_terms(xs, xhat, bits_xe, info, lam, rate_weight)
            grads = torch.autograd.grad(terms[0] + ref.aux_loss(), params,
                                        allow_unused=True)
            rows.append([float(x.detach()) for x in terms])
            with torch.no_grad():
                for i, (p, g, mi, vi) in enumerate(zip(params, grads, m, v)):
                    if g is None:
                        continue
                    taken[i] += 1
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = mi / (1 - b1 ** taken[i])
                    vhat = vi / (1 - b2 ** taken[i])
                    p.sub_(lr * mhat / (vhat.sqrt() + eps))
            if t == moment_after:
                moments = {n: x.detach().clone() for n, x in zip(names, m)}
    if end is not None:
        end.update({n: (p.detach(), mi, vi, t)
                    for n, p, mi, vi, t in zip(names, params, m, v, taken)})
        end["generator"] = gen.get_state()
    return rows, moments, {n: p.detach() for n, p in zip(names, params)}


def adam_state(model, opt) -> dict:
    """{name: (parameter, first moment, second moment, steps taken)} of
    the program's model and Adam optimizer, copied to the host (a
    parameter without state yet: zero moments, no steps)."""
    out = {}
    for n, p in model.named_parameters():
        st = opt.state.get(p, {})
        z = torch.zeros_like(p, device="cpu")
        out[n] = (p.detach().to("cpu", copy=True),
                  st["exp_avg"].detach().to("cpu", copy=True)
                  if "exp_avg" in st else z,
                  st["exp_avg_sq"].detach().to("cpu", copy=True)
                  if "exp_avg_sq" in st else z,
                  int(float(st["step"])) if "step" in st else 0)
    return out


def late_numbers(rows, before, after, ref_rows, ref_end, k) -> dict:
    """:func:`train_numbers` of one call of k steps that went on from the
    state ``before`` (as :func:`adam_state` reads it): the program's rows
    and state ``after`` it against the reference's (``ref_end``, its
    ``end``). The gradient is what the call added to the first moment,
    m_after - 0.9^k m_before, on both sides."""
    decay = 0.9 ** k
    dev = ref_end[next(iter(before))][0].device
    m0 = {n: before[n][1].to(dev) for n in before}
    moments = {n: after[n][1].to(dev) - decay * m0[n] for n in before}
    ref_moments = {n: ref_end[n][1] - decay * m0[n] for n in before}
    params = {n: after[n][0] for n in before}
    init = {n: before[n][0] for n in before}
    ref_params = {n: ref_end[n][0] for n in before}
    return train_numbers(rows, moments, params, init, ref_rows, ref_moments,
                         ref_params)


def merged(first: dict, late: dict) -> dict:
    """The compared numbers of both checked calls: each the larger of the
    two, and each call's own beside it."""
    out = {}
    for key in ("loss_gap", "grad_gap", "step_gap", "grad_gap_median",
                "step_gap_median"):
        a, b = first[key], late[key]
        out[key] = max(a, b) if math.isfinite(a) and math.isfinite(b) \
            else math.nan
    for tag, numbers in (("first", first), ("late", late)):
        for key, value in numbers.items():
            out[f"{key}_{tag}"] = value
    return out


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def eval_numbers(terms, xhat, ref_terms, ref_xhat) -> dict:
    rate = max(abs(a - b) for a, b in zip(terms[2:], ref_terms[2:]))
    diff = (xhat.to(ref_xhat.device, torch.float32) - ref_xhat).abs()
    per_image = diff.flatten(1).mean(1)
    return {"rate_gap": rate, "xhat_gap": float(diff.mean()),
            "xhat_image_gap": float(per_image.max()), "terms": list(terms),
            "ref_terms": list(ref_terms)}


def _leaf_gap(prog: dict, ref: dict, keep):
    """(the worst leaf's gap of norms, that leaf's name, the median
    leaf's gap)."""
    norms = {n: float(ref[n].double().norm()) for n in keep}
    med = float(np.median(list(norms.values())))
    worst, name, gaps = 0.0, None, []
    for n in keep:
        p = float(prog[n].double().norm())
        gap = abs(p - norms[n]) / max(norms[n], med, 1e-30)
        if not math.isfinite(gap):
            return math.nan, n, math.nan
        gaps.append(gap)
        if gap >= worst:
            worst, name = gap, n
    return worst, name, float(np.median(gaps))


def train_numbers(rows, moments, params, init, ref_rows, ref_moments,
                  ref_params) -> dict:
    """``init``: {name: parameters before the k steps}, on any device."""
    gaps = [_rel(a, b) for r, q in zip(rows, ref_rows) for a, b in zip(r, q)]
    loss = max(gaps) if all(math.isfinite(g) for g in gaps) else math.nan
    moments = {n: moments.get(n, torch.zeros_like(t))
               for n, t in ref_moments.items()}
    ref_m = {n: float(t.double().norm()) for n, t in ref_moments.items()}
    med = float(np.median(list(ref_m.values())))
    keep = [n for n, x in ref_m.items() if x >= SMALL_LEAF * med]
    grad, grad_leaf, grad_med = _leaf_gap(moments, ref_moments, keep)
    dev = next(iter(ref_params.values())).device
    change = {n: params[n].to(dev) - init[n].to(dev) for n in keep}
    ref_change = {n: ref_params[n] - init[n].to(dev) for n in keep}
    step, step_leaf, step_med = _leaf_gap(change, ref_change, keep)
    return {"loss_gap": loss, "grad_gap": grad, "step_gap": step,
            "leaves_left_out": len(ref_m) - len(keep),
            "grad_leaf": grad_leaf, "step_leaf": step_leaf,
            "grad_gap_median": grad_med, "step_gap_median": step_med}


def judged(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every number that has a limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passes(checks: dict) -> bool:
    return all(isinstance(c["value"], float) and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())
