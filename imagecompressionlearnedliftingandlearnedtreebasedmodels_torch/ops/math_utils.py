"""Math primitives shared by transforms and entropy models.

Counterparts of the JAX package's ``ops/math_utils.py``: the CDF 9/7
lifting coefficients, compressAI's ``LowerBound`` (with its pass-through
gradient, as a ``torch.autograd.Function``) and its mirror ``UpperBound``,
the non-negative reparametrization used by GDN, and the quantizers: hard
rounding (eval), additive uniform noise (training) and straight-through
rounding.

Training noise always comes from an explicit ``torch.Generator``. It is
drawn on the generator's own device and then moved to the tensor's, so a
CPU generator hands the same noise to a model on the CPU and to one on a
GPU.
"""

from __future__ import annotations

import torch

# CDF 9/7 (bior4.4) lifting coefficients: [alpha, beta, gamma, delta, nh, nl].
LIFTING_COEFF = (
    -1.586134342059924,   # alpha: predict 1
    -0.052980118572961,   # beta:  update 1
    0.882911075530934,    # gamma: predict 2
    0.443506852043971,    # delta: update 2
    0.869864451624781,    # nh: high-band gain
    1.149604398860241,    # nl: low-band gain
)


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound); the gradient passes where ``x >= bound`` or where it
    pushes x upward (compressAI's convention)."""
    return _LowerBound.apply(x, float(bound))


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x <= ctx.bound) | (g > 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """min(x, bound) with the mirrored gradient convention: the gradient
    passes where ``x <= bound`` or where it pushes x downward."""
    return _UpperBound.apply(x, float(bound))


# --- NonNegativeParametrizer (sqrt reparam + pedestal) --------------------
NNP_MINIMUM = 0.0
NNP_REPARAM_OFFSET = 2 ** -18


def nnp_pedestal() -> float:
    return NNP_REPARAM_OFFSET ** 2


def nnp_init(x: torch.Tensor) -> torch.Tensor:
    """Map an initial target value to reparametrized space."""
    return torch.sqrt(torch.clamp_min(x + nnp_pedestal(), nnp_pedestal()))


def nnp_apply(x: torch.Tensor) -> torch.Tensor:
    """Reparametrized value -> non-negative parameter."""
    bound = (NNP_MINIMUM + NNP_REPARAM_OFFSET ** 2) ** 0.5
    return lower_bound(x, bound) ** 2 - nnp_pedestal()


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) with a straight-through gradient."""
    return _SteRound.apply(x)


def uniform_noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """U(-0.5, 0.5) of x's shape and dtype, drawn on the generator's device
    and moved to x's."""
    if generator is None:
        raise ValueError("training noise needs an explicit torch.Generator")
    u = torch.rand(x.shape, generator=generator, device=generator.device,
                   dtype=x.dtype)
    return (u - 0.5).to(x.device)


def quantize_noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Additive-uniform-noise quantization surrogate (training)."""
    return x + uniform_noise(x, generator)


def quantize_dequantize(x: torch.Tensor, means=None) -> torch.Tensor:
    """Hard rounding around an optional mean (eval): round(x - mu) + mu.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    if means is None:
        return torch.round(x)
    return torch.round(x - means) + means


def quantize_symbols(x: torch.Tensor, means=None) -> torch.Tensor:
    """Integer symbols for entropy coding: round(x - mu) as int32."""
    if means is None:
        return torch.round(x).to(torch.int32)
    return torch.round(x - means).to(torch.int32)


def lifting_round(x: torch.Tensor, precision_bits: int,
                  generator=None) -> torch.Tensor:
    """Integer-lifting rounding. With ``precision_bits > 0`` training adds
    uniform noise of one grid step and eval rounds to the
    ``255 * 2**(bits-8)`` grid; ``generator is None`` selects the eval path."""
    if precision_bits <= 0:
        return x
    factor = 255.0 * (2.0 ** (precision_bits - 8))
    # times the fp32 reciprocal, not a division: XLA compiles the JAX
    # package's ``/ factor`` so, and a division differs in the last ulp of
    # about half the values
    inv = 1.0 / factor
    if generator is not None:
        return x + uniform_noise(x, generator) * inv
    return torch.round(x * factor) * inv


def lifting_add(base: torch.Tensor, x: torch.Tensor, precision_bits: int,
                sign: float = 1.0) -> torch.Tensor:
    """``base + sign * lifting_round(x)`` in eval, with the rounded value's
    scaling and the add as one exactly rounded multiply-add: XLA's CPU
    backend contracts the JAX package's ``base + round(x*f)/f`` into an FMA,
    and the separate product and sum differ from it in the last ulp of a
    third of the values. The product of the integer-valued ``round(x*f)``
    and the fp32 reciprocal is exact in float64, so the float64 sum rounded
    to fp32 is the FMA's result (on any device)."""
    if precision_bits <= 0:
        return base + sign * x
    factor = 255.0 * (2.0 ** (precision_bits - 8))
    inv = torch.tensor(1.0 / factor, dtype=torch.float32).item()
    r = torch.round(x * factor).double()
    return (base.double() + r * (sign * inv)).to(base.dtype)
