"""Training state: optimizer, train and eval steps, host-side controllers.

The entry points of the port (each turns TF32 off: ``config.full_fp32``).
:func:`make_eval_step` serves (hard rounding,
bits from the likelihoods, ``xhat`` clipped to [-0.5, 0.5], then
``rd_loss3``). :func:`make_train_step` takes one optimizer step on the
noise-quantized surrogate. The state lives where PyTorch keeps it: in the
model's parameters and the optimizer. The plateau scheduler and the
D-only -> R+lambda*D loss switch are small host-side controllers that feed
scalars (learning rate, rate weight) into the step, as in the JAX package's
``train/state.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..config import Config, full_fp32, resolve_device
from ..ops import color
from .loss import RDLossOutput, rd_loss3


def apply_color_forward(cfg: Config, model: nn.Module, x: torch.Tensor,
                        training: bool = False, generator=None):
    """Color policy + model forward; x is NCHW RGB in [0,1].

    Returns the shifted ``(x', xhat')`` in [-0.5, 0.5], the info tensors and
    the aux loss. ``training`` selects noise quantization, drawn from
    ``generator``.
    """
    if cfg.clrch == 3:
        xs = x - 0.5
        xhat, info_xe, info_xo, aux = model(xs, training, generator)
        return xs, xhat, info_xe, info_xo, aux
    y = color.shift_ycbcr(color.rgb_to_ycbcr(x))
    yhat, info_xe, info_xo, aux = model(y, training, generator)
    xhat = color.ycbcr_to_rgb(color.unshift_ycbcr(yhat))
    return x - 0.5, xhat - 0.5, info_xe, info_xo, aux


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.Adam:
    """Adam with its defaults (betas 0.9/0.999, eps 1e-8: ``optax.adam``'s
    too). The learning rate is adjustable at run time: the train step writes
    the plateau scheduler's current rate into ``param_groups[*]['lr']``."""
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)


def make_train_step(cfg: Config, model: nn.Module,
                    optimizer: torch.optim.Optimizer, device=None
                    ) -> Callable[..., Tuple[RDLossOutput, torch.Tensor]]:
    """Move ``model`` to ``device`` (CUDA unless the caller passes another;
    raises when none is available) and return
    ``train_step(batch, generator, lr, rate_weight, lam=None) ->
    (RDLossOutput, aux)``: one optimizer step, in place.

    ``batch`` is NCHW RGB in [0, 1]; ``generator`` gives the quantization
    noise; ``rate_weight`` (0.0 or 1.0) implements the loss switch; ``lr``
    is the plateau scheduler's current rate; ``lam`` defaults to
    ``cfg.lambda_`` and is a runtime value. The ``grad_acc_iters`` quirk of
    the original (loss divided by the divisor but the optimizer stepped
    every iteration) is reproduced by the 1/k loss scale. The aux loss is
    added to the loss; the returned terms are detached.
    """
    dev = resolve_device(device)
    full_fp32()
    model.to(dev)
    loss_scale = 1.0 / max(cfg.grad_acc_iters, 1)

    def train_step(batch: torch.Tensor, generator: torch.Generator, lr: float,
                   rate_weight: float, lam: Optional[float] = None):
        if lam is None:
            lam = cfg.lambda_
        model.train()
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        batch = batch.to(dev, torch.float32)
        optimizer.zero_grad(set_to_none=True)
        xs, xhat, info_xe, info_xo, aux = apply_color_forward(
            cfg, model, batch, True, generator)
        out = rd_loss3(xs, xhat, info_xe, info_xo, lam, rate_weight)
        ((out.loss + aux) * loss_scale).backward()
        optimizer.step()
        return RDLossOutput(*(t.detach() for t in out)), aux.detach()

    return train_step


def make_eval_step(cfg: Config, model: nn.Module, device=None
                   ) -> Callable[..., Tuple[RDLossOutput, torch.Tensor]]:
    """Move ``model`` to ``device`` (CUDA unless the caller passes another;
    raises when none is available) and return
    ``eval_step(batch, lam=None) -> (RDLossOutput, xhat)``.

    ``batch`` is NCHW RGB in [0, 1]; it is moved to the device. ``xhat`` is
    the clipped reconstruction in [-0.5, 0.5].
    """
    dev = resolve_device(device)
    full_fp32()
    model.to(dev)

    @torch.inference_mode()
    def eval_step(batch: torch.Tensor, lam: Optional[float] = None):
        if lam is None:
            lam = cfg.lambda_
        model.eval()
        batch = batch.to(dev, torch.float32)
        xs, xhat, info_xe, info_xo, _ = apply_color_forward(
            cfg, model, batch)
        xhat = torch.clamp(xhat, -0.5, 0.5)
        return rd_loss3(xs, xhat, info_xe, info_xo, lam, 1.0), xhat

    return eval_step


@dataclasses.dataclass
class PlateauScheduler:
    """Host-side ReduceLROnPlateau (factor 0.5, patience 5, relative
    threshold 1e-4, min_lr 1e-6)."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 1e-6
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d):
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]


@dataclasses.dataclass
class LossSwitchController:
    """Host-side D-only -> R+lambda*D switch: once the windowed training MSE
    drops below ``threshold``, the rate term turns on for good."""

    enabled: bool          # training_loss_switch == 0 means "start D-only"
    threshold: float

    def __post_init__(self):
        self.rate_on = not self.enabled

    def rate_weight(self) -> float:
        return 1.0 if self.rate_on else 0.0

    def observe_window_mse(self, mse: float) -> None:
        if not self.rate_on and mse < self.threshold:
            self.rate_on = True

    def state_dict(self):
        return {"rate_on": self.rate_on}

    def load_state_dict(self, d):
        self.rate_on = d["rate_on"]
