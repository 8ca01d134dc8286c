"""The post-processing training stage: a restoration net trained on top of
a frozen codec.

Counterpart of the JAX package's ``train/postprocess_loop.py``. The codec
runs its training forward (noise quantization, drawn from the step's
generator) without gradients; only the restoration net learns, on the MSE
of ``net(xhat + 0.5) - 0.5`` against the image (``rd_loss3`` with rate
weight 1, whose ``mse`` is the loss), with its own Adam at 1e-4 and a
plateau scheduler stepped on each epoch's mean MSE. BatchNorm statistics
update in training; the eval output is clipped to [-0.5, 0.5]. The
restoration weights are not part of the agent's checkpoint, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..config import Config, full_fp32, resolve_device
from ..models.postprocess import make_postprocess
from .loss import RDLossOutput, rd_loss3
from .state import PlateauScheduler, apply_color_forward

LR = 1e-4
SEED_OFFSET = 11       # the net's init is seeded from cfg.seed + 11


def make_postprocess_train_step(cfg: Config, codec_model: nn.Module,
                                pp_model: nn.Module,
                                optimizer: torch.optim.Optimizer,
                                device=None) -> Callable[..., RDLossOutput]:
    """``train_step(batch, generator, lr) -> RDLossOutput``: one optimizer
    step of ``pp_model`` (in place; its BatchNorm statistics updated) on
    NCHW RGB ``batch`` in [0, 1]; the codec's noise from ``generator``."""
    dev = resolve_device(device)
    full_fp32()
    codec_model.to(dev)
    pp_model.to(dev)

    def train_step(batch: torch.Tensor, generator: torch.Generator,
                   lr: float) -> RDLossOutput:
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        batch = batch.to(dev, torch.float32)
        with torch.no_grad():           # the codec is frozen
            xs, xhat, info_xe, info_xo, _ = apply_color_forward(
                cfg, codec_model, batch, True, generator)
        optimizer.zero_grad(set_to_none=True)
        restored = pp_model(xhat + 0.5, True) - 0.5
        out = rd_loss3(xs, restored, info_xe, info_xo, cfg.lambda_, 1.0)
        out.mse.backward()
        optimizer.step()
        return RDLossOutput(*(t.detach() for t in out))

    return train_step


def make_postprocess_eval_step(cfg: Config, codec_model: nn.Module,
                               pp_model: nn.Module, device=None
                               ) -> Callable[..., RDLossOutput]:
    """``eval_step(batch) -> RDLossOutput``: the codec's eval forward, the
    restoration net on its (unclipped) reconstruction with the running
    statistics, the result clipped to [-0.5, 0.5]."""
    dev = resolve_device(device)
    full_fp32()
    codec_model.to(dev)
    pp_model.to(dev)

    @torch.inference_mode()
    def eval_step(batch: torch.Tensor) -> RDLossOutput:
        batch = batch.to(dev, torch.float32)
        xs, xhat, info_xe, info_xo, _ = apply_color_forward(
            cfg, codec_model, batch)
        restored = torch.clamp(pp_model(xhat + 0.5, False) - 0.5, -0.5, 0.5)
        return rd_loss3(xs, restored, info_xe, info_xo, cfg.lambda_, 1.0)

    return eval_step


def train_postprocess(agent) -> nn.Module:
    """Run the stage on an initialized ``LiftingDWTAgent`` for
    ``cfg.max_epoch`` epochs; leaves the trained net in
    ``agent.pp_model`` and returns it."""
    cfg = agent.cfg
    pp_model = make_postprocess(
        cfg, generator=torch.Generator().manual_seed(cfg.seed + SEED_OFFSET))
    optimizer = torch.optim.Adam(pp_model.parameters(), lr=LR)
    scheduler = PlateauScheduler(lr=LR)
    train_step = make_postprocess_train_step(cfg, agent.model, pp_model,
                                             optimizer, agent.device)
    eval_step = make_postprocess_eval_step(cfg, agent.model, pp_model,
                                           agent.device)

    def nchw(batch):
        return torch.from_numpy(batch).permute(0, 3, 1, 2)

    for epoch in range(cfg.max_epoch):
        mses = []
        for batch in agent.data.train_batches(agent.data.steps_per_epoch(),
                                              seed=epoch):
            vals = tuple(float(v) for v in train_step(
                nchw(batch), agent.generator, scheduler.lr))
            mses.append(vals[1])
            agent.heartbeat.beat()
            agent.train_logger(*vals)
        agent.train_logger.display(lr=scheduler.lr, typ="tr")
        scheduler.step(float(np.mean(mses)))
        for batch in agent.data.valid_batches():
            out = eval_step(nchw(batch))
            agent.heartbeat.beat()
            agent.valid_logger(*(float(v) for v in out))
        agent.valid_logger.display(lr=0.0, typ="va")
    agent.pp_model = pp_model
    return pp_model
