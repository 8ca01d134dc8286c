"""Data-parallel training and evaluation over a :class:`..mesh.Mesh`.

Counterpart of the JAX package's ``parallel/dp.py``. Every rank holds the
whole model (the parameters are replicated: :func:`..mesh.replicate` at the
start, and the same averaged gradients into the same Adam after that), is
handed the global batch and computes on its slice of it. The gradients are
averaged over the ranks before the optimizer step by one all-reduce of a
flat bucket per dtype; the loss terms and the aux loss are averaged too, so
every rank reports the global batch's values.

- :func:`make_dp_train_step`: every rank draws the whole batch's noise from
  one generator seeded alike on all ranks and keeps its slice, so the step
  equals the single-device step on the global batch (as the JAX package's
  GSPMD form does).
- :func:`make_shardmap_train_step` (the agent's path): each rank draws its
  slice's noise from its own generator, seeded from (seed, rank) by
  :func:`rank_generator`: the counterpart of ``fold_in(rng, axis_index)``.
- :func:`make_dp_eval_step`: the batch sharded where it divides the mesh,
  replicated otherwise.
- :func:`dryrun_multichip`: one step of each train form on ``n`` new
  ranks, the counterpart of ``__graft_entry__.dryrun_multichip``.

``make_chained_shardmap_train_step`` is not ported: it hides a TPU's
dispatch latency, and every step here is dispatched on its own.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import Config, full_fp32
from ..train.loss import RDLossOutput, rd_loss3
from ..train.state import apply_color_forward
from . import mesh as mesh_lib
from .mesh import Mesh


class BatchSliceNoise:
    """A noise source for :func:`..ops.math_utils.uniform_noise` that draws
    the global batch's noise (``world`` times the local batch) from a
    generator that every rank holds in the same state, and hands back this
    rank's slice."""

    def __init__(self, generator: torch.Generator, mesh: Mesh):
        self.generator, self.mesh = generator, mesh
        self.device = generator.device

    def draw(self, shape, dtype) -> torch.Tensor:
        b = shape[0]
        u = torch.rand((b * self.mesh.size,) + tuple(shape[1:]),
                       generator=self.generator, device=self.device,
                       dtype=dtype)
        return u[self.mesh.rank * b:(self.mesh.rank + 1) * b]


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """This rank's noise generator, on its device, seeded from (seed,
    rank)."""
    state = np.random.SeedSequence([int(seed), mesh.rank]).generate_state(1)
    return torch.Generator(device=mesh.device).manual_seed(int(state[0]))


@torch.no_grad()
def average_gradients(mesh: Mesh, params) -> None:
    """Replace every parameter's gradient by its mean over the ranks: one
    all-reduce of a flat bucket per dtype. A parameter that took no
    gradient on this rank joins with zeros."""
    buckets = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        buckets.setdefault(p.grad.dtype, []).append(p)
    for group in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        offset = 0
        for p in group:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


def mean_over_ranks(mesh: Mesh, values) -> torch.Tensor:
    """The mean over ranks of a few scalars, as one stacked tensor."""
    t = torch.stack([v.detach().float().reshape(()) for v in values])
    dist.all_reduce(t, group=mesh.group)
    return t / mesh.size


def _make_step(cfg: Config, model: nn.Module,
               optimizer: torch.optim.Optimizer, mesh: Mesh,
               noise: Callable) -> Callable:
    full_fp32()
    model.to(mesh.device)
    params = list(model.parameters())
    loss_scale = 1.0 / max(cfg.grad_acc_iters, 1)

    def step(batch: torch.Tensor, generator, lr: float, rate_weight: float,
             lam: Optional[float] = None
             ) -> Tuple[RDLossOutput, torch.Tensor]:
        if lam is None:
            lam = cfg.lambda_
        model.train()
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        local = mesh_lib.shard_batch(mesh, batch).to(mesh.device,
                                                     torch.float32)
        optimizer.zero_grad(set_to_none=True)
        xs, xhat, info_xe, info_xo, aux = apply_color_forward(
            cfg, model, local, True, noise(generator))
        out = rd_loss3(xs, xhat, info_xe, info_xo, lam, rate_weight)
        ((out.loss + aux) * loss_scale).backward()
        average_gradients(mesh, params)
        optimizer.step()
        m = mean_over_ranks(mesh, (*out, aux))
        return RDLossOutput(*m[:4]), m[4]

    return step


def shard_state_fn(mesh: Mesh, model: nn.Module) -> Callable[[], None]:
    """``shard_state()``: rank 0's parameters and buffers broadcast to every
    rank (the JAX package replicates its state the same way)."""
    def shard_state():
        model.to(mesh.device)
        mesh_lib.replicate(mesh, list(model.parameters())
                           + list(model.buffers()))
    return shard_state


def make_dp_train_step(cfg: Config, model: nn.Module,
                       optimizer: torch.optim.Optimizer, mesh: Mesh):
    """``(dp_step, shard_state)``. ``dp_step(batch, generator, lr,
    rate_weight, lam=None) -> (RDLossOutput, aux)`` takes the global batch
    and a generator in the same state on every rank; the result equals
    :func:`..train.state.make_train_step`'s on the global batch."""
    step = _make_step(cfg, model, optimizer, mesh,
                      lambda g: BatchSliceNoise(g, mesh))
    return step, shard_state_fn(mesh, model)


def make_shardmap_train_step(cfg: Config, model: nn.Module,
                             optimizer: torch.optim.Optimizer, mesh: Mesh):
    """``(dp_step, shard_state)`` with the same call, but each rank's noise
    comes from its own ``generator`` (:func:`rank_generator`): independent
    quantization noise per shard, as the JAX package's shard_map step
    folds the axis index into its key."""
    step = _make_step(cfg, model, optimizer, mesh, lambda g: g)
    return step, shard_state_fn(mesh, model)


def make_dp_eval_step(cfg: Config, model: nn.Module, mesh: Mesh):
    """``eval_step(batch, lam=None) -> (RDLossOutput, xhat)`` over the mesh:
    the global batch sharded where its size divides the mesh (the loss
    terms averaged over the ranks, ``xhat`` this rank's slice), replicated
    otherwise (every rank computes the whole batch)."""
    from ..train.state import make_eval_step

    base = make_eval_step(cfg, model, mesh.device)

    def eval_step(batch: torch.Tensor, lam: Optional[float] = None):
        if batch.shape[0] % mesh.size:
            return base(batch, lam)
        out, xhat = base(mesh_lib.shard_batch(mesh, batch), lam)
        return RDLossOutput(*mean_over_ranks(mesh, out)), xhat

    return eval_step


def _dryrun_rank(mesh: Mesh, n: int) -> None:
    from ..config import flagship_config
    from ..models.codec import CodecWrapper
    from ..train.state import make_optimizer

    cfg = flagship_config(dwtlevels=2, batch_size=n, patch_size=32,
                          mesh_shape=(n,))
    model = CodecWrapper(cfg, generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(cfg, model)
    batch = torch.rand(n, 3, 32, 32, generator=torch.Generator()
                       .manual_seed(1))
    step, shard_state = make_dp_train_step(cfg, model, opt, mesh)
    shard_state()
    gen = torch.Generator(device=mesh.device).manual_seed(2)
    out, _ = step(batch, gen, cfg.learning_rate, 1.0)
    step2, _ = make_shardmap_train_step(cfg, model, opt, mesh)
    out2, _ = step2(batch, rank_generator(3, mesh), cfg.learning_rate, 1.0)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    parts = mesh_lib.all_gather(mesh, flat)
    if not all(torch.equal(parts[0], p) for p in parts):
        raise AssertionError("dryrun_multichip: the ranks' parameters differ "
                             "after two data-parallel steps")
    if not (torch.isfinite(out.loss) and torch.isfinite(out2.loss)):
        raise AssertionError("dryrun_multichip: non-finite loss")
    if mesh.rank == 0:
        print(f"dryrun_multichip ok: {n} ranks ({mesh.backend}, "
              f"{mesh.device}), loss={float(out.loss):.4f} then "
              f"{float(out2.loss):.4f}", flush=True)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One data-parallel train step of each form on a reduced flagship
    (2 levels, 32x32 patches, one per rank) over ``n_devices`` new ranks,
    on the card unless ``device`` names the CPU; raises unless the loss is
    finite and the ranks end with the same parameters, to the bit."""
    from ..config import resolve_device

    mesh_lib.spawn(_dryrun_rank, n_devices, resolve_device(device).type,
                   (n_devices,))
