"""Rank bodies of the port's multi-rank CPU tests (``test_torch_halo.py``,
``test_torch_parallel.py``); no tests of its own. Each runs in a spawned
gloo rank: it imports no JAX, computes its share of every case and writes
what it got to ``<outdir>/<name>_rank<r>.pt``, which the test process
compares against the JAX package and the port's single-device steps."""

import copy
import os

import numpy as np
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.transforms import (
    make_transform)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    dwt97)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.parallel import (
    dp, mesh as mesh_lib, tiling)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    state as pstate)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)


def seeded_codec(cfg, seed):
    """The port's seeded init with every bias (zero at init) moved by a
    seeded N(0, 0.05): the halo paths' edge masks exist for the conv
    biases, which must therefore not be zero."""
    model = CodecWrapper(cfg, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def halo_reference_codec(cfg, seed):
    """:func:`seeded_codec`, its learned lifting stages (where it has any)
    swapped for fp32 ones with the same weights: the single-device model
    that ``make_halo_eval_step`` computes, whose ladder runs in fp32
    whatever the config's dtype, as the JAX package's does. The subband
    AEs and the entropy model keep the config's dtype."""
    model = seeded_codec(cfg, seed)
    if cfg.netType != "LiftingBasedNeuralWaveletv4" or cfg.dtype == "float32":
        return model
    cfg32 = copy.copy(cfg)
    cfg32.dtype = "float32"
    codecs = [model.codec] if cfg.clrch == 3 else list(model.codecs)
    for codec in codecs:
        tr32 = make_transform(cfg32)
        tr32.load_state_dict(codec.transform.state_dict())
        codec.transform.stages = tr32.stages
        for i, stage in enumerate(tr32.stages):
            codec.transform.add_module(f"stages_{i}", stage)
    return model


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


def save(outdir, name, mesh, obj):
    torch.save(obj, os.path.join(outdir, f"{name}_rank{mesh.rank}.pt"))


def halo_ranks(mesh, outdir, cases):
    """Every halo case of ``test_torch_halo.py`` on this rank."""
    x = nchw(cases["x_rows"])
    save(outdir, "lift97_rows", mesh,
         tiling.halo_lift97_rows(mesh_lib.row_block(mesh, x), mesh))
    x = nchw(cases["x_dwt"])
    ll, highs = tiling.halo_dwt97_2d(mesh_lib.row_block(mesh, x), mesh, 2)
    back = tiling.halo_idwt97_2d(ll, highs, mesh)
    save(outdir, "dwt97_2d", mesh, (ll, highs, back))

    lcfg = pconfig.Config(**cases["lift_cfg"]).validate()
    tr = make_transform(lcfg)
    weights.load_flax_params(tr, cases["lift_params"])
    y = mesh_lib.row_block(mesh, nchw(cases["x_lift"]))
    with torch.no_grad():
        ll, highs = tiling.halo_lift2d_forward(lcfg, [tr], y, mesh)
        back = tiling.halo_lift2d_inverse(lcfg, [tr], ll, highs, mesh)
    save(outdir, "lift2d", mesh, (ll, highs, back))

    for name, (kw, seed, x_np) in cases["eval"].items():
        cfg = pconfig.Config(**kw).validate()
        step = tiling.make_halo_eval_step(cfg, seeded_codec(cfg, seed), mesh)
        out, xhat = step(nchw(x_np))
        save(outdir, f"eval_{name}", mesh, (tuple(out), xhat))

    cfg = pconfig.Config(**cases["bad_cfg"]).validate()
    step = tiling.make_halo_eval_step(cfg, seeded_codec(cfg, 0), mesh)
    refused = []
    for h in cases["bad_heights"]:
        try:
            step(torch.zeros(1, 3, h, 32))
        except ValueError as e:
            refused.append(str(e))
    save(outdir, "refused", mesh, refused)

    cfg = pconfig.Config(**cases["tiled_cfg"]).validate()
    got = tiling.tiled_forward(cfg, seeded_codec(cfg, 3), cases["x_tiled"],
                               4, mesh=mesh)
    save(outdir, "tiled", mesh, got)


def pin_noise():
    """Training quantization noise pinned to zero in the port."""
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
        bottleneck, gaussian, models)
    for mod in (bottleneck, gaussian, models):
        mod.quantize_noise = lambda x, generator=None: x


def parallel_ranks(mesh, outdir, cases):
    """The data-parallel cases of ``test_torch_parallel.py`` on this rank."""
    # make_dp_train_step: 3 steps of the global batch, shared noise
    cfg = pconfig.Config(**cases["dp_cfg"]).validate()
    model = seeded_codec(cfg, 0)
    opt = pstate.make_optimizer(cfg, model)
    step, shard_state = dp.make_dp_train_step(cfg, model, opt, mesh)
    shard_state()
    gen = torch.Generator().manual_seed(5)
    batch = torch.from_numpy(cases["dp_batch"])
    outs = [tuple(step(batch, gen, 1e-3, 1.0)[0])]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    outs += [tuple(step(batch, gen, 1e-3, 1.0)[0]) for _ in range(2)]
    save(outdir, "dp_train", mesh, (outs, grads, model.state_dict()))

    # make_shardmap_train_step with the noise pinned: one step from the
    # JAX package's weights
    pin_noise()
    cfg = pconfig.Config(**cases["sm_cfg"]).validate()
    model = CodecWrapper(cfg)
    weights.load_flax_params(model, cases["sm_params"])
    opt = pstate.make_optimizer(cfg, model)
    step, shard_state = dp.make_shardmap_train_step(cfg, model, opt, mesh)
    shard_state()
    out, aux = step(nchw(cases["sm_batch"]), dp.rank_generator(2, mesh),
                    1e-4, 1.0)
    save(outdir, "shardmap", mesh,
         (tuple(out), aux, weights.flax_params_from_state_dict(
             model.state_dict())))

    # make_dp_eval_step: a batch that divides the mesh and one that does not
    cfg = pconfig.Config(**cases["dp_cfg"]).validate()
    ev = dp.make_dp_eval_step(cfg, seeded_codec(cfg, 0), mesh)
    save(outdir, "dp_eval", mesh,
         [tuple(ev(torch.from_numpy(b))[0]) for b in cases["eval_batches"]])
