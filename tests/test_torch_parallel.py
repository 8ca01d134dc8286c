"""The port's data parallelism (``parallel/mesh.py``, ``parallel/dp.py``)
and the agent on a mesh, on two gloo ranks on the CPU, spawned once for
the module's step checks (a ``FileStore`` under ``tmp_path``, no TCP
port):

- ``make_dp_train_step`` (shared noise) against the port's single-device
  step on the global batch, 3 Adam steps of a 2-level flagship (the loss
  terms of each, the first step's gradients); the two ranks' parameters
  equal to the bit after them; the first step's gradients against one
  process's of the same two batch slices, each with its slice of the
  noise, averaged;
- ``make_shardmap_train_step`` with the noise pinned to zero against the
  JAX package's on a 2-device sub-mesh of the 8 virtual devices (CDF97 +
  factorized, as ``tests/test_parallel.py``), from the same weights;
- ``make_dp_eval_step`` on a batch that divides the mesh and one that does
  not;
- the CLI with ``mesh_shape: [2]`` (2 ranks, 2 epochs), resumed as a
  single-device run, then ``mode: test``; ``dryrun_multichip(2)``.

Tolerances: the loss terms 1e-5 relative (fp32 sums of two halves); the
first step's gradients 1e-2 of each tensor's max |grad| and 1e-3 on the
global L2 (the card's gates for a train step; measured at most 4.6e-3,
in an entropy-model conv fed by the GDN outputs, whose sums over the
whole batch and over two halves part; the parameters after Adam
are no gauge: an element whose gradient is near zero, or a GDN term at its
lower bound whose gradient gate flips, moves by up to lr either way);
against the averaged slices, the same sums on one thread in another
process, 1e-6 of each tensor's max |grad|; against the JAX package the
loss 2e-5 relative and the parameters 1e-6 absolute and 1e-5 relative
(``tests/test_parallel.py``'s own).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    cli as pcli, config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.parallel import (
    dp as pdp, mesh as pmesh)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    checkpoint as pckpt, state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.config import (
    Config as JConfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    bottleneck as jbn)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.parallel import (
    dp as jdp, mesh as jmesh)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    state as jstate)

import test_torch_mesh_ranks as ranks
from test_torch_agent import TINY, tiny_cfg
from test_torch_codec import random_params, unflatten

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

DP_CFG = dict(TINY, batch_size=2)
SM_CFG = dict(netType="CDF97", entropy_layer="factorized", clrch=3,
              dwtlevels=2, lambda_=100.0, batch_size=2)


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    rng = np.random.RandomState(0)
    sm_batch = rng.rand(2, 32, 32, 3).astype(np.float32)
    jcfg = JConfig(**SM_CFG)
    sm_params = random_params(lambda: JCodec(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(sm_batch), False), 1)
    cases = {"dp_cfg": DP_CFG,
             "dp_batch": rng.rand(2, 3, 32, 32).astype(np.float32),
             "sm_cfg": SM_CFG, "sm_params": sm_params, "sm_batch": sm_batch,
             "eval_batches": [rng.rand(b, 3, 32, 32).astype(np.float32)
                              for b in (2, 1)]}
    out = tmp_path_factory.mktemp("parallel")
    pmesh.spawn(ranks.parallel_ranks, 2, "cpu", (str(out), cases),
                rendezvous_dir=str(out))
    res = {}
    for f in sorted(out.glob("*_rank*.pt")):
        name = f.name.rsplit("_rank", 1)[0]
        res.setdefault(name, []).append(torch.load(f, weights_only=False))
    res["cases"] = cases
    return res


def test_dp_train_step_equals_the_single_device_step(got):
    cfg = pconfig.Config(**DP_CFG).validate()
    model = ranks.seeded_codec(cfg, 0)
    step = pstate.make_train_step(cfg, model, pstate.make_optimizer(
        cfg, model), device="cpu")
    gen = torch.Generator().manual_seed(5)
    batch = torch.from_numpy(got["cases"]["dp_batch"])
    want = [tuple(step(batch, gen, 1e-3, 1.0)[0])]
    want_grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    want += [tuple(step(batch, gen, 1e-3, 1.0)[0]) for _ in range(2)]
    (outs0, grads0, sd0), (outs1, _, sd1) = got["dp_train"]
    for o0, o1, w in zip(outs0, outs1, want):
        for a, b, c in zip(o0, o1, w):
            assert float(a) == float(b)           # every rank: global terms
            np.testing.assert_allclose(float(a), float(c), rtol=1e-5)
    for k, g in want_grads.items():
        gap = float((grads0[k] - g).abs().max())
        assert gap <= 1e-2 * max(float(g.abs().max()), 1e-12), k
    l2 = torch.sqrt(sum(((grads0[k] - g) ** 2).sum()
                        for k, g in want_grads.items()))
    assert float(l2) <= 1e-3 * float(torch.sqrt(sum(
        (g ** 2).sum() for g in want_grads.values())))
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k    # the ranks agree to the bit


def test_dp_train_step_gradients_equal_the_averaged_slices(got):
    """The ranks' averaged gradients are the mean of each slice's own, so
    the exchange adds nothing but the one sum of two values."""
    from types import SimpleNamespace
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
        loss as ploss)
    cfg = pconfig.Config(**DP_CFG).validate()
    model = ranks.seeded_codec(cfg, 0).train()
    batch = torch.from_numpy(got["cases"]["dp_batch"])
    total = {}
    for r in range(2):
        model.zero_grad(set_to_none=True)
        noise = pdp.BatchSliceNoise(torch.Generator().manual_seed(5),
                                    SimpleNamespace(rank=r, size=2))
        xs, xhat, info_xe, info_xo, aux = pstate.apply_color_forward(
            cfg, model, batch[r:r + 1], True, noise)
        out = ploss.rd_loss3(xs, xhat, info_xe, info_xo, cfg.lambda_, 1.0)
        (out.loss + aux).backward()
        for k, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            total[k] = g.clone() if r == 0 else total[k] + g
    grads0 = got["dp_train"][0][1]
    for k, g in total.items():
        want = g / 2
        gap = float((grads0[k] - want).abs().max())
        assert gap <= 1e-6 * max(float(want.abs().max()), 1e-12), k


def test_shardmap_train_step_matches_jax(got, monkeypatch):
    monkeypatch.setattr(jbn, "quantize_noise", lambda x, rng=None: x)
    cases = got["cases"]
    jcfg = JConfig(**SM_CFG)
    model = JCodec(jcfg)
    tx = jstate.make_optimizer(jcfg)
    params = unflatten(cases["sm_params"])
    state = jstate.TrainState(params, tx.init(params), 0)
    mesh = jmesh.make_mesh(2)
    step, shard_state = jdp.make_shardmap_train_step(jcfg, model, tx, mesh)
    new_state, want, want_aux = step(
        shard_state(state), jnp.asarray(cases["sm_batch"]),
        jax.random.PRNGKey(2), jnp.asarray(1e-4), jnp.asarray(1.0))
    want_params = weights.flatten_params(jax.tree_util.tree_map(
        np.asarray, new_state.params))
    for out, aux, flat in got["shardmap"]:
        np.testing.assert_allclose(float(out[0]), float(want.loss),
                                   rtol=2e-5)
        for name in ("mse", "rate1", "rate2"):
            np.testing.assert_allclose(
                float(out[("loss", "mse", "rate1", "rate2").index(name)]),
                float(getattr(want, name)), rtol=2e-5, err_msg=name)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-5)
        assert set(flat) == set(want_params)
        for k, v in want_params.items():
            np.testing.assert_allclose(flat[k], v, atol=1e-6, rtol=1e-5,
                                       err_msg=k)


def test_dp_eval_step_shards_or_replicates(got):
    cfg = pconfig.Config(**DP_CFG).validate()
    ev = pstate.make_eval_step(cfg, ranks.seeded_codec(cfg, 0), device="cpu")
    for rank_outs in got["dp_eval"]:
        for out, b in zip(rank_outs, got["cases"]["eval_batches"]):
            want, _ = ev(torch.from_numpy(b))
            for a, w in zip(out, want):
                np.testing.assert_allclose(float(a), float(w), rtol=1e-5)


def test_cli_trains_on_a_mesh_and_resumes_on_one_device(tmp_path,
                                                        monkeypatch, caplog):
    """CDF97 + factorized with ``mesh_shape: [2]``: the CLI starts two gloo
    ranks (an epoch of 2
    steps, rank 0 saves); the run resumes as a single-device run from that
    checkpoint (no DDP ``module.`` prefix), then codes the test images in
    ``mode: test`` on the mesh again (rank 0 codes them)."""
    monkeypatch.chdir(tmp_path)
    images = tiny_cfg(tmp_path).valid_data
    raw = dict(TINY, exp_name="mesh", batch_size=2, mesh_shape=[2],
               netType="CDF97", entropy_layer="factorized",
               autoencoder="SubbandAutoEncoder", valid_data=images,
               test_data=images, test_patch_size=32)
    ckpt_dir = os.path.join("experiments", "mesh", "checkpoints")
    # the resumed run takes the saved epoch again, then the next one
    for mode, argv, kw, want in (
            ("train", [], dict(max_epoch=1), (0, 2)),
            ("train", ["--resume-training"], dict(mesh_shape=[1]), (1, 6)),
            ("test", [], {}, None)):
        with open("mesh.json", "w") as fh:
            json.dump(dict(raw, mode=mode, **kw), fh)
        with caplog.at_level("INFO", logger="lwc_torch"):
            assert pcli.main(["--device", "cpu", *argv, "mesh.json"]) == 0
        saved = pckpt.load_checkpoint(ckpt_dir)
        assert not any(k.startswith("module.") for k in saved["model"])
        if want:
            assert (saved["epoch"], saved["iteration"]) == want
    lines = [r.getMessage() for r in caplog.records]
    assert any("restored checkpoint 'checkpoint'" in ln for ln in lines)
    assert os.path.exists(os.path.join("experiments", "mesh", "logs",
                                       "exp_debug.log"))


def test_dryrun_multichip():
    pdp.dryrun_multichip(2, device="cpu")


def test_mesh_helpers_on_one_rank(tmp_path):
    """``shard_batch``/``row_block`` take a rank's share and refuse what
    does not divide; the backend rule names NCCL only with a card per
    rank."""
    mesh = pmesh.Mesh(None, 1, 2, torch.device("cpu"), "gloo")
    x = torch.arange(4 * 6).reshape(4, 1, 6, 1)
    assert torch.equal(pmesh.shard_batch(mesh, x), x[2:])
    assert torch.equal(pmesh.row_block(mesh, x), x[:, :, 3:])
    with pytest.raises(ValueError):
        pmesh.shard_batch(mesh, x[:3])
    assert pmesh.choose_backend(2, "cpu") == "gloo"
    if torch.cuda.device_count() < 2:
        assert pmesh.choose_backend(2, "cuda") == "gloo"
