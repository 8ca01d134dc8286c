"""``steps_per_call``: the port's chained train step on the CPU
(``train/state.py::make_chained_train_step``, its plain form there; the
CUDA-graph form is held to eager steps in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``), the loader's chunks, the agent's chunked epoch, the
optimizer's two forms and their checkpoints, and the cached YCbCr shift.

- Against the JAX package's ``make_chained_train_step``: CDF97 +
  factorized, 2 levels, 32x32, B=2 (``tests/test_train_loop.py``'s
  config), k=4 uint8 batches, the weights carried by ``tools/weights.py``
  and the noise pinned to zero on both sides (the two frameworks draw other
  numbers from one seed). Rows and parameters within 2e-4 relative / 2e-5
  absolute, the JAX test's own tolerances for its chained step against its
  per-step one: fp32 sums in another order, compounded over 4 Adam steps.
- The flagship (2 levels, 32x32, noise from a seeded generator) chained
  against k ``make_train_step`` calls: rows and parameters equal to the
  bit (the same operations on the same inputs).
- The chained shardmap step on two gloo ranks: ``test_torch_parallel.py``.
"""

import copy
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    bottleneck as pbn, gaussian as pg, models as pem)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    color)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    data as pdata, loop as ploop, state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.config import (
    Config as JConfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    bottleneck as jbn)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    data as jdata, state as jstate)

from test_torch_agent import TINY, tiny_cfg
from test_torch_codec import random_params, unflatten

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

K = 4
CDF97 = dict(netType="CDF97", entropy_layer="factorized",
             autoencoder="SubbandAutoEncoder", clrch=3, dwtlevels=2,
             patch_size=32, batch_size=2, lambda_=100.0, learning_rate=1e-3,
             steps_per_epoch=4, max_epoch=1, training_loss_switch=1,
             steps_per_call=K)
FLAGSHIP = dict(TINY, batch_size=2, steps_per_call=3)


def u8_chunk(k, b, size):
    """``(k, b, size, size, 3)`` uint8, as ``tests/test_train_loop.py``
    makes its chained step's batches."""
    return np.stack([np.stack([pdata.synthetic_images(1, size,
                                                      seed=10 * i + j)[0]
                               for j in range(b)]) for i in range(k)])


def step_input(chunk, i):
    """Step ``i`` of a chunk as the agent hands it to ``make_train_step``:
    the loader's conversion, an NCHW view of NHWC memory."""
    return torch.from_numpy(chunk[i].astype(np.float32) / 255.0).permute(
        0, 3, 1, 2)


def seeded_codec(cfg):
    return PCodec(cfg, generator=torch.Generator().manual_seed(0))


def test_chained_step_matches_the_jax_chained_step(monkeypatch):
    monkeypatch.setattr(jbn, "quantize_noise", lambda x, rng=None: x)
    for mod in (pbn, pg, pem):
        monkeypatch.setattr(mod, "quantize_noise",
                            lambda x, generator=None: x)
    chunk = u8_chunk(K, 2, 32)
    jcfg = JConfig(**CDF97)
    jmodel = JCodec(jcfg)
    flat = random_params(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), False), 3)
    tx = jstate.make_optimizer(jcfg)
    params = unflatten(flat)
    state = jstate.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    chained = jstate.make_chained_train_step(jcfg, jmodel, tx)
    state, want = chained(state, jnp.asarray(chunk),
                          jax.random.split(jax.random.PRNGKey(11), K),
                          jnp.asarray(1e-3), jnp.asarray(1.0))
    want_params = weights.flatten_params(jax.tree_util.tree_map(
        np.asarray, state.params))

    cfg = pconfig.Config(**CDF97).validate()
    model = PCodec(cfg)
    weights.load_flax_params(model, flat)
    step = pstate.make_chained_train_step(
        cfg, model, pstate.make_optimizer(cfg, model), device="cpu")
    assert step.form == "plain"
    rows = step(chunk, torch.Generator().manual_seed(0), 1e-3, 1.0)
    assert rows.shape == (K, 4)
    np.testing.assert_allclose(rows.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    got = weights.flax_params_from_state_dict(model.state_dict())
    assert set(got) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_flagship_chained_step_equals_per_step_calls(dtype):
    """k per-step calls on the same batches with the same generator give
    the chained step's rows and parameters to the bit; a float chunk in
    [0, 1] is taken as it is."""
    cfg = pconfig.Config(**FLAGSHIP).validate()
    k = cfg.steps_per_call
    chunk = u8_chunk(k, 2, 32)
    given = chunk if dtype == "uint8" else chunk.astype(np.float32) / 255.0
    a = seeded_codec(cfg)
    b = copy.deepcopy(a)
    chained = pstate.make_chained_train_step(
        cfg, a, pstate.make_optimizer(cfg, a), device="cpu")
    step = pstate.make_train_step(cfg, b, pstate.make_optimizer(cfg, b),
                                  device="cpu")
    rows = chained(given, torch.Generator().manual_seed(5), 1e-4, 1.0,
                   lam=250.0)
    gen = torch.Generator().manual_seed(5)
    want = torch.tensor([[float(v) for v in step(step_input(chunk, i), gen,
                                                 1e-4, 1.0, 250.0)[0]]
                         for i in range(k)])
    assert torch.equal(rows, want)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    with pytest.raises(ValueError, match="uint8 or float32"):
        chained(chunk[:2], gen, 1e-4, 1.0)


def test_train_batches_chunks_equal_the_jax_loaders():
    kw = dict(batch_size=2, patch_size=24, seed=11, steps_per_epoch=0)
    pl = pdata.ImageDataLoader(pconfig.Config(**kw))
    jl = jdata.ImageDataLoader(JConfig(**kw))
    got = list(pl.train_batches(6, seed=3, chunk=3))
    want = list(jl.train_batches(6, seed=3, chunk=3))
    assert len(got) == 2 and got[0].shape == (3, 2, 24, 24, 3)
    assert got[0].dtype == np.uint8
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
    # the same patches, in the same order, as the per-step batches
    steps = list(pl.train_batches(6, seed=3))
    for i, batch in enumerate(steps):
        assert (got[i // 3][i % 3].astype(np.float32) / 255.0).tobytes() \
            == batch.tobytes()
    with pytest.raises(ValueError, match="not divisible"):
        next(pl.train_batches(5, chunk=2))


def test_unit_float_is_the_loaders_conversion():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 4, 4, 16)
    got = pstate.unit_float(torch.from_numpy(u8))
    assert got.dtype == torch.float32 and got.shape == u8.shape
    assert got.numpy().tobytes() == (u8.astype(np.float32) / 255.0).tobytes()
    x = torch.rand(2, 3)
    assert pstate.unit_float(x) is x


def _metrics(cfg):
    with open(os.path.join(cfg.summary_dir, "metrics.jsonl")) as fh:
        return [{k: v for k, v in json.loads(ln).items() if k != "elapsed"}
                for ln in fh]


def test_agent_chunked_epoch_matches_per_step_dispatch(tmp_path):
    """An epoch of 4 steps in chunks of 2 (the loss switch armed to flip at
    the first print, after step 2): the iteration count and every logged
    row as with ``steps_per_call=1``, in 2 dispatches instead of 4."""
    runs = {}
    for k in (1, 2):
        cfg = tiny_cfg(tmp_path / f"k{k}", steps_per_epoch=4, max_epoch=1,
                       loss_prnt_iters=2, steps_per_call=k,
                       training_loss_switch=0, loss_switch_thr=1.0)
        agent = ploop.LiftingDWTAgent(cfg, device="cpu")
        assert (agent.chained_step is None) == (k == 1)
        agent.run()
        assert agent.current_iteration == 4
        assert agent.timers.counts["step"] == 4 // k
        assert agent.loss_switch.rate_on
        runs[k] = (_metrics(cfg), agent.model.state_dict())
    (rows1, sd1), (rows2, sd2) = runs[1], runs[2]
    assert [r["typ"] for r in rows1] == ["it", "it", "tr", "va"]
    assert rows1 == rows2
    for name, v in sd1.items():
        assert torch.equal(v, sd2[name]), name
    # k that divides the epoch but not the print window: step by step
    agent = ploop.LiftingDWTAgent(
        tiny_cfg(tmp_path / "odd", steps_per_epoch=5, loss_prnt_iters=2,
                 steps_per_call=2), device="cpu")
    assert agent._chunk_size(5) == 1 and agent._chunk_size(4) == 2
    assert agent._chunk_size(6) == 2


def through_a_file(obj):
    """``obj`` saved and loaded again, as a checkpoint carries it (a state
    dict holds the optimizer's own tensors, not copies)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=False)


def test_optimizer_state_moves_between_the_two_forms():
    """A plain Adam's state loads into a capturable one (its learning-rate
    tensor kept and given the saved rate, its step counts on the
    parameters' device) and back into a plain one (floats, step counts on
    the CPU), which then steps exactly as the Adam that wrote it."""
    cfg = pconfig.Config(**CDF97).validate()
    a = seeded_codec(cfg)
    plain = pstate.make_optimizer(cfg, a)
    step = pstate.make_train_step(cfg, a, plain, device="cpu")
    chunk = u8_chunk(3, 2, 32)
    gen = torch.Generator().manual_seed(1)
    for i in range(2):
        step(step_input(chunk, i), gen, 3e-4, 1.0)
    b = copy.deepcopy(a)

    capt = pstate.make_optimizer(cfg, b, capturable=True)
    lr = capt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and capt.param_groups[0]["capturable"]
    pstate.load_optimizer_state(capt, through_a_file(plain.state_dict()))
    assert capt.param_groups[0]["lr"] is lr and lr.dtype == torch.float32
    assert float(lr) == float(np.float32(3e-4))
    assert capt.param_groups[0]["capturable"]
    for p, st in capt.state.items():
        assert st["step"].device == p.device and float(st["step"]) == 2.0
        assert st["step"].dtype == torch.float32

    back = pstate.make_optimizer(cfg, b)
    pstate.load_optimizer_state(back, through_a_file(capt.state_dict()))
    group = back.param_groups[0]
    assert not group["capturable"] and group["lr"] == pytest.approx(3e-4)
    assert isinstance(group["lr"], float)
    old = plain.state_dict()["state"]
    for i, st in back.state_dict()["state"].items():
        assert st["step"].device.type == "cpu" and float(st["step"]) == 2.0
        assert torch.equal(st["exp_avg"], old[i]["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], old[i]["exp_avg_sq"])
    again = pstate.make_train_step(cfg, b, back, device="cpu")
    for s in (step, again):
        s(step_input(chunk, 2), torch.Generator().manual_seed(2), 3e-4, 1.0)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name


def test_cached_ycbcr_shift_keeps_eval_and_train_bit_equal(monkeypatch):
    """The shift is one constant per dtype and device; the flagship's eval
    step and a train step give the same bits as with a tensor made at
    every call (the form before the cache)."""
    x = torch.rand(2, 3, 8, 8)
    assert color._shift(x) is color._shift(x.clone())
    assert color._shift(x.double()).dtype == torch.float64
    cfg = pconfig.Config(**FLAGSHIP).validate()
    batch = step_input(u8_chunk(1, 2, 32), 0)

    def run():
        model = seeded_codec(cfg)
        out, xhat = pstate.make_eval_step(cfg, model, "cpu")(batch)
        step = pstate.make_train_step(cfg, model, pstate.make_optimizer(
            cfg, model), "cpu")
        terms, _ = step(batch, torch.Generator().manual_seed(4), 1e-4, 1.0)
        return [*out, xhat, *terms, *model.parameters()]

    cached = run()
    monkeypatch.setattr(color, "_shift", lambda like: torch.tensor(
        color.YCBCR_SHIFT, dtype=like.dtype, device=like.device).view(
        1, 3, 1, 1))
    per_call = run()
    assert len(cached) == len(per_call)
    for a, b in zip(cached, per_call):
        assert torch.equal(a.detach(), b.detach())
