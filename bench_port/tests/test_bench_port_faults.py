"""The check fails a broken program: each cell's run driven on the CPU at
a tiny size with the timed path broken underneath comes out not correct,
once for each fault the cell can have (one card, so no exchange between
chips): a step that returns its state unchanged (train), half of the batch
left out with the mean taken over the rest, an answer altered where it is
produced; and, for the chained train step, two faults that leave its first
call sound and break every later one: the noise not advanced (a replay
that draws its first call's noise again) and the input not refilled (a
replay that trains on its first chunk again). The control (the reference
with TF32-rounded operands in the program's place) fails too."""

import pytest
import torch

from bench_port.harness import checks, port
from bench_port.harness.weights import seeded_reference
from bench_port.tests.small import rehearse

REAL_EVAL, REAL_TRAIN = port.eval_step, port.train_step


def eval_fault(kind):
    def make(cfg, model, device):
        inner = REAL_EVAL(cfg, model, device)

        def step(batch, lam=None):
            if kind == "half_batch":
                out, xhat = inner(batch[: batch.shape[0] // 2], lam)
                return out, torch.cat([xhat, xhat])
            out, xhat = inner(batch, lam)
            xhat = xhat.clone()
            xhat[0] += 1.0 / 255.0
            return out, xhat
        return step
    return make


def train_fault(kind):
    def make(cfg, model, device):
        inner, opt = REAL_TRAIN(cfg, model, device)

        first = {}

        def call(batches, gen, lr, rate_weight, lam=None):
            if kind in ("noise_not_advanced", "input_not_refilled"):
                if not first:
                    first.update(noise=gen.get_state(), batches=batches)
                elif kind == "noise_not_advanced":
                    gen.set_state(first["noise"])
                else:
                    batches = first["batches"]
                return inner(batches, gen, lr, rate_weight, lam)
            if kind == "half_batch":
                b = batches.shape[1] // 2
                return inner(batches[:, :b], gen, lr, rate_weight, lam)
            saved = [p.detach().clone() for p in model.parameters()]
            rows = inner(batches, gen, lr, rate_weight, lam).clone()
            if kind == "state_unchanged":
                with torch.no_grad():
                    for p, s in zip(model.parameters(), saved):
                        p.copy_(s)
                opt.state.clear()
            else:
                rows[-1, 0] *= 1.01
            return rows
        return call, opt
    return make


@pytest.mark.parametrize("cell,kind", [
    ("flagship_fp32.eval", "half_batch"),
    ("flagship_fp32.eval", "altered_answer"),
    ("cdf97_fp32.eval", "half_batch"),
    ("cdf97_fp32.eval", "altered_answer")])
def test_broken_eval_step_is_not_correct(monkeypatch, cell, kind):
    monkeypatch.setattr(port, "eval_step", eval_fault(kind))
    result, judged = rehearse(cell)
    assert not result["correct"], judged


@pytest.mark.parametrize("cell,kind", [
    ("flagship_fp32.train", k)
    for k in ("state_unchanged", "half_batch", "altered_answer",
              "noise_not_advanced", "input_not_refilled")])
def test_broken_train_step_is_not_correct(monkeypatch, cell, kind):
    monkeypatch.setattr(port, "train_step", train_fault(kind))
    result, judged = rehearse(cell)
    assert not result["correct"], judged
    if kind in ("noise_not_advanced", "input_not_refilled"):
        # the first call is sound: only the later call shows the fault
        numbers = result["numbers"]
        assert all(numbers[f"{n}_first"] <= judged[n]["limit"]
                   for n in judged), numbers
        assert any(numbers[f"{n}_late"] > judged[n]["limit"]
                   for n in judged), numbers


@pytest.mark.parametrize("cell", ["flagship_fp32.eval", "cdf97_fp32.eval"])
def test_control_eval_is_not_correct(monkeypatch, cell):
    """The reference with TF32 operands as the program: its terms and
    reconstruction are what the eval step returns."""
    def make(cfg, model, device):
        ref = seeded_reference(_cfg["model"], _cfg["seed"], device,
                               _cfg["weights"])
        checks.lower_precision(ref)

        @torch.no_grad()
        def step(batch, lam=None):
            xs, xhat, bits_xe, info = ref(batch)
            from bench_port.reference.model import rd_terms
            xhat = torch.clamp(xhat, -0.5, 0.5)
            return rd_terms(xs, xhat, bits_xe, info, lam or cfg.lambda_,
                            1.0), xhat
        return step

    from bench_port.harness import common
    from bench_port.tests import small
    seed = 2 ** 31 + 5
    params = common.workload(cell)
    model_cfg = common.model_config(params["config"])
    model_cfg.update(small.EVAL["config_overrides"])
    _cfg = {"model": model_cfg, "seed": seed,
            "weights": params.get("weights")}
    monkeypatch.setattr(port, "eval_step", make)
    result, judged = rehearse(cell, seed=seed)
    assert not result["correct"], judged


def test_control_train_is_not_correct():
    """The reference's k steps with TF32-rounded operands, in place of the
    program's, against the same steps in fp32."""
    from bench_port.harness import common
    from bench_port.tests import small
    from bench_port.traffic.generator import Traffic

    params = common.workload("flagship_fp32.train")
    tp = dict(params["traffic"], **small.TRAIN["traffic"])
    model_cfg = common.model_config(params["config"])
    model_cfg.update(small.TRAIN["config_overrides"])
    seed = 2 ** 31 + 9
    traffic = Traffic(tp, seed)
    chunks = [traffic.next() for _ in range(-(-3 // tp["steps_per_call"]))]
    gen = torch.Generator().manual_seed(5)
    args = (params["learning_rate"], params["rate_weight"],
            params["lambda"], "cpu")
    ref = seeded_reference(model_cfg, seed, "cpu")
    init = {n: p.detach().clone() for n, p in ref.named_parameters()}
    rows, m, p = checks.reference_train(ref, chunks, gen.get_state(), *args)
    low = seeded_reference(model_cfg, seed, "cpu")
    checks.lower_precision(low)
    l_rows, l_m, l_p = checks.reference_train(low, chunks, gen.get_state(),
                                              *args)
    numbers = checks.train_numbers(l_rows, l_m, l_p, init, rows, m, p)
    judged = checks.judged(numbers, params["limits"])
    assert not checks.passes(judged), judged
