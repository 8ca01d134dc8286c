"""The port's tracing (``utils/profiling.py``) on the CPU.

- ``span`` without a profiler is one shared null context; under one it is
  a user-annotation range of the trace, ``req`` in its name;
- the eval step of a small flagship records ``eval.step`` around
  ``codec.entropy`` around ``entropy.context`` and ``entropy.likelihood``;
  a small CDF97 step records the likelihoods and ``entropy.aux_loss`` and
  no context;
- a ``PlainChain`` call records ``chain.call`` around the three
  ``train.*`` phases of each step;
- ``device_phase`` records its event pair only inside ``record_phases``,
  and ``Counters`` keeps a replay's times only where it was traced and its
  events completed, dropping the others without waiting (stand-in
  events).
"""

import contextlib

import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    state as pstate)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.utils import (
    profiling as pprof)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

CDF97 = dict(netType="CDF97", entropy_layer="factorized",
             autoencoder="SubbandAutoEncoder", clrch=1, dwtlevels=2,
             lambda_=835.0, learning_rate=1e-4)


def ranges(prof):
    """(name, start_ns, end_ns) of every user-annotation range of a
    stopped profiler."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def named(rs, name):
    return [r for r in rs if r[0].split("#")[0] == name]


def batch(b=2, h=32, w=48, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        b, 3, h, w).astype(np.float32))


def traced_eval(cfg, calls=2):
    model = CodecWrapper(cfg, generator=torch.Generator().manual_seed(0))
    step = pstate.make_eval_step(cfg, model, "cpu")
    x = batch()
    step(x)      # a call before the profiler: the index counts on
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            step(x)
    return ranges(prof)


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = pprof.span("eval.step", req=4), pprof.span("other")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with pprof.device_phase("train.forward"):
        torch.ones(2).sum()     # no recording open: no events asked for
    assert pprof._recording is None


def test_flagship_eval_step_records_nested_spans():
    rs = traced_eval(pconfig.flagship_config(dwtlevels=2))
    steps = named(rs, "eval.step")
    assert sorted(r[0] for r in steps) == ["eval.step#1", "eval.step#2"]
    entropy = named(rs, "codec.entropy")
    assert len(entropy) == 2 * 3      # three YCbCr codecs a call
    for name in ("entropy.context", "entropy.likelihood"):
        found = named(rs, name)
        assert found, name
        assert all(any(inside(r, e) for e in entropy) for r in found), name
    assert all(any(inside(e, s) for s in steps) for e in entropy)
    # ZTsep at 2 levels: LL, coarsest and one finer level a codec
    assert len(named(rs, "entropy.context")) == 2 * 3 * 3
    for name in ("eval.upload", "color", "eval.loss", "codec.encode",
                 "codec.decode", "subband_ae.encode", "subband_ae.decode",
                 "conv3x3", "entropy.aux_loss"):
        found = named(rs, name)
        assert found and all(any(inside(r, s) for s in steps)
                             for r in found), name


def test_cdf97_eval_step_records_likelihoods_and_aux_loss():
    rs = traced_eval(pconfig.Config(**CDF97).validate(), calls=1)
    assert [r[0] for r in named(rs, "eval.step")] == ["eval.step#1"]
    assert not named(rs, "entropy.context")
    lik, aux = named(rs, "entropy.likelihood"), named(rs, "entropy.aux_loss")
    # a bottleneck a level and one for LL, in each of three codecs
    assert len(lik) == 3 * 3 and len(aux) == 3
    entropy = named(rs, "codec.entropy")
    assert all(any(inside(r, e) for e in entropy) for r in lik)
    # the aux loss is the wrapper's, after the codecs' entropy models
    assert not any(inside(a, e) for a in aux for e in entropy)


def test_plain_chain_call_records_the_train_phases():
    cfg = pconfig.Config(**dict(CDF97, batch_size=2, patch_size=32,
                                steps_per_call=2)).validate()
    model = CodecWrapper(cfg, generator=torch.Generator().manual_seed(0))
    step = pstate.make_chained_train_step(
        cfg, model, pstate.make_optimizer(cfg, model), device="cpu")
    assert step.form == "plain"
    chunk = np.random.RandomState(1).randint(0, 256, (2, 2, 32, 32, 3),
                                             dtype=np.uint8)
    gen = torch.Generator().manual_seed(3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(chunk, gen, 1e-4, 1.0)
    rs = ranges(prof)
    (call,) = named(rs, "chain.call")
    assert call[0] == "chain.call#0"
    for name in ("train.forward", "train.backward", "chain.upload"):
        found = named(rs, name)
        assert len(found) == 2 and all(inside(r, call) for r in found), name
    # Adam's update and the gradients' reset, a step each
    opt = named(rs, "train.optimizer")
    assert len(opt) == 4 and all(inside(r, call) for r in opt)
    for name in ("chain.scalars", "chain.rows"):
        assert len(named(rs, name)) == 1, name
    fwd, bwd = named(rs, "train.forward"), named(rs, "train.backward")
    assert fwd[0][2] <= bwd[0][1]


class Ev:
    """A stand-in timing event: complete or not, recorded at ``t`` ms."""

    def __init__(self, t, done=True):
        self.t, self.done, self.queries, self.recorded = t, done, 0, 0

    def query(self):
        self.queries += 1
        return self.done

    def elapsed_time(self, other):
        assert self.done and other.done, "read before complete"
        return other.t - self.t

    def record(self):
        self.recorded += 1


def phases(t0=0.0, done=True):
    """One step's three phases: 2, 5 and 1 ms."""
    ev = [Ev(t0 + t, done) for t in (0, 2, 2, 7, 7, 8)]
    return [("train.forward", ev[0], ev[1]),
            ("train.backward", ev[2], ev[3]),
            ("train.optimizer", ev[4], ev[5])]


def cpu_profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_counters_keep_only_traced_complete_replays():
    c = pprof.Counters()
    two_steps = phases() + phases(10.0)
    with cpu_profiler():
        c.replayed(two_steps, 2)
    c.replayed(phases(), 1)                   # settles the first; untraced
    late = phases(done=False)
    with cpu_profiler():
        c.replayed(phases(done=False), 1)
        c.replayed(late, 1)                   # the one before: dropped
    got = c.read()                            # the last: dropped too
    assert got["replays_timed"] == 1 and got["steps_timed"] == 2
    assert got["replays_dropped"] == 2
    assert got["phase_ms"] == {"train.forward": 4.0, "train.backward": 10.0,
                               "train.optimizer": 2.0}
    # nothing waited: each incomplete event was asked once, never read
    assert all(ev.queries <= 1 for _, s, e in late for ev in (s, e))
    assert c.read()["replays_dropped"] == 2   # settled once only


def test_counters_keep_captures_and_reset():
    c = pprof.Counters()
    rec = c.capture(capture_s=3.0, warmup_s=1.0, record_s=2.0,
                    launches={"conv3x3_halo.launches": 8})
    assert rec["record_s"] == 2.0
    got = c.read()
    assert got["captures"] == [rec] and got["captures"][0] is not rec
    assert got["phase_ms"] == {} and got["replays_timed"] == 0
    c.replayed(phases(), 1)     # no profiler records: not timed
    assert c.read()["replays_timed"] == 0
    with cpu_profiler():
        c.replayed(phases(), 1)
        c.replayed([], 1)       # a graph without timed phases
    assert c.read()["replays_timed"] == 1
    c.reset()
    assert c.read()["captures"] == [] and c.read()["steps_timed"] == 0


def test_device_phase_records_event_pairs_inside_record_phases(
        monkeypatch):
    made = []

    def event(enable_timing=False, external=False):
        assert enable_timing and external
        made.append(Ev(len(made)))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Event", event)
    with pprof.record_phases() as got:
        for name in ("train.forward", "train.backward"):
            with pprof.device_phase(name):
                pass
    assert pprof._recording is None
    assert [n for n, _, _ in got] == ["train.forward", "train.backward"]
    assert [e for _, s, e in got for e in (s, e)] == made
    assert all(e.recorded == 1 for e in made)
    with pprof.device_phase("train.optimizer"):
        pass
    assert len(made) == 4


@pytest.mark.parametrize("traced", [False, True])
def test_phase_timers_open_a_span(traced):
    t = pprof.PhaseTimers()
    ctx = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if traced
        else contextlib.nullcontext())
    with ctx as prof:
        with t.phase("data"):
            torch.ones(2).sum()
    assert t.counts["data"] == 1
    if traced:
        assert [r[0] for r in ranges(prof)] == ["data"]
