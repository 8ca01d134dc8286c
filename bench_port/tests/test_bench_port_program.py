"""The readers of the program's own spans and counters
(``harness/program.py`` and the metrics that use it): each on a synthetic
trace and a stand-in registry, each silent where the program has no such
span or counter, and a traced CPU rehearsal of both eval cells in which
the program's spans reach the view."""

import pytest
import torch

from bench_port.harness import program, trace
from bench_port.harness.trace import WINDOW, TraceView
from bench_port.tests.small import rehearse, run_module

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.utils import (
    profiling as pprof)

NEW = ["entropy_context_ms.eval", "entropy_likelihood_ms.eval",
       "step_host_ms.eval", "call_host_ms.train", "forward_ms.train",
       "backward_ms.train", "optimizer_ms.train", "graph_record_s.train"]


def reader(name):
    return run_module().load_reader(name)


def view(requests=2):
    """Window 0..200: two eval calls; kernels (name, start, end, corr)."""
    device = [("plc", 20, 40, 1), ("cgp", 40, 45, 2), ("lik", 45, 55, 3),
              ("plc", 120, 140, 4), ("lik", 140, 150, 5),
              ("ae", 150, 160, 6), ("late", 230, 240, 7)]
    annotations = [
        (WINDOW, 0, 200), ("bench.step", 5, 70), ("eval.step#7", 6, 66),
        ("codec.entropy", 10, 60), ("entropy.context", 12, 30),
        ("entropy.likelihood", 31, 40), ("bench.step", 100, 190),
        ("eval.step#8", 101, 187), ("codec.entropy", 110, 160),
        ("entropy.context", 111, 120), ("entropy.likelihood", 121, 125),
        ("chain.call#9", 150, 210)]
    launches = {1: 13, 2: 29, 3: 35, 4: 115, 5: 122, 6: 150, 7: 199}
    return TraceView(device, annotations, launches, requests, {}, {})


def test_device_ms_by_launch_and_by_name():
    v = view()
    assert program.device_ms(v, "entropy.context") == pytest.approx(
        (20 + 5 + 20) / 1e6)
    assert program.device_ms(v, "codec.entropy") == pytest.approx(
        (20 + 5 + 10 + 20 + 10 + 10) / 1e6)
    # a call's index is part of the name of its range, not of the span
    assert program.device_ms(v, "eval.step") == pytest.approx(75 / 1e6)
    assert program.device_ms(v, "absent") is None
    # a range that ends past the window is left out
    assert program.ranges(v, "chain.call") == []


def test_host_ms_is_the_mean_over_the_window():
    v = view()
    assert program.host_ms(v, "eval.step") == pytest.approx(
        (60 + 86) / 2 / 1e6)
    assert program.host_ms(v, "chain.call") is None


def test_eval_readers_on_a_synthetic_trace():
    v = view()
    assert reader("entropy_context_ms.eval").read(v) == pytest.approx(
        45 / 1e6 / 2)
    assert reader("entropy_likelihood_ms.eval").read(v) == pytest.approx(
        20 / 1e6 / 2)
    assert reader("step_host_ms.eval").read(v) == pytest.approx(73 / 1e6)
    empty = TraceView([], [(WINDOW, 0, 10)], {}, 0, {}, {})
    for name in ("entropy_context_ms.eval", "entropy_likelihood_ms.eval",
                 "step_host_ms.eval", "call_host_ms.train"):
        assert reader(name).read(empty) is None, name


def test_call_host_reader():
    annotations = [(WINDOW, 0, 100), ("chain.call#3", 10, 40),
                   ("chain.replay", 20, 30), ("chain.call#4", 50, 70)]
    v = TraceView([], annotations, {}, 2, {}, {})
    assert reader("call_host_ms.train").read(v) == pytest.approx(25 / 1e6)


class Ev:
    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.t - self.t


def one_step(t0):
    ev = [Ev(t0 + t) for t in (0, 3, 3, 9, 9, 10)]
    return [("train.forward", ev[0], ev[1]),
            ("train.backward", ev[2], ev[3]),
            ("train.optimizer", ev[4], ev[5])]


def traced():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def registry(monkeypatch):
    c = pprof.Counters()
    monkeypatch.setattr(pprof, "COUNTERS", c)
    return c


def test_train_readers_read_the_registry(registry):
    v = view()
    for name in ("forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "graph_record_s.train"):
        assert reader(name).read(v) is None, name
    registry.capture(capture_s=15.0, warmup_s=4.0, record_s=11.0,
                     launches={})
    registry.capture(capture_s=9.0, warmup_s=3.0, record_s=6.0, launches={})
    with traced():
        registry.replayed(one_step(0) + one_step(20), 2)
    registry.replayed(one_step(40), 1)
    with traced():
        registry.replayed(one_step(60) + one_step(80), 2)
    # the last replay is settled when the reader reads
    assert reader("forward_ms.train").read(v) == pytest.approx(3.0)
    assert reader("backward_ms.train").read(v) == pytest.approx(6.0)
    assert reader("optimizer_ms.train").read(v) == pytest.approx(1.0)
    assert reader("graph_record_s.train").read(v) == 11.0
    assert registry.read()["steps_timed"] == 4


def test_readers_are_silent_without_the_registry(monkeypatch):
    """A program from before the registry: the readers report nothing."""
    monkeypatch.delattr(pprof, "COUNTERS")
    assert program.counters() is None
    for name in ("forward_ms.train", "graph_record_s.train"):
        assert reader(name).read(view()) is None


def test_every_new_metric_is_declared():
    from bench_port.harness import common
    declared = {m["name"]: m for m in common.manifest()["per_layer"]}
    for name in NEW:
        assert name in declared and declared[name]["workloads"], name
        assert callable(reader(name).read)
        assert not getattr(reader(name), "SPANS", None), name


@pytest.mark.parametrize("cell", ["flagship_fp32.eval", "cdf97_fp32.eval"])
def test_traced_eval_rehearsal_reads_the_program_spans(cell, monkeypatch):
    views = []
    read_profile = trace.read_profile

    def keep(*args, **kwargs):
        views.append(read_profile(*args, **kwargs))
        return views[-1]

    monkeypatch.setattr(trace, "read_profile", keep)
    result, _ = rehearse(cell, trace=True)
    assert result["correct"]
    (v,) = views
    # the host metric reads the program's span; the CPU has no device
    # trace, so the device ms say nothing rather than 0
    assert result["metrics"]["step_host_ms.eval"]["value"] > 0
    assert "entropy_likelihood_ms.eval" not in result["metrics"]
    steps = program.ranges(v, "eval.step")
    assert len(steps) == v.requests
    names = {n.split("#")[0] for n, _, _ in v.annotations}
    assert {"eval.step", "codec.entropy", "entropy.likelihood",
            "entropy.aux_loss", "codec.encode"} <= names
    assert ("entropy.context" in names) == cell.startswith("flagship")
