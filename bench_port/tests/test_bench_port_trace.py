"""The trace's reduction on synthetic events: busy time is the union of
the device's intervals (overlaps count once), idle gaps are named by the
host range open at their middle, and kernels are attributed to the spans
that were open when they were launched."""

import pytest

from bench_port.harness.trace import WINDOW, TraceView, gaps_ns, union_ns


def test_union_counts_overlap_once_and_clips():
    iv = [(0, 10), (5, 15), (20, 30), (25, 27), (40, 60)]
    assert union_ns(iv, 0, 100) == 15 + 10 + 20
    assert union_ns(iv, 8, 50) == 7 + 10 + 10
    assert union_ns([], 0, 10) == 0


def test_gaps():
    assert gaps_ns([(2, 4), (3, 6), (8, 9)], 0, 10) == [
        (0, 2), (6, 8), (9, 10)]


def view():
    # window 0..100; two batches; kernels: (name, start, end, correlation)
    device = [("convA", 10, 30, 1), ("convB", 30, 40, 2),
              ("ewise", 35, 45, 3), ("convA", 60, 80, 4),
              ("late", 120, 130, 5)]
    annotations = [(WINDOW, 0, 100), ("span.outer", 5, 50),
                   ("span.inner", 8, 21), ("span.outer", 55, 90),
                   ("bench.prepare", 45, 58), ("bench.readback", 80, 100)]
    launches = {1: 9, 2: 20, 3: 25, 4: 56, 5: 95}
    return TraceView(device, annotations, launches, 2, {}, {})


def test_busy_and_window():
    v = view()
    assert v.window_s == pytest.approx(100e-9)
    assert v.busy_s == pytest.approx((35 + 20) * 1e-9)


def test_spans_attribute_by_launch():
    v = view()
    assert v.span_ms("outer") == pytest.approx((20 + 10 + 10 + 20) / 1e6)
    assert v.span_ms("inner") == pytest.approx((20 + 10) / 1e6)
    assert v.span_ms("absent") is None


def test_breakdown_names_gaps_by_the_open_range():
    b = view().breakdown()
    assert b["device_ops"][0] == ["convA", pytest.approx(40e-9)]
    gaps = dict((round(s * 1e9), n) for n, s in b["idle_gaps"])
    assert gaps == {15: "bench.prepare", 20: "bench.readback",
                    10: "span.outer"}
