"""The traced run: a profiler over the measured window, and the reduction of
its raw events to what the per-layer readers read.

Only a ``--trace 1`` run profiles. The window is one ``bench.window``
range; the harness's own phases (``bench.prepare``, ``bench.step``,
``bench.readback``) and the spans of :mod:`.spans` (``span.<name>``) are
ranges on the host. A device activity is attributed to every range that
was open on the host when its launch was issued (matched by the CUDA
runtime call's correlation id), so a kernel launched inside a conv inside
an autoencoder counts for both. Busy time is the union of the device's
activity intervals inside the window, so overlapping streams count once.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch

WINDOW = "bench.window"


class Tracer:
    """Phases as host ranges, and with ``enabled`` a profiler over them
    (the device's activity too where ``device`` is a card)."""

    def __init__(self, enabled: bool, device="cuda"):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None

    def phase(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        try:
            with torch.profiler.record_function(WINDOW):
                yield
        finally:
            self.prof.stop()


def _merged(intervals, lo=None, hi=None):
    """The union of (start, end) intervals, clipped to [lo, hi] where
    given, as sorted disjoint [start, end] pairs."""
    out = []
    for s, e in sorted(intervals):
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_ns(intervals, lo, hi) -> int:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    return sum(e - s for s, e in _merged(intervals, lo, hi))


def gaps_ns(intervals, lo, hi):
    """(start, end) of each stretch of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in _merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out


class TraceView:
    """What a per-layer reader sees of a traced run."""

    def __init__(self, device, annotations, launches, requests, work, host):
        self.requests = requests      # requests completed in the window
        self._work = work             # () -> the step's counted work
        self.host = host              # host-clock readings of the run
        wins = [(s, e) for n, s, e in annotations if n == WINDOW]
        if not wins:
            raise RuntimeError("the trace holds no window range")
        self.lo, self.hi = wins[0]
        self.device = [d for d in device if d[2] > self.lo and d[1] < self.hi]
        self.annotations = [a for a in annotations if a[0] != WINDOW]
        self.launches = launches
        self.window_s = (self.hi - self.lo) / 1e9
        self.busy_s = union_ns([(s, e) for _, s, e, _ in self.device],
                               self.lo, self.hi) / 1e9
        self._spans = None

    @property
    def work(self):
        """The step's work counted from the configuration (``work``), or
        None where no counter covers it; counted on the first reading."""
        if callable(self._work):
            try:
                self._work = self._work()
            except LookupError:
                self._work = None
        return self._work

    def _span_table(self):
        """Per span name: the device ns of the activity launched inside
        it."""
        if self._spans is None:
            ranges = defaultdict(list)
            for name, s, e in self.annotations:
                if name.startswith("span."):
                    ranges[name[5:]].append((s, e))
            launch = np.array([self.launches.get(c, -1)
                               for _, _, _, c in self.device], np.int64)
            dur = np.array([e - s for _, s, e, _ in self.device], np.int64)
            table = {}
            for name, iv in ranges.items():
                iv = np.array(_merged(iv), np.int64)
                idx = np.searchsorted(iv[:, 0], launch, side="right") - 1
                inside = (idx >= 0) & (launch >= 0)
                inside &= launch <= iv[np.maximum(idx, 0), 1]
                table[name] = int(dur[inside].sum())
            self._spans = table
        return self._spans

    def span_ms(self, name: str):
        """Device ms launched inside ``span.<name>`` over the window, or
        None where the span never ran."""
        ns = self._span_table().get(name)
        return None if not ns else ns / 1e6

    def breakdown(self, top: int = 10):
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host range open at their middle."""
        by_name = defaultdict(int)
        for name, s, e, _ in self.device:
            by_name[name] += min(e, self.hi) - max(s, self.lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = gaps_ns([(s, e) for _, s, e, _ in self.device], self.lo,
                       self.hi)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            open_ = [(ae - as_, n) for n, as_, ae in self.annotations
                     if as_ <= mid <= ae]
            name = min(open_)[1] if open_ else "python"
            named.append([name, (e - s) / 1e9])
        return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
                "idle_gaps": named}


def read_profile(prof, requests, work, host) -> TraceView:
    """Reduce a stopped profiler's raw events. ``work`` is a callable that
    counts the step's work (only a reader that needs it calls it)."""
    from torch.autograd import DeviceType
    device, annotations, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                s = e.start_ns()
                device.append((e.name(), s, s + e.duration_ns(),
                               e.correlation_id()))
        elif e.is_user_annotation():
            s = e.start_ns()
            annotations.append((e.name(), s, s + e.duration_ns()))
        elif e.name().startswith(("cuda", "cuLaunch", "cuGraph")):
            launches[e.correlation_id()] = e.start_ns()
    return TraceView(device, annotations, launches, requests, work, host)
