"""Per-phase wall-clock timers, a device trace window on
``torch.profiler`` and named regions in its traces."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class PhaseTimers:
    """Accumulating wall-clock timers for train-loop phases."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            t = self.totals[name]
            lines.append(f"{name}: {t:.3f}s total, {t / max(n, 1) * 1e3:.2f}"
                         f"ms/call x{n}")
        return "\n".join(lines)


class DeviceTrace:
    """A ``torch.profiler`` window opened and closed by hand: ``start()``,
    some steps, ``stop()`` writes ``<trace_dir>/trace.json`` (Chrome trace
    format). It records the host and, for a CUDA ``device``, the GPU."""

    def __init__(self, trace_dir: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.path = os.path.join(trace_dir, "trace.json")
        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)

    def start(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda") -> Iterator[str]:
    """A :class:`DeviceTrace` around the block; yields the path of the
    ``trace.json`` it writes when the block ends."""
    trace = DeviceTrace(log_dir, device)
    trace.start()
    try:
        yield trace.path
    finally:
        trace.stop()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield
