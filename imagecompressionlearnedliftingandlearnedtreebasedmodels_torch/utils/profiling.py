"""The port's tracing: spans at its layer boundaries, timed phases inside a
captured CUDA graph, the counters that readers outside the program read,
per-phase wall-clock timers and a device trace window on
``torch.profiler``.

- :func:`span` names a region of the host's work. While a
  ``torch.profiler`` records, it is a ``record_function`` range: a kineto
  user annotation, on the same clock as the device's activities in the
  trace, and every kernel launched inside it can be matched to it by the
  launch's correlation id. Otherwise it is one shared ``nullcontext``.
- :func:`device_phase` is a span that, while :func:`record_phases` is
  open (``train/state.py::GraphChain`` recording its graph), also records
  a pair of timing events around the phase: event-record nodes of the
  graph, so every replay times the phase on the device.
- :data:`COUNTERS` keeps what outlives the objects that measured it: each
  graph capture's seconds, and the device ms of the timed phases over the
  replays launched while a profiler recorded.

Spans do not reach into a graph's replay (no Python runs there); the timed
phases are what times it. Nothing here synchronises the device or reads a
tensor back.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str, req: Optional[int] = None):
    """A named region of the host's work: a ``record_function`` range
    while a profiler records, else one shared null context (a fraction of
    a microsecond). ``req`` numbers the calls of an entry point; it rides
    in the range's name, ``<name>#<req>`` (``record_function`` drops its
    ``args`` string from the trace), so the spans nested in one call share
    it."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _profiler.record_function(name if req is None
                                     else f"{name}#{req}")


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# the timed phases of the graph being recorded: set by record_phases
_recording: Optional[list] = None


@contextlib.contextmanager
def record_phases() -> Iterator[list]:
    """While open (around a CUDA graph's recording), every
    :func:`device_phase` also records a pair of timing events on the
    current stream; yields the list of ``(name, start, end)`` they fill,
    in order."""
    global _recording
    _recording = []
    try:
        yield _recording
    finally:
        _recording = None


@contextlib.contextmanager
def device_phase(name: str) -> Iterator[None]:
    """``span(name)``; inside :func:`record_phases` also a pair of timing
    events (``external``, so a captured graph holds them as event-record
    nodes) before and after the phase."""
    events = _recording
    if events is None:
        with span(name):
            yield
        return
    start = torch.cuda.Event(enable_timing=True, external=True)
    end = torch.cuda.Event(enable_timing=True, external=True)
    start.record()
    with span(name):
        yield
    end.record()
    events.append((name, start, end))


class Counters:
    """The program's counters, kept where a reader finds them after the
    step objects are gone:

    - ``captures``: per graph capture, its seconds (``warmup_s``, the eager
      warm-up; ``record_s``, the recording and instantiation;
      ``capture_s``, both) and the graph's kernel launches a replay;
    - ``phase_ms``: per timed phase, the device ms summed over every step
      of the replays kept; ``replays_timed`` and ``steps_timed`` count
      them, ``replays_dropped`` the traced replays whose events had not
      completed when they were settled.

    Only a replay launched while a profiler records is timed. Its events
    are read when it is settled: at the start of the next replay's call
    (the same events record again then) or when the counters are read.
    Events not yet complete then drop the replay; nothing waits."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.captures: List[dict] = []
        self.phase_ms: Dict[str, float] = defaultdict(float)
        self.replays_timed = self.steps_timed = self.replays_dropped = 0
        self._pending = None

    def capture(self, **numbers) -> dict:
        """Keep one capture's numbers; returns the record."""
        self.captures.append(dict(numbers))
        return self.captures[-1]

    def replayed(self, phases, steps: int) -> None:
        """A replay of a graph holding ``phases`` (``(name, start, end)``
        events, ``steps`` steps) was just launched: timed if a profiler
        records."""
        self.settle()
        if phases and _profiler._is_profiler_enabled:
            self._pending = (phases, steps)

    def settle(self) -> None:
        """Read the pending replay's events if they have all completed,
        else drop it."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        phases, steps = pending
        if not all(s.query() and e.query() for _, s, e in phases):
            self.replays_dropped += 1
            return
        for name, s, e in phases:
            self.phase_ms[name] += s.elapsed_time(e)
        self.replays_timed += 1
        self.steps_timed += steps

    def read(self) -> dict:
        """Everything counted so far, the pending replay settled first."""
        self.settle()
        return {"captures": [dict(c) for c in self.captures],
                "phase_ms": dict(self.phase_ms),
                "replays_timed": self.replays_timed,
                "steps_timed": self.steps_timed,
                "replays_dropped": self.replays_dropped}


COUNTERS = Counters()


class PhaseTimers:
    """Accumulating wall-clock timers for train-loop phases; each phase is
    also a :func:`span` of its name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
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
    format). It records the host and, for a CUDA ``device``, the GPU; the
    program's spans are ranges in it."""

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
