"""The program's own spans and counters, as the per-layer readers read them.

The program names its layer boundaries itself (``utils/profiling.py``:
``span``, ``device_phase``, ``COUNTERS``); a traced run's profiler holds
its spans as host ranges among the view's annotations, a call's index
after ``#`` in the name of its outermost one (``eval.step#12``). A device
activity counts for a span when its launch was issued while a range of
that name was open (matched by correlation id, as
``TraceView._span_table`` matches the harness's ``span.*`` ranges).
Every function returns None where the program has no such span or
counter (a program from before they existed included), so a reader
reports nothing there rather than zero.
"""

from __future__ import annotations

import importlib

import numpy as np

from . import port
from .trace import _merged


def ranges(view, name: str):
    """(start, end) ns of every range of span ``name`` inside the window."""
    return [(s, e) for n, s, e in view.annotations
            if n.split("#", 1)[0] == name and s >= view.lo and e <= view.hi]


def device_ms(view, name: str):
    """Device ms of the activity launched inside span ``name`` over the
    window, or None where the span never ran or launched nothing."""
    iv = ranges(view, name)
    if not iv or not view.device:
        return None
    iv = np.array(_merged(iv), np.int64)
    launch = np.array([view.launches.get(c, -1)
                       for _, _, _, c in view.device], np.int64)
    dur = np.array([e - s for _, s, e, _ in view.device], np.int64)
    idx = np.searchsorted(iv[:, 0], launch, side="right") - 1
    hit = (idx >= 0) & (launch >= 0)
    hit &= launch <= iv[np.maximum(idx, 0), 1]
    ns = int(dur[hit].sum())
    return ns / 1e6 if ns else None


def host_ms(view, name: str):
    """Mean host ms of span ``name``'s ranges inside the window, or None
    where it never ran."""
    iv = ranges(view, name)
    return sum(e - s for s, e in iv) / len(iv) / 1e6 if iv else None


def counters():
    """The program's counter registry as it reads now (pending replays
    settled), or None where the program keeps none."""
    try:
        mod = importlib.import_module(f"{port.PORT}.utils.profiling")
    except ImportError:
        return None
    registry = getattr(mod, "COUNTERS", None)
    return None if registry is None else registry.read()


def phase_ms(name: str):
    """Device ms a step of the captured graph's timed phase ``name``, over
    the replays launched while the profiler recorded, or None."""
    c = counters()
    if not c or not c["steps_timed"] or name not in c["phase_ms"]:
        return None
    return c["phase_ms"][name] / c["steps_timed"]
