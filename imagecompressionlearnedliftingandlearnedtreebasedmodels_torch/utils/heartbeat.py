"""Training-liveness heartbeat.

Crash-save on an exception (``train/loop.py::run``) does not cover a
process that hangs. The liveness protocol: the agent touches a heartbeat
file after every train and eval step and at every checkpoint save
(:meth:`Heartbeat.beat`, throttled to one ``os.replace`` every
``min_interval`` seconds at most), and a supervisor watches the file's age.

The file's path comes from the ``LIFTING_HEARTBEAT`` environment variable;
without it every call is a no-op.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

ENV_VAR = "LIFTING_HEARTBEAT"


def heartbeat_path() -> Optional[str]:
    return os.environ.get(ENV_VAR) or None


class Heartbeat:
    """Throttled liveness file writer; no-op when no path is configured."""

    def __init__(self, path: Optional[str] = None,
                 min_interval: float = 2.0):
        self.path = path if path is not None else heartbeat_path()
        self.min_interval = float(min_interval)
        self._last = 0.0
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
        # No beat here: the first beat marks the first completed step, so a
        # watcher keeps its start-up grace through model set-up.

    def beat(self, force: bool = False) -> None:
        if not self.path:
            return
        now = time.time()
        if not force and (now - self._last) < self.min_interval:
            return
        self._last = now
        # the temporary name is keyed by thread as well as by process: two
        # threads beating at once never write (or replace away) one file
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(f"{now:.3f}\n")
        os.replace(tmp, self.path)  # atomic: a watcher never sees a torn file



class HeartbeatLease:
    """Bounded background beater for long phases that save nothing between
    beats (the real-bitstream ``test`` mode: one image's round trip can
    outlast a supervisor's timeout). Beats every ``interval`` seconds from
    a daemon thread while the phase runs, and stops by itself after
    ``max_s``, so a phase that truly hangs still goes stale and is
    restarted, on a coarser clock."""

    def __init__(self, hb: Heartbeat, interval: float = 60.0,
                 max_s: float = 2400.0):
        self._hb = hb
        self._interval = interval
        self._max_s = max_s
        self._stop = None

    def __enter__(self):
        self._stop = threading.Event()
        stop = self._stop

        def run():
            t0 = time.time()
            while not stop.is_set() and (time.time() - t0) < self._max_s:
                self._hb.beat(force=True)
                stop.wait(self._interval)

        if self._hb.path:
            threading.Thread(target=run, daemon=True).start()
        return self

    def __exit__(self, *exc):
        if self._stop is not None:
            self._stop.set()
        return False


def age_seconds(path: str) -> Optional[float]:
    """Seconds since the last beat, or None if the file does not exist."""
    try:
        return max(0.0, time.time() - os.stat(path).st_mtime)
    except OSError:
        return None
