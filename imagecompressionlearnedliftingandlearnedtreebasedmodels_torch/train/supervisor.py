"""Liveness supervisor for long training runs.

A crash raises and the agent saves a checkpoint first; a process that
hangs (a wedged collective, a dead card) saves nothing and never exits.
The supervisor covers both::

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train.supervisor \
        --timeout 600 -- python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.cli --resume-training config.json

It runs the command as a child process group with ``LIFTING_HEARTBEAT``
pointing at a liveness file (``utils/heartbeat.py``), and

- restarts the child when the heartbeat goes stale for ``--timeout``
  seconds (the whole group is killed with SIGKILL: a wedged process may
  never act on SIGTERM, and a mesh run's ranks are in the group too);
- restarts the child when it exits nonzero (the agent saved first);
- stops on exit code 0, or after ``--max-restarts`` consecutive attempts
  that never beat (an attempt that beat resets the count, so a long run
  with occasional faults never exhausts it).

Restarted commands must resume, e.g. the CLI's ``--resume-training``
(the CLI's ``--supervise`` adds it).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from ..utils import heartbeat as hb


def _kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL the child's process group (started in its own session, so
    this never reaches the supervisor or unrelated processes)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass


def supervise(cmd: List[str], timeout: float = 600.0,
              grace: Optional[float] = None, max_restarts: int = 10,
              poll: float = 5.0, hb_path: Optional[str] = None,
              log=print) -> int:
    """Run ``cmd`` until it exits 0; kill and restart it on a stall or a
    crash. ``timeout``: seconds without a beat before the child counts as
    wedged; ``grace``: the limit while no beat has been seen in this
    attempt (imports, kernel builds), ``max(timeout, 1800)`` by default.
    Returns the final exit code (0 on success, nonzero when the restarts
    are exhausted)."""
    if grace is None:
        grace = max(timeout, 1800.0)
    if hb_path is None:
        fd, hb_path = tempfile.mkstemp(prefix="train_hb_")
        os.close(fd)
        os.unlink(hb_path)  # the child (re)creates it at its first beat

    env = dict(os.environ)
    env[hb.ENV_VAR] = hb_path

    restarts_left = max_restarts
    attempt = 0
    # forward termination to the child's group, so that killing the
    # supervisor does not orphan a run that keeps holding the card
    current: dict = {"proc": None}

    def _terminate(signum, frame):
        proc = current["proc"]
        if proc is not None:
            _kill_group(proc)
        raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _terminate)
        signal.signal(signal.SIGINT, _terminate)
    except ValueError:
        pass  # not the main thread (tests call supervise() directly)
    while True:
        attempt += 1
        try:
            os.unlink(hb_path)
        except OSError:
            pass
        start = time.time()
        beat_seen = False
        log(f"[supervisor] attempt {attempt}: {' '.join(cmd)}")
        proc = subprocess.Popen(cmd, env=env, start_new_session=True)
        current["proc"] = proc
        stalled = False
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            age = hb.age_seconds(hb_path)
            if age is not None:
                beat_seen = True
            limit = timeout if beat_seen else grace
            waited = age if age is not None else time.time() - start
            if waited > limit:
                log(f"[supervisor] heartbeat stale ({waited:.0f}s > "
                    f"{limit:.0f}s): killing the wedged child {proc.pid}")
                _kill_group(proc)
                stalled = True
                rc = None
                break
            time.sleep(poll)
        if not stalled and rc == 0:
            log(f"[supervisor] child finished cleanly (attempt {attempt})")
            return 0
        if beat_seen:
            restarts_left = max_restarts  # a productive attempt
        else:
            restarts_left -= 1
        why = "stalled" if stalled else f"exited rc={rc}"
        if restarts_left <= 0:
            log(f"[supervisor] child {why} and restart budget exhausted")
            return rc if (rc is not None and rc != 0) else 1
        log(f"[supervisor] child {why}: restarting "
            f"({restarts_left} non-productive restarts left)")
        time.sleep(min(poll, 5.0))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Restart-on-stall supervisor for training commands. "
                    "Usage: supervisor [opts] -- cmd arg...")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds without a heartbeat => the child is wedged")
    ap.add_argument("--grace", type=float, default=None,
                    help="stall timeout before the first beat "
                         "(default max(timeout, 1800))")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--poll", type=float, default=5.0)
    ap.add_argument("--pidfile", type=str, default=None,
                    help="write the supervisor's pid here")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to supervise")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (use: supervisor [opts] -- cmd ...)")
    if args.pidfile:
        with open(args.pidfile, "w") as fh:
            fh.write(str(os.getpid()))
    try:
        return supervise(cmd, timeout=args.timeout, grace=args.grace,
                         max_restarts=args.max_restarts, poll=args.poll)
    finally:
        if args.pidfile:
            try:
                os.remove(args.pidfile)
            except OSError:
                pass


if __name__ == "__main__":
    sys.exit(main())
