"""The port's liveness supervisor (``train/supervisor.py``) and heartbeat
(``utils/heartbeat.py``), on the JAX package's cases: stall detection,
crash restart, clean completion, the restart budget, the module's CLI,
SIGTERM reaching the child's group, the agent's beat, the no-op beacon; and
the lease. The supervised child is a tiny standalone script driven
through real subprocesses, as a run uses it.
"""

import os
import subprocess
import sys

import time

import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    supervisor)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.utils import (
    heartbeat as hb)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

CHILD = r"""
import os, sys, time
# beats the heartbeat, then follows the behavior listed in the marker dir:
# each run consumes one token from argv-specified plan file.
plan_path, marker_dir = sys.argv[1], sys.argv[2]
os.makedirs(marker_dir, exist_ok=True)
n_prev = len(os.listdir(marker_dir))
open(os.path.join(marker_dir, f"run{n_prev}"), "w").close()
plan = open(plan_path).read().split()
action = plan[min(n_prev, len(plan) - 1)]
hb_path = os.environ["LIFTING_HEARTBEAT"]
def beat():
    with open(hb_path + ".tmp", "w") as f:
        f.write("x")
    os.replace(hb_path + ".tmp", hb_path)
if action == "stall":
    beat()
    time.sleep(3600)       # wedged: beats once then never again
elif action == "silent":
    time.sleep(3600)       # wedged before ever beating
elif action == "crash":
    beat()
    sys.exit(3)
elif action == "ok":
    for _ in range(3):
        beat(); time.sleep(0.05)
    sys.exit(0)
"""


def _run_plan(tmp_path, plan, timeout=1.0, grace=20.0, max_restarts=3):
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    plan_file = tmp_path / "plan.txt"
    plan_file.write_text(" ".join(plan))
    marker = tmp_path / "markers"
    # pre-create: on a heavily loaded host a child can be killed at the
    # grace limit before it even reaches its os.makedirs
    marker.mkdir(exist_ok=True)
    logs = []
    rc = supervisor.supervise(
        [sys.executable, str(child), str(plan_file), str(marker)],
        timeout=timeout, grace=grace, max_restarts=max_restarts,
        poll=0.2, hb_path=str(tmp_path / "hb"), log=logs.append)
    runs = len(os.listdir(marker))
    return rc, runs, logs


def test_stalled_child_is_killed_and_restarted(tmp_path):
    rc, runs, logs = _run_plan(tmp_path, ["stall", "ok"])
    assert rc == 0
    assert runs == 2
    assert any("stale" in l for l in logs)


def test_crashing_child_is_restarted(tmp_path):
    rc, runs, _ = _run_plan(tmp_path, ["crash", "crash", "ok"])
    assert rc == 0
    assert runs == 3


def test_clean_exit_no_restart(tmp_path):
    rc, runs, _ = _run_plan(tmp_path, ["ok"])
    assert rc == 0
    assert runs == 1


def test_restart_budget_exhausts(tmp_path):
    # a child that never beats is non-productive: each attempt burns one
    # restart (grace is the applicable stall limit before the first beat)
    rc, runs, logs = _run_plan(tmp_path, ["silent", "silent", "silent"],
                               max_restarts=2, grace=6.0)
    assert rc != 0
    # count attempts from the supervisor's own log, not the child's
    # markers: under load an attempt can be killed before the child
    # starts, which must still burn budget
    attempts = sum(1 for l in logs if "attempt" in l)
    assert attempts == 2 and runs <= 2
    assert any("exhausted" in l for l in logs)


def test_cli_roundtrip(tmp_path):
    """python -m ...train.supervisor -- <cmd> works end to end."""
    child = tmp_path / "ok.py"
    child.write_text("import os\n"
                     "p = os.environ['LIFTING_HEARTBEAT']\n"
                     "open(p, 'w').write('x')\n")
    env = dict(os.environ)
    env.pop(hb.ENV_VAR, None)
    out = subprocess.run(
        [sys.executable, "-m",
         "imagecompressionlearnedliftingandlearnedtreebasedmodels_torch"
         ".train.supervisor",
         "--timeout", "5", "--", sys.executable, str(child)],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr


def test_sigterm_kills_child_group(tmp_path):
    """Terminating the supervisor must not orphan the training child."""
    import signal
    import time

    pid_file = tmp_path / "child_pid"
    sup = subprocess.Popen(
        [sys.executable, "-m",
         "imagecompressionlearnedliftingandlearnedtreebasedmodels_torch"
         ".train.supervisor",
         "--timeout", "60", "--", sys.executable, "-c",
         "import os,time\n"
         "open(os.environ['LIFTING_HEARTBEAT'],'w').write('x')\n"
         f"open({str(pid_file)!r},'w').write(str(os.getpid()))\n"
         "time.sleep(600)"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        for _ in range(100):
            if pid_file.exists() and pid_file.read_text():
                break
            time.sleep(0.2)
        child = int(pid_file.read_text())
        sup.send_signal(signal.SIGTERM)
        sup.wait(timeout=30)
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                os.kill(child, 0)
            except ProcessLookupError:
                break
            time.sleep(0.2)
        else:
            os.kill(child, signal.SIGKILL)
            raise AssertionError("child survived supervisor SIGTERM")
    finally:
        if sup.poll() is None:
            sup.kill()


def test_agent_heartbeat_hook(tmp_path, monkeypatch):
    """Heartbeat.beat writes the liveness file when the env var is set —
    but construction alone must NOT (the supervisor's grace window for
    init + first compile only applies until the first beat)."""
    path = tmp_path / "hb"
    monkeypatch.setenv(hb.ENV_VAR, str(path))
    beacon = hb.Heartbeat(min_interval=0.0)
    assert not path.exists()
    beacon.beat()
    assert hb.age_seconds(str(path)) is not None


def test_heartbeat_noop_without_env(monkeypatch):
    monkeypatch.delenv(hb.ENV_VAR, raising=False)
    beacon = hb.Heartbeat()
    beacon.beat()  # must not raise or create anything
    assert beacon.path is None


def test_lease_beats_until_it_ends(tmp_path, monkeypatch):
    """HeartbeatLease beats from its thread while the phase runs and
    stops when it ends."""
    path = tmp_path / "hb"
    monkeypatch.setenv(hb.ENV_VAR, str(path))
    beacon = hb.Heartbeat(min_interval=0.0)
    with hb.HeartbeatLease(beacon, interval=0.05, max_s=30.0):
        deadline = time.time() + 10
        while hb.age_seconds(str(path)) is None and time.time() < deadline:
            time.sleep(0.02)
        assert hb.age_seconds(str(path)) is not None
    time.sleep(0.2)
    age = hb.age_seconds(str(path))
    time.sleep(0.3)
    assert hb.age_seconds(str(path)) >= age + 0.2   # no beat after the end
