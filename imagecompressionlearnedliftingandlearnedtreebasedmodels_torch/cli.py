"""Experiment CLI.

Usage::

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.cli [--resume-training] [--device cpu] [--supervise [--stall-timeout S]] config.json

Runs the agent named by ``config.agent`` and expands
``multi_agent``/``multi_param`` sweeps into one full run per value, writing
``experiments/<multi_exp_name>/results.json``. Experiment directories are
created under ``./experiments``.

The run is on the GPU (it fails when there is none) unless ``--device cpu``
asks for the plain PyTorch versions on the CPU, for a rehearsal; fp32 runs
at full fp32 precision (TF32 off, ``config.full_fp32``).
``--resume-training`` continues from the run's rolling checkpoint.
A config whose ``mesh_shape`` spans n > 1 devices runs data-parallel: the
CLI starts n ranks itself (``parallel/mesh.py::spawn``), one per GPU with
NCCL, or n gloo ranks sharing the card where there are fewer GPUs than
ranks; with ``--device cpu``, n gloo ranks on the CPU.
``--supervise`` re-runs this command (with ``--resume-training``) under the
liveness supervisor (``train/supervisor.py``), which restarts it after a
crash or when its heartbeat is older than ``--stall-timeout`` seconds
(900 by default).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from .config import expand_sweep, full_fp32, process_config, resolve_device
from .registry import get_agent


def run_agent(cfg, device=None):
    agent = get_agent(cfg.agent)(cfg, device=device)
    try:
        agent.run()
    finally:
        agent.finalize()
    return agent


def _aggregate_results(cfg, agents, experiments_root="experiments"):
    """One entry per sweep value, written to
    ``<experiments_root>/<multi_exp_name>/results.json``."""
    results = {}
    for sub_cfg, agent in agents:
        entry = {"exp_name": sub_cfg.exp_name,
                 str(sub_cfg.multi_param): getattr(sub_cfg,
                                                   sub_cfg.multi_param)}
        entry["best_valid_loss"] = getattr(agent, "best_valid_loss", None)
        results[sub_cfg.exp_name] = entry
    out_dir = os.path.join(experiments_root,
                           cfg.multi_exp_name or cfg.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump(results, fh, indent=2, default=str)


def run_all(cfg, subs, device=None):
    agents = [(sub, run_agent(sub, device)) for sub in subs]
    if cfg.multi_agent:
        _aggregate_results(cfg, agents)


def _mesh_rank(mesh, cfg, subs, device):
    agents = [(sub, run_agent(sub, device)) for sub in subs]
    if cfg.multi_agent and mesh.rank == 0:
        _aggregate_results(cfg, agents)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    full_fp32()
    if "--supervise" in argv:
        # re-run this CLI (without the flag) under the liveness supervisor;
        # --resume-training makes every restart continue from the run's
        # checkpoints
        argv.remove("--supervise")
        stall = 900.0
        if "--stall-timeout" in argv:
            i = argv.index("--stall-timeout")
            stall = float(argv[i + 1])
            del argv[i:i + 2]
        from .train.supervisor import supervise
        return supervise(
            [sys.executable, "-m", __spec__.name if __spec__ else __name__,
             "--resume-training"] + argv, timeout=stall)
    resume_override = "--resume-training" in argv
    if resume_override:
        argv.remove("--resume-training")
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) != 1:
        print(__doc__)
        return 2
    cfg = process_config(argv[0])
    if resume_override:
        cfg.resume_training = True
    subs = expand_sweep(cfg)
    n = int(np.prod(cfg.mesh_shape))
    if n > 1:
        from .parallel import mesh as mesh_lib
        mesh_lib.spawn(_mesh_rank, n, resolve_device(device).type,
                       (cfg, subs, device))
    else:
        run_all(cfg, subs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
