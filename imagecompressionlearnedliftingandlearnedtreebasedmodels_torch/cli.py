"""Experiment CLI.

Usage::

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.cli [--resume-training] [--device cpu] config.json

Runs the agent named by ``config.agent`` and expands
``multi_agent``/``multi_param`` sweeps into one full run per value, writing
``experiments/<multi_exp_name>/results.json``. Experiment directories are
created under ``./experiments``.

The run is on the GPU (it fails when there is none) unless ``--device cpu``
asks for the plain PyTorch versions on the CPU, for a rehearsal; fp32 runs
at full fp32 precision (TF32 off, ``config.full_fp32``).
``--resume-training`` continues from the run's rolling checkpoint.
``--supervise`` (restart on a crash or a hang) is not ported yet: it waits
for the supervisor, ROADMAP Queue A item 13.
"""

from __future__ import annotations

import json
import os
import sys

from .config import expand_sweep, full_fp32, process_config
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


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    full_fp32()
    if "--supervise" in argv:
        raise NotImplementedError(
            "--supervise needs the liveness supervisor, which is not ported "
            "yet (ROADMAP Queue A item 13); run without it and restart with "
            "--resume-training")
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
    agents = [(sub, run_agent(sub, device)) for sub in subs]
    if cfg.multi_agent:
        _aggregate_results(cfg, agents)
    return 0


if __name__ == "__main__":
    sys.exit(main())
