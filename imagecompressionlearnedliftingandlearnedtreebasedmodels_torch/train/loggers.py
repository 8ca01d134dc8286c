"""Metric meters and console/file logging.

``RDMeter``/``RDLogger`` are running-mean meters with checkpointable state
and a ``display(typ=...)`` report; metrics also stream to a JSONL file for
offline plotting. The port's own copy of the JAX package's
``train/loggers.py``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np


def setup_logging(log_dir: str, name: str = "lwc_torch") -> logging.Logger:
    """Console + rotating-file logging."""
    from logging.handlers import RotatingFileHandler

    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s")
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        debug_h = RotatingFileHandler(
            os.path.join(log_dir, "exp_debug.log"),
            maxBytes=10 ** 7, backupCount=5)
        debug_h.setLevel(logging.DEBUG)
        debug_h.setFormatter(fmt)
        logger.addHandler(debug_h)
        err_h = RotatingFileHandler(
            os.path.join(log_dir, "exp_error.log"),
            maxBytes=10 ** 6, backupCount=5)
        err_h.setLevel(logging.WARNING)
        err_h.setFormatter(fmt)
        logger.addHandler(err_h)
    return logger


class RDMeter:
    """Running rate-distortion meter with checkpointable state."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.rd: List[float] = []
        self.mse: List[float] = []
        self.rate1: List[float] = []
        self.rate2: List[float] = []
        self._t0 = time.time()

    def __call__(self, rd, mse, rate1, rate2):
        self.rd.append(float(rd))
        self.mse.append(float(mse))
        self.rate1.append(float(rate1))
        self.rate2.append(float(rate2))

    def means(self) -> Dict[str, float]:
        def m(v):
            return float(np.mean(v)) if v else float("nan")
        return {"rd": m(self.rd), "mse": m(self.mse),
                "rate1": m(self.rate1), "rate2": m(self.rate2)}

    def psnr(self) -> float:
        mse = self.means()["mse"]
        return float(-10.0 * np.log10(mse)) if mse > 0 else float("inf")

    def state_dict(self):
        return {"rd": self.rd, "mse": self.mse,
                "rate1": self.rate1, "rate2": self.rate2}

    def load_state_dict(self, d):
        self.rd = list(d["rd"])
        self.mse = list(d["mse"])
        self.rate1 = list(d["rate1"])
        self.rate2 = list(d["rate2"])


class RDLogger:
    """Meter + formatted display."""

    def __init__(self, logger: Optional[logging.Logger] = None,
                 jsonl_path: Optional[str] = None):
        self.meter = RDMeter()
        self.logger = logger or logging.getLogger("lwc_torch")
        self.jsonl_path = jsonl_path

    def __call__(self, rd, mse, rate1, rate2):
        self.meter(rd, mse, rate1, rate2)

    def display(self, lr: float, typ: str = "tr", step: int = 0):
        m = self.meter.means()
        elapsed = time.time() - self.meter._t0
        msg = (f"[{typ}] RDLoss {m['rd']:.5f} MSE {m['mse']:.6f} "
               f"PSNR {self.meter.psnr():.2f} Rate1 {m['rate1']:.4f} "
               f"Rate2 {m['rate2']:.4f} lr {lr:.2e} time {elapsed:.1f}s")
        self.logger.info(msg)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as fh:
                fh.write(json.dumps({"typ": typ, "step": step, "lr": lr,
                                     "psnr": self.meter.psnr(),
                                     "elapsed": elapsed, **m}) + "\n")
        out = (m["rd"], m["mse"], m["rate1"], m["rate2"])
        self.meter.reset()
        return out

    def state_dict(self):
        return self.meter.state_dict()

    def load_state_dict(self, d):
        self.meter.load_state_dict(d)
