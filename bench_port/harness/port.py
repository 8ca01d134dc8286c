"""The system under test: the PyTorch and CUDA port. This is the one module
of the benchmark that imports it; it takes from it only the model, its
entry points and what they return."""

from __future__ import annotations

import importlib

import torch

PORT = "imagecompressionlearnedliftingandlearnedtreebasedmodels_torch"
META_KEYS = ("source", "reduced", "assumed")


def _mod(name: str):
    return importlib.import_module(f"{PORT}.{name}")


def config(model_cfg: dict, overrides: dict):
    """The program's Config from a configuration file and a cell's
    execution settings (lambda, batch, patch, steps a call)."""
    raw = {k: v for k, v in model_cfg.items() if k not in META_KEYS}
    raw.update(overrides)
    raw["multi_agent"] = False
    return _mod("config").config_from_dict(raw)


def model(cfg, state_dict, device):
    """The program's codec on ``device``, holding ``state_dict``."""
    with torch.device(device):
        m = _mod("models.codec").CodecWrapper(cfg)
    m.load_state_dict(state_dict)
    return m


def eval_step(cfg, m, device):
    return _mod("train.state").make_eval_step(cfg, m, device)


def train_step(cfg, m, device):
    """(chained step, optimizer), as the program's agent builds them for
    ``cfg.steps_per_call``: ``step(chunk, generator, lr, rate_weight,
    lam) -> (k, 4)`` rows on the device, for a uint8 chunk ``(k, B, P, P,
    3)``; on a card one CUDA graph of the k steps, with the capturable
    Adam."""
    st = _mod("train.state")
    opt = st.make_optimizer(cfg, m.to(device),
                            capturable=torch.device(device).type == "cuda")
    return st.make_chained_train_step(cfg, m, opt, device), opt
