"""Typed experiment configuration and device selection.

A copy of the JAX package's ``Config`` schema and JSON loader, so that both
packages read the same config files, plus :func:`flagship_config` (the
paper's main configuration) and :func:`resolve_device`.

Sweeps: :func:`expand_sweep` turns a ``multi_agent``/``multi_param`` config
into one resolved config per value, with ``exp_name`` rewritten to
``<multi_exp_name>/exp_<value>``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch

NET_TYPES = (
    "CDF97",
    "LiftingBasedNeuralWaveletv4",
    "BasicWavelet",
    "AttentionWavelet",
    "AttentionWaveletPostProcessing",
    "QuincunxLifting",
)
ENTROPY_LAYERS = (
    "factorized",
    "onlyEZWT",
    "conditioned2ZTsepSubbands",
    "DWTConditioned2EntropyLayerZTBlock",
)
AUTOENCODERS = ("SubbandAutoEncoder", "SubbandAutoEncoderBerk", "none")
POSTPROCESS = ("none", "DnCNN", "iwave", "IRCNN", "DIDN", "DUDnCNN")
MODES = ("train", "train_postprocess", "validate", "validate_recu_reco",
         "test", "debug")
BLOCK_PROPERTIES = ("same", "different")
# quincunx split modes: "hv" (horizontal, then vertical lifts), 1 ("1p3"),
# 2 ("2p2"), 3 ("3p1"); :func:`..ops.quincunx.split_mode_channels` refuses
# any other value when the transform is built, as the JAX package does
SPLIT_MODES = ("hv", 1, 2, 3)


@dataclass
class Config:
    """The config surface shared with the JAX package (same names and
    defaults), so one JSON file configures both."""

    exp_name: str = "exp"
    multi_exp_name: str = ""
    agent: str = "LiftingBasedDWTAgent"
    mode: str = "train"
    resume_training: bool = False
    imshow_validation: bool = False
    seed: int = 1337

    # --- model selection -------------------------------------------------
    clrch: int = 3                  # 3 = joint RGB, 1 = three YCbCr planes
    netType: str = "CDF97"
    entropy_layer: str = "factorized"
    autoencoder: str = "SubbandAutoEncoder"
    postprocess: str = "none"

    # --- transform hyperparameters --------------------------------------
    dwtlevels: int = 4
    num_lifting_perlayer: int = 2
    filtersize: int = 5
    resnetlevel: int = 6
    block_property: str = "same"
    scale: int = 0                  # 1 = learned subband gains nh/nl
    linearity_flag: int = 1         # 1 = tanh inside the P/U blocks
    depth_scale: int = 2            # P/U hidden width = depth_scale * 8
    res_connection_weight: float = 0.1
    split_mode: Union[str, int] = "hv"
    lif_prec_bits: int = 0

    # --- training --------------------------------------------------------
    batch_size: int = 4
    patch_size: int = 256
    grad_acc_iters: int = 1
    loss_prnt_iters: int = 3600
    val_batch_size: int = 1
    val_patch_size: int = 256
    test_patch_size: int = 0
    learning_rate: float = 1e-4
    lambda_: Union[float, List[float]] = 0.01
    loss_switch_thr: float = 0.0015
    training_loss_switch: int = 1
    max_epoch: int = 3000
    validate_every: int = 1
    checkpoint_file: str = "checkpoint"
    steps_per_epoch: int = 0
    save_every_epochs: int = 0
    profile_steps: int = 0
    phase_timers: bool = False

    # --- sweeps ----------------------------------------------------------
    multi_agent: bool = False
    multi_param: str = "lambda_"

    # --- data ------------------------------------------------------------
    num_train_dirs: int = 1
    train_data_1: str = ""
    train_data_2: str = ""
    train_data_3: str = ""
    train_data_4: str = ""
    test_data: str = ""
    valid_data: str = ""

    # --- entropy-model options -------------------------------------------
    zt_upsample: str = "nearest"

    # --- execution knobs of the JAX package, accepted for config parity --
    mesh_shape: Sequence[int] = (1,)
    mesh_axis_names: Sequence[str] = ("data",)
    steps_per_call: int = 1
    dtype: str = "float32"          # compute dtype of the heavy conv stacks
    tile_size: int = 0
    halo_eval: bool = False
    jit_backend: Optional[str] = None

    # --- experiment dirs -------------------------------------------------
    summary_dir: str = ""
    checkpoint_dir: str = ""
    out_dir: str = ""
    log_dir: str = ""

    def validate(self) -> "Config":
        if not self.exp_name:
            raise ValueError("exp_name must be non-empty")
        for name, allowed in (("netType", NET_TYPES),
                              ("entropy_layer", ENTROPY_LAYERS),
                              ("autoencoder", AUTOENCODERS),
                              ("postprocess", POSTPROCESS),
                              ("mode", MODES),
                              ("block_property", BLOCK_PROPERTIES)):
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"{name} {getattr(self, name)!r} not in {allowed}")
        if self.clrch not in (1, 3):
            raise ValueError("clrch must be 1 or 3")
        if self.zt_upsample not in ("nearest", "learned"):
            raise ValueError("zt_upsample must be 'nearest' or 'learned'")
        if self.dwtlevels < 1:
            raise ValueError("dwtlevels must be >= 1")
        return self


# Key aliases seen across the reference's config files.
_ALIASES = {"autoencoderFlag": "autoencoder", "lambda": "lambda_"}
# Keys that are accepted and ignored (hardware/loader knobs, dead keys).
_IGNORED = {"cuda", "gpu_device", "async_loading", "pin_memory", "data_mode",
            "gamma", "log_interval", "test_every"}


def config_from_dict(raw: dict) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    kwargs: dict = {}
    for key, value in raw.items():
        key = _ALIASES.get(key, key)
        if key in _IGNORED:
            continue
        if key in known:
            kwargs[key] = value
    return Config(**kwargs).validate()


def get_config_from_json(path: str) -> Config:
    with open(path, "r") as fh:
        return config_from_dict(json.load(fh))


def process_config(path: str, experiments_root: str = "experiments") -> Config:
    """Load a config and create its experiment directory tree
    ``<experiments_root>/<exp_name>/{summaries,checkpoints,out,logs}``."""
    return _attach_dirs(get_config_from_json(path), experiments_root)


def _attach_dirs(cfg: Config, experiments_root: str) -> Config:
    base = os.path.join(experiments_root, cfg.exp_name)
    cfg.summary_dir = os.path.join(base, "summaries")
    cfg.checkpoint_dir = os.path.join(base, "checkpoints")
    cfg.out_dir = os.path.join(base, "out")
    cfg.log_dir = os.path.join(base, "logs")
    for d in (cfg.summary_dir, cfg.checkpoint_dir, cfg.out_dir, cfg.log_dir):
        os.makedirs(d, exist_ok=True)
    return cfg


def expand_sweep(cfg: Config, experiments_root: str = "experiments"
                 ) -> List[Config]:
    """Expand a ``multi_agent`` sweep into one config per value of
    ``multi_param``, each with a scalar value, its own ``exp_name``
    ``<multi_exp_name>/exp_<value>`` and its own directories."""
    if not cfg.multi_agent:
        return [cfg]
    values = getattr(cfg, cfg.multi_param)
    if not isinstance(values, (list, tuple)):
        values = [values]
    out = []
    for v in values:
        sub = dataclasses.replace(cfg)
        setattr(sub, cfg.multi_param, v)
        sub.multi_agent = False
        sub.exp_name = os.path.join(cfg.multi_exp_name or cfg.exp_name,
                                    f"exp_{v}")
        out.append(_attach_dirs(sub, experiments_root))
    return out


def to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def flagship_config(**kw) -> Config:
    """The paper's main configuration: learned lifting DWT + zerotree/causal
    entropy model + GDN scaling AEs, per-channel YCbCr models."""
    base = dict(netType="LiftingBasedNeuralWaveletv4",
                entropy_layer="conditioned2ZTsepSubbands",
                autoencoder="SubbandAutoEncoderBerk",
                clrch=1, dwtlevels=4, num_lifting_perlayer=2, filtersize=5,
                depth_scale=2, block_property="same", scale=0,
                linearity_flag=1, res_connection_weight=0.1,
                lambda_=117.3, learning_rate=1e-4)
    base.update(kw)
    return Config(**base).validate()


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    """Operand dtype of the heavy conv stacks (params stay fp32).

    bf16 keeps the lifting transform exactly invertible (the inverse
    subtracts the same deterministic P/U outputs); the entropy and
    quantization arithmetic stays fp32.
    """
    if cfg.dtype == "bfloat16":
        return torch.bfloat16
    return None


def full_fp32() -> None:
    """Run fp32 convs and matmuls at full fp32 precision on the card, as the
    JAX package's reference computes them: PyTorch lets cuDNN convs (and,
    on request, matmuls) round their operands to TF32. Every entry point
    calls it (the CLI, the agent, ``CodecCoder``, ``make_train_step``,
    ``make_eval_step`` and their postprocess forms, ``tools/rd_heldout.py``);
    a bf16 config's fp32 parts (onlyEZWT's plc, the bias adds, the entropy
    models' fp32 convs) stay fp32 with it. The flags are process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
