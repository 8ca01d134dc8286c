"""Checkpoint save/load: one ``torch.save`` file per checkpoint.

The payload is a single dict: epoch, iteration, best validation loss, the
model's and the optimizer's ``state_dict`` and the host-side scheduler,
loss-switch and logger states. ``model_best`` is kept beside the rolling
checkpoint.

A save writes a temporary file in the same directory and swaps it in with
``os.replace`` only when the write has finished, so an interrupted save
leaves the previous checkpoint whole.

As in the JAX package (and unlike the original code, which saves the
optimizer state but never restores it), a resumed run restores the full
optimizer state and is a true continuation.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, BinaryIO, Callable, Dict, Optional

import torch

SUFFIX = ".pt"


def checkpoint_path(checkpoint_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(checkpoint_dir, name + SUFFIX))


def _write_atomic(target: str, write: Callable[[BinaryIO], None]) -> None:
    """``write(fh)`` into a temporary file beside ``target``, then swap it
    in."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(target) + ".",
                               suffix=".tmp", dir=os.path.dirname(target))
    try:
        with os.fdopen(fd, "wb") as fh:
            write(fh)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(checkpoint_dir: str, payload: Dict[str, Any],
                    is_best: bool = False, name: str = "checkpoint") -> None:
    """Serialise ``payload`` once into checkpoint ``name``; ``is_best`` also
    copies the written file onto ``model_best``."""
    path = checkpoint_path(checkpoint_dir, name)
    _write_atomic(path, lambda fh: torch.save(payload, fh))
    if is_best:
        def copy(fh):
            with open(path, "rb") as src:
                shutil.copyfileobj(src, fh)
        _write_atomic(checkpoint_path(checkpoint_dir, "model_best"), copy)


def load_checkpoint(checkpoint_dir: str, name: str = "checkpoint",
                    map_location=None) -> Optional[Dict[str, Any]]:
    """The payload of checkpoint ``name``, or None when there is none."""
    path = checkpoint_path(checkpoint_dir, name)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True)
