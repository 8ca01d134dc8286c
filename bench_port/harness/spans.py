"""Spans at the program's layer boundaries, recorded from outside it.

A per-layer metric's reader names the spans it needs (its ``SPANS`` list).
Each entry picks modules of the program's model by the attribute name under
which they sit (``attr``) or by class name (``classes``; ``kernel`` and
``grouped`` narrow a conv class by its weight), and names the methods to
wrap (``forward``, or ``encode``/``decode``, which the program calls
directly and which no module hook would see). A wrapped call runs inside
``record_function("span.<name>")``, so the device work it launches is
attributed to it. The program's files are not edited; the wrappers live on
the model instance of a traced run only, and do nothing inside a CUDA
graph's replay.
"""

from __future__ import annotations

import functools

import torch


def _matches(spec: dict, attr: str, module) -> bool:
    if "attr" in spec and attr != spec["attr"]:
        return False
    if "classes" in spec:
        if type(module).__name__ not in spec["classes"]:
            return False
        w = getattr(module, "weight", None)
        if "kernel" in spec and (w is None or w.dim() != 4
                                 or w.shape[-1] != spec["kernel"]):
            return False
        if spec.get("grouped") and getattr(module, "groups", 1) <= 1:
            return False
    return True


def _wrap(module, method: str, name: str) -> None:
    inner = getattr(module, method)

    @functools.wraps(inner)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return inner(*args, **kwargs)

    setattr(module, method, wrapped)


def install(model, specs) -> dict:
    """Wrap every module that a spec picks; returns {span: modules}."""
    found = {}
    for spec in specs:
        mods = [m for path, m in model.named_modules()
                if _matches(spec, path.rsplit(".", 1)[-1], m)]
        for m in mods:
            for method in spec["methods"]:
                _wrap(m, method, f"span.{spec['span']}")
        found[spec["span"]] = found.get(spec["span"], 0) + len(mods)
    return found
