"""Transform-path ops: color, GDN, masked convs, lifting, the 9/7 DWT,
scaling AEs, and the hand-written kernels (the 3x3 conv: fp32 and bf16
tensor-core forms; the 9/7 ladder) with their nvcc build."""

from typing import List

from torch import nn


def register_list(parent: nn.Module, prefix: str, modules) -> List[nn.Module]:
    """Register ``modules`` as ``{prefix}_{i}`` (the flax names of a module
    list built in ``setup``) and return them as a plain list."""
    out = []
    for i, m in enumerate(modules):
        parent.add_module(f"{prefix}_{i}", m)
        out.append(m)
    return out
