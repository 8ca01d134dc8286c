"""Carrying weights between the flax tree and the port, both ways.

A flax params tree is read as a flat ``{keystr: ndarray}`` dict, the format
of the committed ``results/ckpt_snapshots/*.npz`` (f16 leaves plus an
``__iteration__`` entry), e.g.
``"['codecs_0']['entropymodel']['plc_0']['Conv_1']['kernel']"``.
The port names that parameter ``codecs.0.entropymodel.plc_0.Conv_1.weight``.

- conv ``kernel`` (kh, kw, in/G, out) -> ``weight`` (out, in/G, kh, kw)
  (it must be 4-D); a conv without a bias has no ``bias`` leaf on either
  side;
- the kernel of a flax transposed conv, named by :data:`TRANSPOSED` (a
  ``ConvTranspose_*`` module, or BasicWavelet's ``inv_{i}_1``),
  (kh, kw, in, out) becomes ``F.conv_transpose2d``'s (in, out, kh, kw)
  with its taps mirrored, since flax's transposed conv
  (``transpose_kernel=False``) applies tap ``[kh-1-a, kw-1-b]`` where
  PyTorch's applies ``[a, b]``;
- the kernel of a ``Dense_*`` module (:data:`DENSE`), (in, out), becomes
  ``nn.Linear``'s (out, in) (it must be 2-D);
- ``bias``, GDN ``beta``/``gamma`` (reparametrized), lifting ``taps`` and
  gains ``nh``/``nl``, GroupNorm ``scale``, the CBAM head's 0-d
  ``res_weight``, and the entropy bottlenecks' ``matrix_i``, ``bias_i``,
  ``factor_i`` and ``quantiles`` are copied raw; so are the restoration
  nets' PReLU ``negative_slope`` and BatchNorm ``scale`` (params) and
  running ``mean`` and ``var`` (flax's ``batch_stats`` collection, buffers
  in the port).

The rules key on module names, never on a leaf's rank. A restoration net's
``variables`` (``params`` and ``batch_stats``) travel through
:func:`state_dict_from_flax_variables` and
:func:`flax_variables_from_state_dict`.

A gradient tree has the parameter tree's shape, so the same functions carry
gradients. :func:`flax_params_from_state_dict` is the inverse: a checkpoint
trained by the port loads into the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_SEGMENT = re.compile(r"\['([^']*)'\]")
_RAW_LEAF = re.compile(
    r"bias|beta|gamma|taps|nh|nl|scale|res_weight|quantiles"
    r"|negative_slope|mean|var|(matrix|bias|factor)_\d+")
# leaves of flax's ``batch_stats`` collection (a BatchNorm's running stats)
BATCH_STATS = ("mean", "var")
SKIP_KEYS = ("__iteration__",)
# port parameter names (dotted) of flax transposed convs (a
# ``ConvTranspose_*`` module anywhere; BasicWavelet's ``inv_{i}_1``, a
# transform's own child) and of flax dense layers
TRANSPOSED = re.compile(r"(.*\.)?ConvTranspose_\d+\.weight"
                        r"|(.*\.transform\.)?inv_\d+_1\.weight")
DENSE = re.compile(r"(.*\.)?Dense_\d+\.weight")


def _kind(name: str) -> str:
    """'transposed', 'dense' or 'conv' for a port ``*.weight`` name."""
    if TRANSPOSED.fullmatch(name):
        return "transposed"
    if DENSE.fullmatch(name):
        return "dense"
    return "conv"


def _check_rank(t: torch.Tensor, kind: str, what: str) -> None:
    want = 2 if kind == "dense" else 4
    if t.dim() != want:
        raise ValueError(f"{what}: a {kind} kernel must be {want}-D, got "
                         f"{tuple(t.shape)}")


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping (a flax params dict) -> ``{keystr: ndarray}``."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict:
    """Inverse of :func:`flatten_params`: ``{keystr: ndarray}`` -> nested
    dict (a flax params tree with numpy leaves)."""
    tree: Dict = {}
    for key, value in flat.items():
        if key in SKIP_KEYS:
            continue
        *path, leaf = _SEGMENT.findall(key)
        node = tree
        for s in path:
            node = node.setdefault(s, {})
        node[leaf] = value
    return tree


def port_name(flax_key: str) -> str:
    """Flax keystr -> port parameter name."""
    segs = _SEGMENT.findall(flax_key)
    if not segs or "".join(f"['{s}']" for s in segs) != flax_key:
        raise KeyError(f"not a flax keystr: {flax_key!r}")
    *path, leaf = segs
    if leaf == "kernel":
        leaf = "weight"
    elif not _RAW_LEAF.fullmatch(leaf):
        raise KeyError(f"unknown parameter kind {leaf!r} in {flax_key!r}")
    out = []
    for s in path:
        m = re.fullmatch(r"codecs_(\d+)", s)
        out.append(f"codecs.{m.group(1)}" if m else s)
    return ".".join(out + [leaf])


def state_dict_from_flax(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """``{keystr: ndarray}`` -> port ``state_dict`` entries (fp32)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        if key in SKIP_KEYS:
            continue
        name = port_name(key)
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if name.rsplit(".", 1)[-1] == "weight":
            kind = _kind(name)
            _check_rank(t, kind, key)
            if kind == "transposed":
                t = t.permute(2, 3, 0, 1).flip(2, 3)
            elif kind == "dense":
                t = t.t()
            else:
                t = t.permute(3, 2, 0, 1)
        out[name] = t.contiguous()
    return out


def flax_key(name: str) -> str:
    """Port parameter name -> flax keystr (inverse of :func:`port_name`)."""
    *path, leaf = re.sub(r"\bcodecs\.(\d+)", r"codecs_\1", name).split(".")
    if leaf == "weight":
        leaf = "kernel"
    elif not _RAW_LEAF.fullmatch(leaf):
        raise KeyError(f"unknown parameter kind {leaf!r} in {name!r}")
    return "".join(f"['{s}']" for s in path + [leaf])


def flax_params_from_state_dict(sd: Mapping[str, torch.Tensor]
                                ) -> Dict[str, np.ndarray]:
    """Port ``state_dict`` -> ``{keystr: ndarray}`` in the flax layout (fp32;
    :func:`unflatten_params` makes the nested tree). Inverse of
    :func:`state_dict_from_flax`."""
    out: Dict[str, np.ndarray] = {}
    for name, t in sd.items():
        t = t.detach().to("cpu", torch.float32)
        if name.rsplit(".", 1)[-1] == "weight":
            kind = _kind(name)
            _check_rank(t, kind, name)
            if kind == "transposed":
                t = t.flip(2, 3).permute(2, 3, 0, 1)
            elif kind == "dense":
                t = t.t()
            else:
                t = t.permute(2, 3, 1, 0)
        # (np.ascontiguousarray would make a 0-d leaf 1-d)
        out[flax_key(name)] = t.contiguous().numpy().copy()
    return out


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Fill every parameter of ``model`` from ``flat``; raises on a flax key
    with no parameter, a parameter with no flax key, or a shape mismatch."""
    sd = state_dict_from_flax(flat)
    own = model.state_dict()
    unused = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if unused or missing:
        raise KeyError(f"flax keys without a port parameter: {unused[:8]} "
                       f"({len(unused)}); port parameters without a flax key: "
                       f"{missing[:8]} ({len(missing)})")
    for name, t in sd.items():
        if own[name].shape != t.shape:
            raise ValueError(f"{name}: flax shape {tuple(t.shape)} != port "
                             f"shape {tuple(own[name].shape)}")
    model.load_state_dict(sd, strict=True)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """A params snapshot written by ``scripts/rd_sweep.py``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k not in SKIP_KEYS}


def state_dict_from_flax_variables(variables: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """A flax ``variables`` dict (nested ``params`` and ``batch_stats``) ->
    port ``state_dict`` entries, the running statistics as buffers."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        out.update(state_dict_from_flax(
            flatten_params(variables.get(collection, {}))))
    return out


def flax_variables_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Port ``state_dict`` -> a nested flax ``variables`` dict with numpy
    leaves (inverse of :func:`state_dict_from_flax_variables`)."""
    flat = flax_params_from_state_dict(sd)
    split: Dict[str, Dict[str, np.ndarray]] = {"params": {},
                                               "batch_stats": {}}
    for key, value in flat.items():
        leaf = _SEGMENT.findall(key)[-1]
        split["batch_stats" if leaf in BATCH_STATS else "params"][key] = value
    return {k: unflatten_params(v) for k, v in split.items()}
