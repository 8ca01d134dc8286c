"""Import original-repo PyTorch checkpoints into the port.

The original repo distributes pretrained weights as ``.pth.tar``
checkpoints whose ``state_dict`` follows ``LiftingBasedDWTNetWrapper``
naming. This tool maps those tensors onto the port's models: each tensor
is first brought into the flax layout and onto its flax path, as the JAX
package's importer does (this module keeps its own copy of that name map,
:func:`build_mapping` and :func:`build_postprocess_mapping`), and the
result is carried to the port's names and layout by ``tools/weights.py``
(``state_dict_from_flax`` / ``state_dict_from_flax_variables``). So a
transposed or grouped kernel crosses one rule each way, never a second
direct rule.

Supported surfaces: netType CDF97 / LiftingBasedNeuralWaveletv4, entropy
factorized / onlyEZWT / conditioned2ZTsepSubbands /
DWTConditioned2EntropyLayerZTBlock, both subband AEs, the EntropyBottleneck
internals, and the five restoration nets. Unknown keys are reported, never
silently dropped.

Layout conventions (original -> flax):
- Conv2d weight (O, I/g, kh, kw) -> kernel (kh, kw, I/g, O)
- ConvTranspose2d weight (I, O/g, kh, kw) of the stride-1 AEs, a conv with
  the taps flipped and the channel roles swapped -> (kh, kw, I/g, O)
- GDN beta/gamma are stored reparametrized (sqrt + pedestal), as here ->
  copied
- EntropyBottleneck ``_matrix{i}/_bias{i}/_factor{i}/quantiles`` -> copied
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from torch import nn

from ..config import Config
from . import weights


def _conv_w(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _convT_w(w, groups: int = 1) -> np.ndarray:
    """torch ConvTranspose2d weight -> flax conv kernel.

    A stride-1 ConvTranspose2d with padding p equals a Conv2d with the
    kernel flipped in both spatial dims and in/out channel roles swapped
    (padding k-1-p = SAME for odd k, p=k//2). torch stores the weight as
    ``(I, O/g, kh, kw)``; the flax grouped conv kernel is
    ``(kh, kw, I/g, O)`` with output channels group-major.
    """
    w = np.asarray(w)[:, :, ::-1, ::-1]
    i_total, o_per_g, kh, kw = w.shape
    i_per_g = i_total // groups
    w = w.reshape(groups, i_per_g, o_per_g, kh, kw)
    # kernel[u, v, i, g*O_g + o] = w[g, i, o, u, v]
    return np.transpose(w, (3, 4, 1, 0, 2)).reshape(
        kh, kw, i_per_g, groups * o_per_g)


def _set(tree: dict, path: str, value: np.ndarray, strict_shape=True):
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node[k]
    old = node[keys[-1]]
    if strict_shape and tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {path}: have {tuple(old.shape)}, "
            f"checkpoint gives {tuple(value.shape)}")
    node[keys[-1]] = value.astype(np.float32)


def _ae_entries(prefix: str, dst: str, berk: bool,
                in_ch: int) -> List[Tuple[str, str, str]]:
    """(torch_key, flax_path, kind) for one subband AE.

    The Berk AE's up path is ungrouped 3x3 stride-1 ConvTranspose2d
    (``lifting_dwt_nets.py:147-152``) -> kind ``convT`` (flip + swap);
    the plain AE's is grouped 1x1 with ``groups=in_ch``
    (``lifting_dwt_nets.py:106-110``) -> kind ``("convT", in_ch)``.
    """
    out = []
    convt = "convT" if berk else ("convT", in_ch)
    for j, idx in enumerate((0, 2, 4, 6)):
        out.append((f"{prefix}.ae_down.{idx}.weight",
                    f"{dst}/down_{j}/kernel", "conv"))
        out.append((f"{prefix}.ae_down.{idx}.bias",
                    f"{dst}/down_{j}/bias", "raw"))
        out.append((f"{prefix}.ae_up.{idx}.weight",
                    f"{dst}/up_{j}/kernel", convt))
        out.append((f"{prefix}.ae_up.{idx}.bias",
                    f"{dst}/up_{j}/bias", "raw"))
    if berk:  # Sequential(conv, GDN, conv, GDN, conv, GDN, conv)
        for j, idx in enumerate((1, 3, 5)):
            for side in ("down", "up"):
                out.append((f"{prefix}.ae_{side}.{idx}.beta",
                            f"{dst}/{side}_gdn_{j}/beta", "raw"))
                out.append((f"{prefix}.ae_{side}.{idx}.gamma",
                            f"{dst}/{side}_gdn_{j}/gamma", "raw"))
    return out


def _eb_entries(prefix: str, dst: str, n_filters: int = 4):
    out = []
    for i in range(n_filters + 1):
        out.append((f"{prefix}._matrix{i}", f"{dst}/matrix_{i}", "raw"))
        out.append((f"{prefix}._bias{i}", f"{dst}/bias_{i}", "raw"))
        if i < n_filters:
            out.append((f"{prefix}._factor{i}", f"{dst}/factor_{i}", "raw"))
    out.append((f"{prefix}.quantiles", f"{dst}/quantiles", "raw"))
    return out


def build_mapping(cfg: Config) -> List[Tuple[str, str, str]]:
    """All (torch_key, flax_path, kind) pairs for this config."""
    entries: List[Tuple[str, str, str]] = []
    planes = (["model"] if cfg.clrch == 3
              else [f"model{i}" for i in range(3)])
    dsts = (["codec"] if cfg.clrch == 3
            else [f"codecs_{i}" for i in range(3)])
    berk = cfg.autoencoder == "SubbandAutoEncoderBerk"
    L = cfg.dwtlevels
    for src, dst in zip(planes, dsts):
        # --- transform --------------------------------------------------
        if cfg.autoencoder != "none":
            entries += _ae_entries(f"{src}.autoencoder.Yl_ae",
                                   f"{dst}/transform/yl_ae", berk,
                                   1 * cfg.clrch)
            for i in range(L):
                entries += _ae_entries(f"{src}.autoencoder.Yh_ae.{i}",
                                       f"{dst}/transform/yh_ae_{i}", berk,
                                       3 * cfg.clrch)
        if cfg.netType == "LiftingBasedNeuralWaveletv4":
            n_stages = 1 if cfg.block_property == "same" else L
            pairs = cfg.num_lifting_perlayer
            for s in range(n_stages):
                for k in range(pairs):
                    for blk, mine in (("P_blocks", "p_blocks"),
                                      ("U_blocks", "u_blocks")):
                        tk = s * pairs + k
                        for c in range(4):
                            entries.append((
                                f"{src}.autoencoder.{blk}.{tk}.conv{c + 1}.weight",
                                f"{dst}/transform/stages_{s}/{mine}_{k}"
                                f"/Conv_{c}/kernel", "conv"))
                            entries.append((
                                f"{src}.autoencoder.{blk}.{tk}.conv{c + 1}.bias",
                                f"{dst}/transform/stages_{s}/{mine}_{k}"
                                f"/Conv_{c}/bias", "raw"))
                for j in range(2 * pairs):
                    entries.append((
                        f"{src}.autoencoder.preProcessingList.{j}.weight",
                        f"{dst}/transform/stages_{s}/skips_{j}/taps",
                        "skip"))
                if cfg.scale:
                    entries.append((f"{src}.autoencoder.nh",
                                    f"{dst}/transform/stages_{s}/nh", "flat1"))
                    entries.append((f"{src}.autoencoder.nl",
                                    f"{dst}/transform/stages_{s}/nl", "flat1"))
        # --- entropy model ----------------------------------------------
        em = f"{src}.entropymodel"
        de = f"{dst}/entropymodel"
        if cfg.entropy_layer == "factorized":
            entries += _eb_entries(f"{em}.ent_out_xe", f"{de}/eb_xe")
            for i in range(L):
                entries += _eb_entries(f"{em}.ent_out_xo_list.{i}",
                                       f"{de}/eb_xo_{i}")
        elif cfg.entropy_layer == "onlyEZWT":
            entries += _eb_entries(f"{em}.ent_out_xe", f"{de}/eb_xe")
            entries += _eb_entries(f"{em}.ent_out_xo", f"{de}/eb_xo")
            for i in range(L - 1):
                for j, idx in enumerate((0, 2, 4)):
                    entries.append((f"{em}.plc_list.{i}.{idx}.weight",
                                    f"{de}/plc_{i}/Conv_{j}/kernel", "conv"))
                    entries.append((f"{em}.plc_list.{i}.{idx}.bias",
                                    f"{de}/plc_{i}/Conv_{j}/bias", "raw"))
        elif cfg.entropy_layer == "conditioned2ZTsepSubbands":
            for i in range(L - 1):
                for j, idx in enumerate((0, 2)):
                    entries.append((f"{em}.plc_list.{i}.{idx}.weight",
                                    f"{de}/plc_{i}/Conv_{j}/kernel", "conv"))
                    entries.append((f"{em}.plc_list.{i}.{idx}.bias",
                                    f"{de}/plc_{i}/Conv_{j}/bias", "raw"))
                entries.append((f"{em}.csc_list.{i}.weight",
                                f"{de}/csc_{i}/kernel", "conv"))
                entries.append((f"{em}.csc_list.{i}.bias",
                                f"{de}/csc_{i}/bias", "raw"))
                for j, idx in enumerate((0, 2, 4, 6)):
                    entries.append((
                        f"{em}.cgp_out_xo_list.{i}.{idx}.weight",
                        f"{de}/cgp_{i}/Conv_{j}/kernel", "conv"))
                    entries.append((
                        f"{em}.cgp_out_xo_list.{i}.{idx}.bias",
                        f"{de}/cgp_{i}/Conv_{j}/bias", "raw"))
            for j, idx in enumerate((0, 2, 4, 6, 8)):
                entries.append((
                    f"{em}.csc_list.{L - 1}.{idx}.weight",
                    f"{de}/pixelcnn_xo/MaskedConv2d_{j}/kernel", "conv"))
                entries.append((
                    f"{em}.csc_list.{L - 1}.{idx}.bias",
                    f"{de}/pixelcnn_xo/MaskedConv2d_{j}/bias", "raw"))
                entries.append((
                    f"{em}.csc_xe.{idx}.weight",
                    f"{de}/pixelcnn_xe/MaskedConv2d_{j}/kernel", "conv"))
                entries.append((
                    f"{em}.csc_xe.{idx}.bias",
                    f"{de}/pixelcnn_xe/MaskedConv2d_{j}/bias", "raw"))
        elif cfg.entropy_layer == "DWTConditioned2EntropyLayerZTBlock":
            # original dep nets: per (finer level i coarse->fine, subband j)
            # one 5-conv Sequential per coset k, module lists
            # ``dep_{k+1}_list_{mu,sigma}`` indexed ``j + i*3``
            # (``LiftingBasedDWT_net.py:618-680, 711-745``); ours are
            # ``dep_{mu,sigma}_{idx}_{k}/Conv_{0..4}`` with the same idx.
            entries += _eb_entries(f"{em}.ent_out_xe", f"{de}/eb_xe")
            entries += _eb_entries(f"{em}.ent_out_xo", f"{de}/eb_xo")
            for idx in range((L - 1) * 3 * cfg.clrch):
                for k in range(4):
                    for nm in ("mu", "sigma"):
                        for j, sidx in enumerate((0, 2, 4, 6, 8)):
                            tk = f"{em}.dep_{k + 1}_list_{nm}.{idx}.{sidx}"
                            fx = f"{de}/dep_{nm}_{idx}_{k}/Conv_{j}"
                            entries.append((f"{tk}.weight", f"{fx}/kernel",
                                            "conv"))
                            entries.append((f"{tk}.bias", f"{fx}/bias",
                                            "raw"))
    return entries


def _conv_entries(tprefix: str, dst: str, bias: bool = True):
    out = [(f"{tprefix}.weight", f"params/{dst}/kernel", "conv")]
    if bias:
        out.append((f"{tprefix}.bias", f"params/{dst}/bias", "raw"))
    return out


def _bn_entries_pp(tprefix: str, dst: str):
    return [
        (f"{tprefix}.weight", f"params/{dst}/scale", "raw"),
        (f"{tprefix}.bias", f"params/{dst}/bias", "raw"),
        (f"{tprefix}.running_mean", f"batch_stats/{dst}/mean", "raw"),
        (f"{tprefix}.running_var", f"batch_stats/{dst}/var", "raw"),
    ]


def build_postprocess_mapping(cfg: Config) -> List[Tuple[str, str, str]]:
    """(torch_key, '<collection>/<flax_path>', kind) for the restoration net
    selected by ``cfg.postprocess``: the original repo stores its weights as a
    separate ``state_dict_postprocess`` checkpoint entry
    (``agents/base.py:111-124``; architectures in
    ``post_processing_networks.py``)."""
    kind = cfg.postprocess
    e: List[Tuple[str, str, str]] = []
    if kind == "DnCNN":
        # NNRegressor-style DnCNN(D=clrch, C=64) — the module-scope name
        # the agent imports (the 17-layer Sequential DnCNN earlier in the
        # original file is shadowed; see models/postprocess.py)
        D = cfg.clrch
        for i in range(D + 2):
            e += _conv_entries(f"conv.{i}", f"Conv_{i}")
        for i in range(D):
            e += _bn_entries_pp(f"bn.{i}", f"BatchNorm_{i}")
    elif kind == "iwave":
        e += _conv_entries("convFilter", "Conv_0")
        for i in range(cfg.resnetlevel):
            e += _conv_entries(f"resNetList.{i}.resNet.0",
                               f"PostProcessResidual_{i}/Conv_0")
            e += _conv_entries(f"resNetList.{i}.resNet.2",
                               f"PostProcessResidual_{i}/Conv_1")
        e += _conv_entries("interConvFilter", "Conv_1")
        e += _conv_entries("outputConvFilter", "Conv_2")
    elif kind == "IRCNN":
        # B.sequential flattens conv/relu pairs: convs at 0,2,..,12 (original :99-114)
        for j, i in enumerate(range(0, 13, 2)):
            e += _conv_entries(f"model.{i}", f"Conv_{j}")
    elif kind == "DUDnCNN":
        D = cfg.resnetlevel
        for i in range(D + 2):
            e += _conv_entries(f"conv.{i}", f"Conv_{i}")
        for i in range(D):
            e += _bn_entries_pp(f"bn.{i}", f"BatchNorm_{i}")
    elif kind == "DIDN":
        # top level (original :276-330); call-order flax names
        e += _conv_entries("conv_input", "Conv_0", bias=False)
        e.append(("relu1.weight", "params/PReLU_0/negative_slope", "prelu"))
        e += _conv_entries("conv_down", "Conv_1", bias=False)
        e.append(("relu2.weight", "params/PReLU_1/negative_slope", "prelu"))
        res_convs = ("conv1", "conv3", "conv5", "conv7", "conv9", "conv11",
                     "conv13", "conv15", "conv16", "conv18", "conv20",
                     "conv21", "conv23", "conv25")
        res_prelus = ("relu2", "relu4", "relu6", "relu8", "relu10", "relu12",
                      "relu17", "relu22", "relu24")
        for b, name in enumerate("ABCDEF"):
            blk = f"_DIDNResidualBlock_{b}"
            for j, t in enumerate(res_convs):
                e += _conv_entries(f"recursive_{name}.{t}",
                                   f"{blk}/Conv_{j}", bias=False)
            for j, t in enumerate(res_prelus):
                e.append((f"recursive_{name}.{t}.weight",
                          f"params/{blk}/PReLU_{j}/negative_slope", "prelu"))
        for j in range(9):  # shared recon block (original :222-274)
            e += _conv_entries(f"recon.conv{2 * j + 1}",
                               f"_DIDNReconBlock_0/Conv_{j}", bias=False)
        for j in range(8):
            e.append((f"recon.relu{2 * j + 2}.weight",
                      f"params/_DIDNReconBlock_0/PReLU_{j}/negative_slope",
                      "prelu"))
        e += _conv_entries("conv_mid", "Conv_2", bias=False)
        e.append(("relu3.weight", "params/PReLU_2/negative_slope", "prelu"))
        e += _conv_entries("conv_mid2", "Conv_3", bias=False)
        e.append(("relu4.weight", "params/PReLU_3/negative_slope", "prelu"))
        e += _conv_entries("conv_output", "Conv_4", bias=False)
    else:
        raise ValueError(f"unknown postprocess {kind!r}")
    return e


_SKIP_SUBSTRINGS = (".mask", "._offset", "._quantized_cdf", "._cdf_length",
                    ".target", "scale_table", ".scl_", ".scb_",
                    # wavelet_forward/inverse_v2 hold the same P/U/skip/nh/nl
                    # modules as autoencoder.{P,U}_blocks etc., so their
                    # state_dict keys are pure aliases (lifting_dwt_nets.py:
                    # 705-722)
                    ".waveletForward.", ".waveletInverse.",
                    # GDN NonNegativeParametrizer constants (gdn.py:24-43)
                    ".pedestal", ".lower_bound.bound")


def _to_flax(w: np.ndarray, kind, clrch: int) -> np.ndarray:
    """One original tensor in the flax layout of its mapping ``kind``."""
    if kind == "conv":
        return _conv_w(w)
    if kind == "convT":
        return _convT_w(w)
    if isinstance(kind, tuple) and kind[0] == "convT":
        return _convT_w(w, groups=kind[1])
    if kind == "skip":        # (1,1,3,1) fixed conv -> (3, C) taps
        return np.tile(w.reshape(3)[:, None], (1, clrch))
    if kind == "flat1":       # (1,1,1,1) -> (1,)
        return w.reshape(1)
    if kind == "prelu":       # (1,) -> a scalar
        return w.reshape(())
    return w


def _import(tree: dict, mapping, state_dict: Dict, clrch: int) -> set:
    """Write every mapped tensor of ``state_dict`` into ``tree`` (flax
    layout, shapes checked); returns the original keys used."""
    used = set()
    for torch_key, path, kind in mapping:
        if torch_key not in state_dict:
            continue
        _set(tree, path, _to_flax(np.asarray(state_dict[torch_key]), kind,
                                  clrch))
        used.add(torch_key)
    return used


def import_state_dict(model: nn.Module, state_dict: Dict
                      ) -> Tuple[Dict, List[str]]:
    """Map an original ``state_dict`` onto a port ``CodecWrapper``.

    Starts from the model's own parameters (so a tensor the checkpoint
    lacks keeps its value) and returns ``(port_state_dict,
    unmatched_original_keys)``; the model itself is not changed
    (``model.load_state_dict(port_state_dict)`` loads the result)."""
    cfg = model.cfg
    tree = weights.unflatten_params(
        weights.flax_params_from_state_dict(model.state_dict()))
    used = _import(tree, build_mapping(cfg), state_dict, cfg.clrch)
    unmatched = [k for k in state_dict
                 if k not in used
                 and not any(s in k for s in _SKIP_SUBSTRINGS)]
    return weights.state_dict_from_flax(weights.flatten_params(tree)), \
        unmatched


def import_postprocess_state_dict(cfg: Config, net: nn.Module,
                                  state_dict: Dict
                                  ) -> Tuple[Dict, List[str]]:
    """Map an original ``state_dict_postprocess`` onto the restoration net
    ``cfg.postprocess`` names (its parameters and running statistics).

    Returns ``(port_state_dict, unmatched_original_keys)``."""
    tree = weights.flax_variables_from_state_dict(net.state_dict())
    used = _import(tree, build_postprocess_mapping(cfg), state_dict,
                   cfg.clrch)
    unmatched = [k for k in state_dict
                 if k not in used
                 and not any(s in k for s in _SKIP_SUBSTRINGS)
                 and "num_batches_tracked" not in k]
    return weights.state_dict_from_flax_variables(tree), unmatched


def load_reference_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load an original ``.pth.tar`` on the CPU and return its
    ``state_dict`` (or the whole file where it has none) as numpy."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}
