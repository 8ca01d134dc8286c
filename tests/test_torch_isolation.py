"""The port stands alone: no source of it (nor ``chip_smoke.py``) imports
JAX, flax, optax or the JAX package, the coding modules included; it
imports with those blocked; its copies of the host C++ equal the JAX
package's byte for byte; the flagship snapshot fills every port parameter;
the CDF 9/7 + factorized config builds at full width; and its entry points
(eval step, train step, agent, CLI, codec coder) do not fall back to the
CPU on their own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    cli, config)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
    codec_coder)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    loop, state)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "imagecompressionlearnedliftingandlearnedtreebasedmodels_torch"
BANNED = ("jax", "jaxlib", "flax", "optax",
          "imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu")
SNAPSHOT = os.path.join(ROOT, "results", "ckpt_snapshots",
                        "flagship_lam2000.npz")
CDF97 = os.path.join(ROOT, "configs", "cdf97_factorized.json")


def _sources():
    for base, _, files in os.walk(os.path.join(ROOT, PORT)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax():
    bad = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if n.split(".")[0] in BANNED]
    assert bad == []


def test_package_imports_with_jax_blocked():
    code = f"""
import importlib, pkgutil, sys
BANNED = {BANNED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import {PORT} as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
assert not [m for m in sys.modules if m.split(".")[0] in BANNED]
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_kernel_sources_are_in_the_package():
    csrc = os.path.join(ROOT, PORT, "csrc")
    assert sorted(f for f in os.listdir(csrc) if f.endswith(".cu")) == [
        "conv1x1g.cu", "conv3x3_halo.cu", "conv_v2.cu", "lift97.cu"]


@pytest.mark.parametrize("name", ["rans_core.h", "rans.cpp",
                                  "wavefront_ctx.cpp"])
def test_host_coding_sources_are_copies_of_the_jax_packages(name):
    """The port builds its own copies of the host C++; they must not drift
    from the JAX package's, or the two packages' streams part."""
    jax_src = os.path.join(ROOT, BANNED[-1], "coding", "csrc", name)
    with open(os.path.join(ROOT, PORT, "csrc", name), "rb") as a, \
            open(jax_src, "rb") as b:
        assert a.read() == b.read()


def test_codec_coder_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.flagship_config(dwtlevels=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec_coder.CodecCoder(cfg, CodecWrapper(cfg))
    coder = codec_coder.CodecCoder(cfg, CodecWrapper(cfg), device="cpu")
    assert coder.device.type == "cpu"
    assert next(coder.model.parameters()).device.type == "cpu"


def test_snapshot_fills_every_parameter():
    model = CodecWrapper(config.flagship_config())
    flat = weights.load_npz(SNAPSHOT)
    sd = weights.state_dict_from_flax(flat)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == len(flat) == 714
    weights.load_flax_params(model, flat)
    key = "['codecs_0']['entropymodel']['plc_0']['Conv_1']['kernel']"
    got = model.state_dict()["codecs.0.entropymodel.plc_0.Conv_1.weight"]
    assert torch.equal(got, torch.from_numpy(
        flat[key].astype("float32")).permute(3, 2, 0, 1))


def test_unmatched_keys_raise_on_either_side():
    model = CodecWrapper(config.flagship_config())
    flat = weights.load_npz(SNAPSHOT)
    missing = dict(flat)
    missing.pop("['codecs_2']['transform']['yl_ae']['up_gdn_1']['beta']")
    with pytest.raises(KeyError):
        weights.load_flax_params(model, missing)
    extra = dict(flat)
    extra["['codecs_0']['entropymodel']['plc_9']['Conv_0']['bias']"] = (
        flat["['codecs_0']['entropymodel']['plc_0']['Conv_0']['bias']"])
    with pytest.raises(KeyError):
        weights.load_flax_params(model, extra)


def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.flagship_config(dwtlevels=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state.make_eval_step(cfg, CodecWrapper(cfg))
    step = state.make_eval_step(cfg, CodecWrapper(cfg), device="cpu")
    out, xhat = step(torch.rand(1, 3, 16, 16))
    assert torch.isfinite(out.loss) and xhat.device.type == "cpu"


def test_training_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = config.flagship_config(dwtlevels=2, batch_size=1, patch_size=16,
                                 steps_per_epoch=1, max_epoch=0)
    model = CodecWrapper(cfg)
    opt = state.make_optimizer(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state.make_train_step(cfg, model, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.LiftingDWTAgent(cfg)
    with open("c.json", "w") as fh:
        fh.write(config.to_json(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["c.json"])
    step = state.make_train_step(cfg, model, opt, device="cpu")
    out, _ = step(torch.rand(1, 3, 16, 16), torch.Generator().manual_seed(0),
                  1e-4, 1.0)
    assert torch.isfinite(out.loss) and out.loss.device.type == "cpu"
    assert loop.LiftingDWTAgent(cfg, device="cpu").device.type == "cpu"
    assert cli.main(["--device", "cpu", "c.json"]) == 0


def test_cdf97_config_builds_and_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """``configs/cdf97_factorized.json`` at full width: one joint-RGB codec,
    4 levels, pointwise AEs of width 32, bottlenecks with filters (3,3,3,3):
    155 tensors, 174,681 parameters, every one named as in the flax tree."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.get_config_from_json(CDF97)
    model = CodecWrapper(cfg, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert len(sd) == 155 and sum(t.numel() for t in sd.values()) == 174681
    assert all(n.startswith("codec.") for n in sd)
    flat = weights.flax_params_from_state_dict(sd)
    assert flat["['codec']['entropymodel']['eb_xo_3']['matrix_4']"].shape \
        == (9, 1, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state.make_eval_step(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state.make_train_step(cfg, model, state.make_optimizer(cfg, model))
    out, xhat = state.make_eval_step(cfg, model, device="cpu")(
        torch.rand(1, 3, 32, 48))
    assert torch.isfinite(out.loss) and xhat.shape == (1, 3, 32, 48)


JAX_PACKAGE = BANNED[-1]
# JAX package sources without a port module of the same path, each with
# where it went or why it has none
NOT_AT_THE_SAME_PATH = {
    "ops/pallas_conv.py": "ops/conv3x3_halo.py (the 3x3 conv kernel, "
                          "csrc/conv3x3_halo.cu)",
    "coding/csrc/rans.cpp": "csrc/rans.cpp (a byte copy)",
    "coding/csrc/rans_core.h": "csrc/rans_core.h (a byte copy)",
    "coding/csrc/wavefront_ctx.cpp": "csrc/wavefront_ctx.cpp (a byte copy)",
    "utils/compile_cache.py": "not ported, by design: XLA's persistent "
                              "compilation cache",
}


def _jax_package_sources():
    base = os.path.join(ROOT, JAX_PACKAGE)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith((".py", ".cpp", ".h", ".json")):
                yield os.path.relpath(os.path.join(d, f), base)


def test_every_jax_module_has_a_port_counterpart():
    missing = [rel for rel in sorted(_jax_package_sources())
               if not os.path.exists(os.path.join(ROOT, PORT, rel))
               and rel not in NOT_AT_THE_SAME_PATH]
    assert missing == []
    for rel, where in NOT_AT_THE_SAME_PATH.items():
        assert os.path.exists(os.path.join(ROOT, JAX_PACKAGE, rel)), rel
        target = where.split(" ")[0]
        if not where.startswith("not ported"):
            assert os.path.exists(os.path.join(ROOT, PORT, target)), target
            assert not os.path.exists(os.path.join(ROOT, PORT, rel)), rel


def test_no_port_source_says_not_ported_yet():
    said = []
    for path in _sources():
        with open(path) as fh:
            said += [f"{os.path.relpath(path, ROOT)}:{n}"
                     for n, line in enumerate(fh, 1)
                     if "not ported yet" in line.lower()]
    assert said == []
