"""The port's RD sweep driver (``tools/rd_sweep.py``) against the JAX
package's ``scripts/rd_sweep.py``, on the CPU.

- ``make_cfg`` gives each preset's config of the JAX script, field for
  field, but for the experiment directory (``port_<preset>``);
- a snapshot written by ``save_params_snapshot`` from the committed
  ``flagship_lam2000.npz`` loaded into the port equals that file key for
  key and bit for bit (flax keystrs, f16 leaves, ``__iteration__``);
- the JPEG anchor of the same images equals the JAX script's, and without
  PIL the anchors come from the committed ``rd_flagship.json`` where its
  eval set is this one;
- one ``main`` on the CPU (``--preset cdf97``, 3 lambdas of 2 steps, 2
  held-out images) writes the JAX script's fields and snapshots that a
  ``--retest-only`` run reads back.

The training corpus and the held-out set are cut for the last test (the
JSON's fields, not the RD values, are what it checks).
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    rd_heldout, rd_sweep, weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.utils import (
    compile_cache)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRS = ("checkpoint_dir", "log_dir", "summary_dir")


@pytest.fixture(scope="module")
def jax_sweep():
    """``scripts/rd_sweep.py`` loaded by path, with its import-time switch
    to a persistent compile cache left out."""
    mp = pytest.MonkeyPatch()
    mp.setattr(compile_cache, "enable_compile_cache", lambda *a, **k: None)
    mp.syspath_prepend(ROOT)
    spec = importlib.util.spec_from_file_location(
        "jax_rd_sweep", os.path.join(ROOT, "scripts", "rd_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    mp.undo()


@pytest.mark.parametrize("preset", rd_sweep.PRESETS)
@pytest.mark.parametrize("steps", [10, 4000])
def test_make_cfg_is_the_jax_scripts(jax_sweep, tmp_path, preset, steps):
    got = rd_sweep.make_cfg(preset, 2000.0, steps, "tr", "ev", str(tmp_path))
    want = jax_sweep.make_cfg(preset, 2000.0, steps, "tr", "ev",
                              str(tmp_path))
    got_d, want_d = vars(got), vars(want)
    assert sorted(got_d) == sorted(want_d)
    assert {k: v for k, v in got_d.items() if k not in DIRS} \
        == {k: v for k, v in want_d.items() if k not in DIRS}
    for d in DIRS:
        assert getattr(got, d) == getattr(want, d).replace(
            os.path.join("rd_sweep", preset),
            os.path.join("rd_sweep", f"port_{preset}"))
        assert os.path.isdir(getattr(got, d))
    assert got.max_epoch == max(1, steps // 500) and got.dtype == "bfloat16"


def test_snapshot_round_trip_is_bit_exact(tmp_path):
    """The committed snapshot through the port (f16 -> fp32 parameters) and
    back out is the committed file, key order, dtypes and bits."""
    committed = rd_sweep.snapshot_path("flagship", 2000.0, "", port=False)
    cfg = rd_sweep.make_cfg("flagship", 2000.0, 10, "", "", str(tmp_path))
    agent = SimpleNamespace(model=CodecWrapper(cfg), current_iteration=0)
    assert rd_sweep.load_params_snapshot("flagship", 2000.0, agent,
                                         str(tmp_path)) == 76000
    out = rd_sweep.save_params_snapshot("flagship", 2000.0, agent,
                                        str(tmp_path))
    assert out == str(tmp_path / "results" / "ckpt_snapshots"
                      / "port_flagship_lam2000.npz")
    assert not os.path.exists(out + ".tmp.npz")
    with np.load(out) as got, np.load(committed) as want:
        assert got.files == want.files
        for k in want.files:
            a, b = got[k], want[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    # the port's snapshot now comes first
    agent.model.load_state_dict({k: torch.zeros_like(v) for k, v in
                                 agent.model.state_dict().items()})
    agent.current_iteration = 0
    assert rd_sweep.load_params_snapshot("flagship", 2000.0, agent,
                                         str(tmp_path)) == 76000
    flat = weights.flax_params_from_state_dict(agent.model.state_dict())
    with np.load(committed) as want:
        for k, v in flat.items():
            np.testing.assert_array_equal(v, want[k].astype(np.float32))
    assert rd_sweep.load_params_snapshot("flagship", 123.0, agent,
                                         str(tmp_path)) == 0


def test_jpeg_anchor_is_the_jax_scripts(jax_sweep, tmp_path):
    from PIL import Image
    images = dict(list(rd_heldout.heldout_images().items())[:2])
    for name, img in images.items():
        Image.fromarray(img).save(tmp_path / f"{name}.png")
    got = rd_sweep.jpeg_anchor(list(images.values()))
    assert got == jax_sweep.jpeg_anchor(str(tmp_path))
    assert rd_sweep.eval_set(images) == sorted(os.listdir(tmp_path))


def test_anchors_without_pil(monkeypatch):
    images = rd_heldout.heldout_images()
    monkeypatch.setitem(sys.modules, "PIL", None)     # import PIL fails
    with open(os.path.join(ROOT, "results", "rd_flagship.json")) as fh:
        committed = json.load(fh)
    assert committed["eval_set"] == rd_sweep.eval_set(images)
    got, source = rd_sweep.anchors("flagship", images)
    assert got == {k: committed[k] for k in ("jpeg_anchor",
                                             "jpeg2000_anchor")}
    assert source.startswith("results/rd_flagship.json")
    got, source = rd_sweep.anchors("cdf97", images)   # another eval set
    assert got == {} and "eval_set is not this one" in source


def test_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    images = dict(list(rd_heldout.heldout_images().items())[1:3])
    monkeypatch.setattr(rd_heldout, "heldout_images", lambda: images)
    monkeypatch.setattr(rd_sweep, "CORPUS", (6, 64, 0))
    make_cfg = rd_sweep.make_cfg

    def two_steps(*a, **k):
        cfg = make_cfg(*a, **k)
        cfg.steps_per_epoch = 2
        return cfg
    monkeypatch.setattr(rd_sweep, "make_cfg", two_steps)
    argv = ["--preset", "cdf97", "--lambdas", "50,400,2000", "--steps", "2",
            "--root", str(tmp_path), "--device", "cpu"]
    assert rd_sweep.main(argv) == 0
    out = tmp_path / "results" / "port_rd_cdf97.json"
    with open(out) as fh:
        res = json.load(fh)
    with open(os.path.join(ROOT, "results", "rd_cdf97.json")) as fh:
        jax_fields = set(json.load(fh))
    assert jax_fields <= set(res)
    assert res["eval_set"] == ["natural_9999_0000.png",
                               "natural_9999_0001.png"]
    assert res["steps"] == 2 and len(res["jpeg_anchor"]) == 12
    assert sorted(res["points"]) == ["2000", "400", "50"]
    for lam, p in res["points"].items():
        assert set(p) == {"bpp", "psnr", "iterations", "per_image",
                          "train_minutes"}
        assert p["iterations"] == 2 and len(p["per_image"]) == 2
        assert np.isfinite(p["bpp"]) and np.isfinite(p["psnr"])
        snap = tmp_path / "results" / "ckpt_snapshots" \
            / f"port_cdf97_lam{lam}.npz"
        with np.load(snap) as s:
            assert int(s["__iteration__"]) == 2
    # two steps from init land far under JPEG's PSNR range: no overlap, NaN
    for _, field in rd_sweep.BD_FIELDS:
        assert field in res
    # the points again from the checkpoints (the trained fp32 weights) ...
    capsys.readouterr()
    assert rd_sweep.main(argv + ["--retest-only"]) == 0
    assert "restored from params snapshot" not in capsys.readouterr().out
    with open(out) as fh:
        again = json.load(fh)
    for lam, p in res["points"].items():
        assert again["points"][lam]["per_image"] == p["per_image"]
    # ... and from the port's f16 snapshots once the checkpoints are gone
    for ckpt in (tmp_path / "experiments" / "rd_sweep" / "port_cdf97").glob(
            "lam_*/checkpoints/*.pt"):
        ckpt.unlink()
    assert rd_sweep.main(argv + ["--retest-only"]) == 0
    assert capsys.readouterr().out.count("restored from params snapshot") == 3
    with open(out) as fh:
        again = json.load(fh)
    for lam, p in res["points"].items():
        assert again["points"][lam]["iterations"] == 2
        assert abs(again["points"][lam]["bpp"] / p["bpp"] - 1) < 1e-2
