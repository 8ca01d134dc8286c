"""The work counter against the records: the dense 3x3 convs of the fp32
flagship eval step at B=8 512x768 sum to the 113.7 ms bound, each conv's
larger of FLOP time and byte time (``chip_smoke.py::conv_bound``), and the
step's FLOPs follow from its layers."""

import pytest

from bench_port import work
from bench_port.harness import common


def flagship():
    return common.model_config("flagship_fp32")


def test_dense_3x3_bound_of_the_flagship_eval_step():
    assert work.least_ms_by_kind(flagship(), 8, 512, 768)["conv3x3"] \
        == pytest.approx(113.7, abs=0.05)


def test_conv_bound_is_the_larger_of_flops_and_bytes():
    # one 3->96 conv over 8 x 256 x 384 pixels: bound by bytes
    layer = work.Layer("conv3x3", 8 * 256 * 384, 3, 96, 3, 1)
    t_ops = 2 * 9 * 3 * 96 * layer.pixels / 67e12 * 1e3
    t_bytes = ((layer.pixels * 3 + 9 * 3 * 96) * 4 + layer.pixels * 96 * 4) \
        / 3.35e12 * 1e3
    assert work.least_ms([layer]) == pytest.approx(max(t_ops, t_bytes))
    assert t_bytes > t_ops


def test_flagship_layers_and_flops():
    layers = work.step_layers(flagship(), 8, 512, 768)
    dense = [x for x in layers if x.kind == "conv3x3"]
    # 4 Berk convs x 2 stacks x (4 levels + LL) + 2 plc convs x 3 levels,
    # for each of the 3 planes
    assert len(dense) == 3 * (8 * 5 + 2 * 3)
    assert work.step_flops(flagship(), 8, 512, 768) \
        == pytest.approx(11.7128e12, rel=1e-4)
    # train: forward, dk and dx of every conv
    assert work.step_flops(flagship(), 8, 256, 256, train=True) \
        == pytest.approx(3 * work.step_flops(flagship(), 8, 256, 256))


def test_cdf97_first_encoder_layers_take_no_dx():
    cfg = common.model_config("cdf97_fp32")
    layers = work.step_layers(cfg, 4, 256, 256)
    no_dx = [x for x in layers if not x.needs_dx]
    assert len(no_dx) == cfg["dwtlevels"] + 1
    assert all(x.kind == "conv1x1g" and x.cin == x.groups for x in no_dx)
    fwd = work.step_flops(cfg, 4, 256, 256)
    train = work.step_flops(cfg, 4, 256, 256, train=True)
    assert 2 * fwd < train < 3 * fwd


@pytest.mark.parametrize("key", ["netType", "autoencoder", "entropy_layer"])
def test_a_part_without_a_counter_file_is_no_count(key):
    cfg = dict(flagship(), **{key: "NoSuchPart"})
    with pytest.raises(work.NoCount):
        work.step_layers(cfg, 1, 64, 64)


def test_parts_are_found_by_the_configuration_names(monkeypatch, tmp_path):
    """A configuration with a new part brings a file under ``work/`` and
    edits none: here a transform counted by a file in another folder."""
    import shutil
    for family in ("transform", "autoencoder", "entropy"):
        shutil.copytree(f"{work.HERE}/{family}", tmp_path / family)
    (tmp_path / "transform" / "Fixed.py").write_text(
        "def layers(cfg, c, b, h, w):\n"
        "    return [], [(c, b * h * w, False)]\n")
    monkeypatch.setattr(work, "HERE", str(tmp_path))
    cfg = dict(common.model_config("cdf97_fp32"), netType="Fixed")
    layers = work.step_layers(cfg, 2, 16, 16)
    assert sum(x.kind == "conv1x1g" for x in layers) == 8
    assert work.step_flops(cfg, 2, 16, 16) > 0


def test_peak_follows_the_configuration_dtype():
    assert work.peak_flops(flagship()) == 67e12
    assert work.peak_flops(common.model_config("cdf97_fp32")) == 67e12
    bf16 = dict(flagship(), dtype="bfloat16")
    assert work.peak_flops(bf16) == 989e12
    assert work.least_ms_by_kind(bf16, 8, 512, 768)["conv3x3"] \
        < work.least_ms_by_kind(flagship(), 8, 512, 768)["conv3x3"] / 2


@pytest.mark.parametrize("config", ["flagship_fp32", "cdf97_fp32"])
def test_least_time_by_kind_covers_every_layer(config):
    cfg = common.model_config(config)
    by_kind = work.least_ms_by_kind(cfg, 8, 512, 768)
    assert sum(by_kind.values()) == pytest.approx(
        work.least_ms(work.step_layers(cfg, 8, 512, 768)))
    assert "conv1x1g" in by_kind
    assert ("conv3x3" in by_kind) == (config == "flagship_fp32")
