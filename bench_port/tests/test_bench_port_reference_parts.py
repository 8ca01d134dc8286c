"""The reference's parts are files found by the configuration's names: a
configuration naming a part with no file fails at set-up with the path of
the file to add, and a part file placed under another root is built and
run with no edit elsewhere."""

import os
import shutil

import pytest
import torch

from bench_port.harness import common
from bench_port.harness.weights import seeded_reference
from bench_port.reference import model

FAMILIES = {"transform": "netType", "autoencoder": "autoencoder",
            "entropy": "entropy_layer"}

TOY = '''"""A toy entropy model: zero-mean Gaussians, one learned scale a
channel, for the LL band and each level's details."""

import torch
from torch import nn

from ..model import gaussian_bits, quantize


class Toy(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg["clrch"]
        self.sigma_xe = nn.Parameter(torch.ones(c))
        self.sigma_xo = nn.Parameter(torch.ones(cfg["dwtlevels"], 3 * c))

    def forward(self, xe, xo, training, generator):
        info, q_xo = [], []
        for x, s in zip(xo, self.sigma_xo):
            q_xo.append(quantize(x, training, generator))
            info.append(gaussian_bits(x, s.view(1, -1, 1, 1).expand_as(x),
                                      torch.zeros_like(x), training,
                                      generator))
        q_xe = quantize(xe, training, generator)
        sigma = self.sigma_xe.view(1, -1, 1, 1).expand_as(xe)
        bits_xe = gaussian_bits(xe, sigma, torch.zeros_like(xe), training,
                                generator)
        return bits_xe, info, q_xe, q_xo

    def aux_loss(self):
        return self.sigma_xe.new_zeros(())


def build(cfg):
    return Toy(cfg)
'''


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_missing_part_fails_at_setup_with_its_file(family):
    """The seeder, which builds the reference at every cell's set-up,
    stops with the path of the missing file."""
    missing = os.path.join(model.HERE, family, "no_such_part.py")
    assert not os.path.exists(missing)
    cfg = dict(common.model_config("cdf97_fp32"), dwtlevels=2)
    cfg[FAMILIES[family]] = "no_such_part"
    with pytest.raises(LookupError) as err:
        seeded_reference(cfg, 7, "cpu")
    assert isinstance(err.value, model.NoPart)
    assert missing in str(err.value)


def test_a_new_part_file_is_built_and_run(tmp_path, monkeypatch):
    """A new entropy part under another root, beside copies of the CDF 9/7
    parts, builds a codec whose parameters carry its names, and runs it in
    eval and with the training noise."""
    cfg = dict(common.model_config("cdf97_fp32"), dwtlevels=2,
               entropy_layer="toy")
    for family in ("transform", "autoencoder"):
        name = cfg[FAMILIES[family]]
        os.makedirs(tmp_path / family)
        shutil.copy(os.path.join(model.HERE, family, f"{name}.py"),
                    tmp_path / family)
    os.makedirs(tmp_path / "entropy")
    (tmp_path / "entropy" / "toy.py").write_text(TOY)

    monkeypatch.setattr(model, "ROOT", str(tmp_path))
    ref = model.Reference(cfg)
    names = [n for n, _ in ref.named_parameters()]
    assert names[-2:] == ["codec.entropymodel.sigma_xe",
                          "codec.entropymodel.sigma_xo"]
    assert any(n.startswith("codec.transform.yh_ae_1.down_3") for n in names)
    x = torch.rand((2, 3, 32, 48), generator=torch.Generator().manual_seed(3))
    for training in (False, True):
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            xs, xhat, bits_xe, info = ref(x, training, gen)
        assert xhat.shape == xs.shape and len(info) == 2
        terms = model.rd_terms(xs, xhat, bits_xe, info, 835.0)
        assert all(bool(torch.isfinite(t)) for t in terms)
        assert float(terms[2]) > 0 and float(terms[3]) > 0
    with pytest.raises(model.NoPart):
        model.part("entropy", "toy", model.HERE)   # not in the reference


def test_each_part_file_runs_once_a_process():
    """The loader keeps each part module: a clrch-1 configuration's three
    codecs share one module, and so one set of classes, for each part."""
    cfg = dict(common.model_config("flagship_fp32"), dwtlevels=1)
    assert cfg["clrch"] == 1
    ref = model.Reference(cfg)
    for family, key in FAMILIES.items():
        assert model.part(family, cfg[key]) is model.part(family, cfg[key])
    kinds = {type(c.entropymodel) for c in ref.codecs}
    assert len(kinds) == 1
