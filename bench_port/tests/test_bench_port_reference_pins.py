"""The seeded reference's numbers, pinned: for each benchmarked
configuration at two wavelet levels and on two seeds, the state dict the
seeder makes (keys in order, shapes, each tensor's sum) and the RD terms,
mean ``xhat`` and auxiliary loss of one seeded batch of two 32x48 images,
in eval and with the training noise.

The seeder draws its kernels and CDF biases in ``named_parameters()``
order, and the training noise is drawn in the model's order, so any change
to how the reference builds its parts, or to the order of its arithmetic,
moves these numbers. The expected values in ``reference_pins.json`` were
recorded with the single-file reference, before its parts were split into
``reference/<family>/<name>.py`` (commit 57ba79c), by running this file::

    python bench_port/tests/test_bench_port_reference_pins.py --record

Sums are exact (``math.fsum``), whatever the order. The forward numbers
are compared exactly where they were recorded (:data:`RECORDED_ON`: the
torch version, the CPU's instruction set and two threads, as
``conftest.py`` sets): a CPU conv sums in blocks that follow all three.
Elsewhere they hold to rounding: the RD terms and the auxiliary loss to a
relative 1e-6, the mean ``xhat`` (near 0) to 1e-7; one thread instead of
two moves them by at most 2.4e-7 and 3.0e-8.
"""

import json
import math
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PINS = os.path.join(HERE, "reference_pins.json")
# each configuration with the eval cell whose weights and lambda it takes
CASES = {"flagship_fp32": "flagship_fp32.eval",
         "cdf97_fp32": "cdf97_fp32.eval"}
SEEDS = (2 ** 31 + 17, 5)
LEVELS = 2
RECORDED_ON = ("2.13.0+cpu", "AVX512", 2)


def exact_sum(t: torch.Tensor) -> float:
    """The sum correctly rounded to float64, whatever the order."""
    return math.fsum(t.detach().double().flatten().tolist())


def readings(config: str, seed: int) -> dict:
    from bench_port.harness import common
    from bench_port.harness.weights import seeded_reference
    from bench_port.reference.model import rd_terms

    cell = common.workload(CASES[config])
    cfg = dict(common.model_config(config), dwtlevels=LEVELS)
    ref = seeded_reference(cfg, seed, "cpu", cell.get("weights"))
    state = ref.state_dict()
    out = {"keys": [[k, list(v.shape)] for k, v in state.items()],
           "sums": [exact_sum(v) for v in state.values()]}
    x = torch.rand((2, 3, 32, 48), generator=torch.Generator().manual_seed(
        seed))
    with torch.no_grad():
        for mode, training in (("eval", False), ("train", True)):
            gen = torch.Generator().manual_seed(seed + 1)
            xs, xhat, bits_xe, info = ref(x, training, gen)
            terms = rd_terms(xs, xhat, bits_xe, info, cell["lambda"])
            out[mode] = {"terms": [float(t) for t in terms],
                         "xhat_mean": exact_sum(xhat) / xhat.numel()}
        out["aux_loss"] = float(ref.aux_loss())
    return out


def record(path: str = PINS) -> None:
    torch.set_num_threads(2)
    pins = {f"{config}/{seed}": readings(config, seed)
            for config in CASES for seed in SEEDS}
    with open(path, "w") as fh:
        json.dump(pins, fh, indent=0)
        fh.write("\n")


@pytest.fixture(scope="module")
def pins():
    with open(PINS) as fh:
        return json.load(fh)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", sorted(CASES))
def test_seeded_reference_equals_its_pins(pins, config, seed):
    want, got = pins[f"{config}/{seed}"], readings(config, seed)
    assert [k for k, _ in got["keys"]] == [k for k, _ in want["keys"]]
    assert got["keys"] == want["keys"]          # shapes
    bad = [(k, g, w) for (k, _), g, w in zip(got["keys"], got["sums"],
                                              want["sums"]) if g != w]
    assert not bad, bad[:5]
    here = (torch.__version__, torch.backends.cpu.get_cpu_capability(),
            torch.get_num_threads())
    if here == RECORDED_ON:
        for mode in ("eval", "train"):
            assert got[mode] == want[mode], mode
        assert got["aux_loss"] == want["aux_loss"]
        return
    for mode in ("eval", "train"):
        assert got[mode]["terms"] == pytest.approx(want[mode]["terms"],
                                                   rel=1e-6), mode
        assert got[mode]["xhat_mean"] == pytest.approx(
            want[mode]["xhat_mean"], rel=0, abs=1e-7), mode
    assert got["aux_loss"] == pytest.approx(want["aux_loss"], rel=1e-6)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    if sys.argv[1:] == ["--record"]:
        record()
    else:
        print(__doc__)
