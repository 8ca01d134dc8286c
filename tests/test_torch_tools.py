"""The port's tools and utilities against the JAX package's, on the CPU.

- ``coding/arithmetic.py``: the same bytes from ``ArithmeticCoder`` and
  ``ContextArithmeticCoder`` on seeded CDFs and symbols (both packages
  compile the same rANS C++), equal ``measure_bpp``, the same
  ``validate_cdf`` refusals;
- ``tools/rd_plot.py``: ``bd_rate`` equal to 1e-12 on seeded curves and on
  ``results/rd_flagship.json``'s points against its anchors, the anchors
  file byte-equal, the plot and the CLI;
- ``utils/image_plots.py``, ``tools/figure_montage.py``,
  ``tools/make_patches.py``: the pyramid montage's array, the montage's
  and the patches' pixels equal;
- the small API: the mailer, the agent registry, ``rate_loss``,
  ``span`` in a ``DeviceTrace`` and the agent's ``imshow_validation``;
- ``tools/weight_import.py``: a seeded state dict under the original
  repo's names through the JAX package's importer, then
  ``state_dict_from_flax``, equals the port's import bit for bit, with the
  same unmatched keys; ``load_reference_checkpoint``; the flagship's
  mapping at 4 levels addresses every port parameter.
"""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig, registry as pregistry)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
    arithmetic as parith, rans as prans)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models import (
    postprocess as ppp)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    figure_montage as pfm, make_patches as pmp, rd_plot as prd, weight_import
    as pwi, weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    loop as ploop, loss as ploss)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.utils import (
    image_plots as pplots, mailer as pmailer, profiling as pprof)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.coding import (
    arithmetic as jarith, rans as jrans)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.tools import (
    figure_montage as jfm, make_patches as jmp, rd_plot as jrd, weight_import
    as jwi)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.train import (
    loss as jloss)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.utils import (
    image_plots as jplots)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BD_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def private_jax_builds(tmp_path_factory):
    """The JAX package builds its rANS next to its sources at first use,
    and another test worker may be writing that file at this moment: where
    this process has not loaded it yet, build it into a directory of its
    own (the JAX package's build, flags and all)."""
    mp = pytest.MonkeyPatch()
    if jrans._lib is None:
        mp.setattr(jrans, "_LIB",
                   str(tmp_path_factory.mktemp("jax_rans") / "librans.so"))
    yield
    mp.undo()


# --- the arithmetic coder ------------------------------------------------------

def seeded_cdfs(rng, n, lo=3, hi=40):
    return [prans.pmf_to_quantized_cdf(p / p.sum())
            for p in (rng.rand(rng.randint(lo, hi)) + 0.05 for _ in range(n))]


def test_arithmetic_coder_streams_are_the_same():
    rng = np.random.RandomState(0)
    cdfs = seeded_cdfs(rng, 5)
    symbols = [rng.randint(0, len(c) - 1, rng.randint(50, 400))
               for c in cdfs]
    got, want = parith.ArithmeticCoder(cdfs), jarith.ArithmeticCoder(cdfs)
    for a in ("cdfs", "lengths", "offsets"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    data = got.encode(symbols)
    assert data == want.encode(symbols)
    counts = [len(s) for s in symbols]
    for dec in (got.decode(data, counts), want.decode(data, counts)):
        for d, s in zip(dec, symbols):
            np.testing.assert_array_equal(d, s)
    assert got.measure_bpp(symbols, 1000) == want.measure_bpp(symbols, 1000)


def test_context_arithmetic_coder_streams_are_the_same():
    rng = np.random.RandomState(1)
    cdfs = seeded_cdfs(rng, 300, 2, 20)
    symbols = [rng.randint(0, len(c) - 1) for c in cdfs]
    data = parith.ContextArithmeticCoder().encode(symbols, cdfs)
    assert data == jarith.ContextArithmeticCoder().encode(symbols, cdfs)
    np.testing.assert_array_equal(
        parith.ContextArithmeticCoder().decode(data, cdfs), symbols)
    np.testing.assert_array_equal(
        jarith.ContextArithmeticCoder().decode(data, cdfs), symbols)


@pytest.mark.parametrize("cdf", [
    [0, 10, 5, 1 << 16],           # not increasing
    [0, 10, 20],                   # not normalized
    [3, 10, 1 << 16],              # not starting at 0
    [0, 10, 10, 1 << 16],          # an empty bin
])
def test_validate_cdf_refuses_alike(cdf):
    cdf = np.asarray(cdf)
    with pytest.raises(AssertionError) as got:
        parith.validate_cdf(cdf)
    with pytest.raises(AssertionError) as want:
        jarith.validate_cdf(cdf)
    assert str(got.value) == str(want.value)


# --- RD plots and BD-rate ------------------------------------------------------

def test_anchors_file_is_a_byte_copy():
    assert filecmp.cmp(prd._ANCHORS, jrd._ANCHORS, shallow=False)
    assert prd.load_anchors() == jrd.load_anchors()


def test_bd_rate_matches_on_seeded_curves():
    rng = np.random.RandomState(2)
    for n_ref, n_test in ((4, 4), (6, 3), (12, 5), (3, 2)):
        ref_psnr = np.sort(rng.uniform(24, 40, n_ref))
        ref_bpp = np.exp((ref_psnr - 30) / 6 + rng.normal(0, 0.05, n_ref))
        test_psnr = np.sort(rng.uniform(25, 39, n_test))
        test_bpp = np.exp((test_psnr - 31) / 6 + rng.normal(0, 0.05, n_test))
        got = prd.bd_rate(ref_bpp, ref_psnr, test_bpp, test_psnr)
        want = jrd.bd_rate(ref_bpp, ref_psnr, test_bpp, test_psnr)
        assert abs(got - want) <= BD_TOL * max(1.0, abs(want))
    assert np.isnan(prd.bd_rate([1, 2], [20, 21], [1, 2], [30, 31]))


def test_bd_rate_matches_on_the_flagship_points():
    with open(os.path.join(ROOT, "results", "rd_flagship.json")) as fh:
        rd = json.load(fh)
    pts = sorted((v["bpp"], v["psnr"]) for v in rd["points"].values())
    for anchor in ("jpeg_anchor", "jpeg2000_anchor"):
        ref = sorted(rd[anchor])
        args = ([p[0] for p in ref], [p[1] for p in ref],
                [p[0] for p in pts], [p[1] for p in pts])
        got, want = prd.bd_rate(*args), jrd.bd_rate(*args)
        assert abs(got - want) <= BD_TOL * abs(want)
    kodak = prd.load_anchors()
    for name in ("proposed_method", "jpeg"):
        args = (kodak["jpeg2000"]["bpp"], kodak["jpeg2000"]["psnr"],
                kodak[name]["bpp"], kodak[name]["psnr"])
        assert abs(prd.bd_rate(*args) - jrd.bd_rate(*args)) <= BD_TOL * 100


def test_rd_plot_cli(tmp_path, capsys):
    results = tmp_path / "mine.json"
    results.write_text(json.dumps({"mine": {"bpp": [0.2, 0.5, 1.0],
                                            "psnr": [28.0, 31.0, 35.0]}}))
    out = tmp_path / "rd.png"
    assert prd.main([str(results), str(out)]) == 0
    assert out.stat().st_size > 1000
    want = jrd.bd_rate(*(jrd.load_anchors()["jpeg2000"][k]
                         for k in ("bpp", "psnr")),
                       [0.2, 0.5, 1.0], [28.0, 31.0, 35.0])
    assert f"mine: BD-rate vs JPEG2000 = {want:+.2f}%" in capsys.readouterr().out


# --- images ---------------------------------------------------------------------

def test_wavelet_pyramid_is_the_same_array(tmp_path):
    rng = np.random.RandomState(3)
    xe = rng.randn(1, 4, 6, 1).astype(np.float32)
    xo = [rng.randn(1, 16, 24, 3).astype(np.float32),
          rng.randn(1, 8, 12, 3).astype(np.float32),
          rng.randn(1, 4, 6, 3).astype(np.float32)]
    want = jplots.wavelet_pyramid(xe, xo)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    got = pplots.wavelet_pyramid(nchw(xe), [nchw(a) for a in xo],
                                 out_path=str(tmp_path / "pyr.png"))
    assert got.dtype == want.dtype and got.shape == want.shape == (32, 48)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "pyr.png").stat().st_size > 0


def test_pyramid_saves_the_array_without_matplotlib(tmp_path, monkeypatch):
    def missing():
        raise ImportError("no matplotlib")
    monkeypatch.setattr(pplots, "_plt", missing)
    canvas = np.random.RandomState(4).rand(8, 8).astype(np.float32)
    path = pplots.save_pyramid(canvas, str(tmp_path / "pyr.png"))
    assert path == str(tmp_path / "pyr.npy")
    np.testing.assert_array_equal(np.load(path), canvas)


def read_png(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def test_montage_pixels_are_the_same(tmp_path):
    rng = np.random.RandomState(5)
    imgs = [rng.rand(32, 40, 3).astype(np.float32) * 1.2 - 0.1
            for _ in range(5)]
    labels = ["original", "30.1 dB @ 0.5 bpp", "b", "c", "d"]
    got = pfm.montage(imgs, labels, cols=3, out_path=str(tmp_path / "p.png"))
    want = jfm.montage(imgs, labels, cols=3, out_path=str(tmp_path / "j.png"))
    np.testing.assert_array_equal(read_png(got), read_png(want))


def test_make_patches_pixels_are_the_same(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(6)
    src = tmp_path / "src"
    src.mkdir()
    for name, shape in (("a.png", (80, 90, 3)), ("b.jpg", (40, 50, 3)),
                        ("c.txt", None)):
        if shape is None:
            (src / name).write_text("not an image")
        else:
            Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8)).save(
                src / name)
    n = pmp.save_patches_from_imgs(str(src), str(tmp_path / "p"), 3, 48, 1)
    assert n == jmp.save_patches_from_imgs(str(src), str(tmp_path / "j"), 3,
                                           48, 1) == 6
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    for name in names:
        np.testing.assert_array_equal(read_png(tmp_path / "p" / name),
                                      read_png(tmp_path / "j" / name))


TINY = dict(netType="CDF97", entropy_layer="factorized",
            autoencoder="SubbandAutoEncoder", clrch=3, dwtlevels=2,
            batch_size=2, patch_size=32, steps_per_epoch=1, max_epoch=1,
            val_patch_size=64, test_patch_size=64, lambda_=100.0)


def test_codec_rate_sweep_montage(tmp_path, monkeypatch):
    """Two experiments' ``model_best`` coding one image through the real
    bitstream, on the CPU: the original and both reconstructions."""
    from PIL import Image
    monkeypatch.chdir(tmp_path)
    paths = []
    for k, lam in enumerate((50.0, 800.0)):
        raw = dict(TINY, lambda_=lam, exp_name=f"m{k}", seed=k)
        path = tmp_path / f"m{k}.json"
        path.write_text(json.dumps(raw))
        agent = ploop.LiftingDWTAgent(pconfig.process_config(str(path)),
                                      device="cpu")
        agent.save_checkpoint(is_best=True)
        paths.append(str(path))
    img = (np.random.RandomState(7).rand(70, 64, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    out = pfm.codec_rate_sweep_montage(paths, str(tmp_path / "img.png"),
                                       str(tmp_path / "m.png"), device="cpu")
    canvas = read_png(out)
    assert canvas.shape == (64 + 24, 3 * 64, 3)
    np.testing.assert_array_equal(canvas[24:, :64], img[:64])


# --- the small API ----------------------------------------------------------

def test_mailer_never_raises():
    assert pmailer.Mailer().send("subject", "body") is False
    # configured, but nothing listens on that local port
    assert pmailer.Mailer(host="127.0.0.1", port=1, user="u",
                          to="t").send("subject", "body") is False


def test_register_agent_and_get_agent(monkeypatch):
    monkeypatch.setattr(pregistry, "_AGENTS", {})

    @pregistry.register_agent("MyAgent")
    class MyAgent:
        pass

    assert pregistry.get_agent("MyAgent") is MyAgent
    assert pregistry.get_agent("LiftingBasedDWTAgent") \
        is pregistry.get_agent("CompressionAgent") is ploop.LiftingDWTAgent
    with pytest.raises(KeyError, match="unknown agent"):
        pregistry.get_agent("NoSuchAgent")


def test_rate_loss_matches():
    x = np.random.RandomState(8).rand(2, 3, 8, 8).astype(np.float32) * 9
    got = ploss.rate_loss(torch.from_numpy(x)).item()
    want = float(jax.jit(jloss.rate_loss)(x))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_annotate_and_device_trace(tmp_path):
    """``span`` inside a ``DeviceTrace`` window is a range of its
    ``trace.json`` (with ``req`` in its name), and one of any profiler's;
    outside a profiler it is the shared null context."""
    trace = pprof.DeviceTrace(str(tmp_path), "cpu")
    trace.start()
    with pprof.span("my_region", req=3):
        torch.ones(4).sum()
    path = trace.stop()
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "my_region#3" for e in events)
    with torch.profiler.profile() as prof:
        with pprof.span("other_region"):
            torch.ones(4).sum()
    assert "other_region" in {e.key for e in prof.key_averages()}
    assert pprof.span("off") is pprof.span("off", req=1)


@pytest.fixture(scope="module")
def imshow_agent(tmp_path_factory):
    """A 2-level flagship agent with ``imshow_validation``, one validation
    image."""
    out = tmp_path_factory.mktemp("imshow")
    cfg = pconfig.flagship_config(
        dwtlevels=2, imshow_validation=True, val_patch_size=64,
        out_dir=str(out), log_dir=str(out / "logs"))
    agent = ploop.LiftingDWTAgent(cfg, device="cpu")
    first = next(iter(agent.data.valid_batches()))
    agent.data.valid_batches = lambda: iter([first])
    return agent, first, out


@pytest.mark.parametrize("matplotlib", [True, False])
def test_agent_imshow_validation(imshow_agent, monkeypatch, matplotlib):
    """The agent (per-plane: the Y plane's pyramid) validates with
    ``imshow_validation``: the montage of its own encode of the first
    validation image, as a figure, or as the array where matplotlib is
    missing."""
    agent, first, out = imshow_agent
    if not matplotlib:
        def missing():
            raise ImportError("no matplotlib")
        monkeypatch.setattr(pplots, "_plt", missing)
    agent.current_iteration = 7 if matplotlib else 8
    agent.validate()
    if matplotlib:
        assert (out / "wavelet_pyramid_it7.png").stat().st_size > 0
        return
    canvas = np.load(out / "wavelet_pyramid_it8.npy")
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
        color)
    x = torch.from_numpy(first).permute(0, 3, 1, 2)
    y = color.shift_ycbcr(color.rgb_to_ycbcr(x))[:, :1]
    with torch.no_grad():
        xe, xo = agent.model.codecs[0].transform.encode(y)
    assert canvas.shape == (64, 64)
    np.testing.assert_array_equal(canvas, pplots.wavelet_pyramid(xe, xo))


# --- weight import -----------------------------------------------------------

WI_CONFIGS = {
    "cdf97": dict(netType="CDF97", entropy_layer="factorized",
                  autoencoder="SubbandAutoEncoder", clrch=3, dwtlevels=2),
    "flagship": dict(netType="LiftingBasedNeuralWaveletv4",
                     entropy_layer="conditioned2ZTsepSubbands",
                     autoencoder="SubbandAutoEncoderBerk", clrch=1,
                     dwtlevels=2, depth_scale=2, filtersize=5),
    "ezwt": dict(netType="CDF97", entropy_layer="onlyEZWT",
                 autoencoder="SubbandAutoEncoder", clrch=1, dwtlevels=2),
}
# keys the importers skip (aliases, buffers) and one they must report
EXTRA_KEYS = ("model0.autoencoder.waveletForward.P.0.weight",
              "model.entropymodel.csc_xe.0.mask", "model.no_such.weight")


def original_shape(target, kind):
    """The original repo's shape of a tensor whose flax leaf is
    ``target`` (the inverse of the importers' layout rules)."""
    if kind == "conv":
        return (target.shape[3], target.shape[2],
                target.shape[0], target.shape[1])
    if kind == "convT":
        return (target.shape[2], target.shape[3],
                target.shape[0], target.shape[1])
    if isinstance(kind, tuple):          # grouped ConvTranspose2d
        kh, kw, i_per_g, o_total = target.shape
        return (i_per_g * kind[1], o_total // kind[1], kh, kw)
    return {"skip": (1, 1, 3, 1), "flat1": (1, 1, 1, 1),
            "prelu": (1,)}.get(kind, target.shape)


def seeded_original_state_dict(tree, mapping, seed):
    rng = np.random.RandomState(seed)
    sd = {}
    for torch_key, path, kind in mapping:
        node = tree
        for k in path.split("/"):
            node = node[k]
        sd[torch_key] = (rng.randn(*original_shape(node, kind))
                         * 0.02).astype(np.float32)
    for k in EXTRA_KEYS:
        sd[k] = np.ones(3, np.float32)
    return sd


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(WI_CONFIGS))
def test_import_state_dict_matches_the_jax_importer(name):
    raw = WI_CONFIGS[name]
    pcfg = pconfig.Config(**raw).validate()
    model = PCodec(pcfg, generator=torch.Generator().manual_seed(0))
    tree = weights.unflatten_params(
        weights.flax_params_from_state_dict(model.state_dict()))
    sd = seeded_original_state_dict(tree, pwi.build_mapping(pcfg), 1)
    assert pwi.build_mapping(pcfg) == jwi.build_mapping(jconfig.Config(**raw))
    got, unmatched = pwi.import_state_dict(model, sd)
    want_tree, want_unmatched = jwi.import_state_dict(jconfig.Config(**raw),
                                                      tree, sd)
    assert unmatched == want_unmatched == ["model.no_such.weight"]
    assert_state_dicts_equal(
        got, weights.state_dict_from_flax(weights.flatten_params(want_tree)))
    # every parameter came from the state dict, and the model runs on it
    before = model.state_dict()
    assert all(not torch.equal(got[k], before[k]) for k in got
               if before[k].numel() > 1)
    model.load_state_dict(got, strict=True)
    with torch.no_grad():
        out = model(torch.full((1, 3, 32, 32), 0.25))
    assert torch.isfinite(out[0]).all()


@pytest.mark.parametrize("kind", ["DnCNN", "DIDN"])
def test_import_postprocess_matches_the_jax_importer(kind):
    raw = dict(postprocess=kind, clrch=1, resnetlevel=2)
    pcfg = pconfig.Config(**raw).validate()
    net = ppp.make_postprocess(pcfg, torch.Generator().manual_seed(0))
    tree = weights.flax_variables_from_state_dict(net.state_dict())
    mapping = pwi.build_postprocess_mapping(pcfg)
    assert mapping == jwi.build_postprocess_mapping(jconfig.Config(**raw))
    sd = seeded_original_state_dict(tree, mapping, 2)
    sd["bn.0.num_batches_tracked"] = np.asarray(5)
    got, unmatched = pwi.import_postprocess_state_dict(pcfg, net, sd)
    want_tree, want_unmatched = jwi.import_postprocess_state_dict(
        jconfig.Config(**raw), tree, sd)
    assert unmatched == want_unmatched == ["model.no_such.weight"]
    assert_state_dicts_equal(
        got, weights.state_dict_from_flax_variables(want_tree))
    net.load_state_dict(got, strict=True)


def test_load_reference_checkpoint(tmp_path):
    rng = np.random.RandomState(9)
    sd = {"model0.autoencoder.P_blocks.0.conv1.weight":
          torch.from_numpy(rng.randn(16, 1, 5, 5).astype(np.float32)),
          "model0.autoencoder.nh": torch.ones(1, 1, 1, 1)}
    path = tmp_path / "ckpt.pth.tar"
    torch.save({"epoch": 3, "state_dict": sd}, path)
    got, want = (pwi.load_reference_checkpoint(str(path)),
                 jwi.load_reference_checkpoint(str(path)))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], sd[k].numpy())
        np.testing.assert_array_equal(got[k], want[k])
    torch.save(sd, path)                 # a bare state dict
    assert sorted(pwi.load_reference_checkpoint(str(path))) == sorted(sd)


def test_flagship_mapping_addresses_every_port_parameter():
    cfg = pconfig.flagship_config()
    model = PCodec(cfg)
    mapped = {weights.port_name("".join(f"['{s}']" for s in path.split("/")))
              for _, path, _ in pwi.build_mapping(cfg)}
    assert mapped == set(model.state_dict())
