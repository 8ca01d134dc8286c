"""The real bitstream of the port's tree-based entropy models (onlyEZWT,
ZTBlock) against the JAX package's, on the CPU: a CDF 9/7 codec with
per-plane YCbCr models (``clrch=1``), fp32, seeded numpy weights carried
into both packages by ``tools/weights.py``; onlyEZWT at 3 levels, ZTBlock
at 2, 64x64.

- From the same subbands both packages write the same bytes (LL and the
  coarsest details through the bottlenecks' tables, every finer level or
  coset through the Gaussian tables), and each decodes the other's streams
  to its own encoder's writeback bit for bit. A finer level's writeback is
  ``symbol + mu`` with each package's own mu, a conv output whose last
  ulps differ: across the packages the writebacks agree within 1e-5 (the
  same symbols). The bottleneck tables come from
  each package's own fp32 ``pmf_table``; where they differ in a quantized
  entry (XLA's and PyTorch's transcendentals), both coders are handed the
  JAX package's, as ``tests/test_torch_rans.py`` does for the factorized
  streams.
- A whole image through each package's transforms: the port's round trip
  is lossless (it raises otherwise), and the rates and PSNRs agree within
  ``tests/test_torch_bitstream.py``'s 1 % and 0.01 dB; the learned
  upsampler too.
- ``compress_decompress_many`` with two workers writes exactly the bytes
  of sequential coding, in input order, and ``decompress_plane`` gives the
  round trip's plane; eight threads on a cold coder build each cached
  table once.
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch import (
    config as pconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
    codec_coder as pcc)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.models.codec import (
    CodecWrapper as PCodec)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.ops import (
    color as pcolor)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train import (
    data as pdata)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu import (
    config as jconfig)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.coding import (
    codec_coder as jcc, rans as jrans)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.models.codec import (
    CodecWrapper as JCodec)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

SIZE = 64
BPP_RTOL = 1e-2      # whole image, each package's own transforms
PSNR_TOL = 0.01      # dB
MU_ATOL = 1e-5       # a finer level's writeback across the packages
# (entropy_layer, zt_upsample, dwtlevels)
CASES = {"ezwt": ("onlyEZWT", "nearest", 3),
         "ezwt_learned": ("onlyEZWT", "learned", 3),
         "ztblock": ("DWTConditioned2EntropyLayerZTBlock", "nearest", 2)}


@pytest.fixture(scope="module", autouse=True)
def private_jax_builds(tmp_path_factory):
    """The JAX package builds its rANS library next to its sources at
    first use, and another test worker may be writing it at this moment:
    where this process has not loaded it yet, build it into a directory of
    its own."""
    mp = pytest.MonkeyPatch()
    if jrans._lib is None:
        mp.setattr(jrans, "_LIB", str(tmp_path_factory.mktemp(
            "jax_rans_build") / "librans.so"))
    yield
    mp.undo()


def draw(shapes, seed):
    """Flat flax params from numpy: conv kernels with std 1/sqrt(fan_in),
    bottleneck quantiles around [-8, 0, 8], every other leaf small."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in weights.flatten_params(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), shapes)).items():
        leaf = k.rsplit("['", 1)[1][:-2]
        n = rng.randn(*v.shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(v.shape[:-1]))
        elif leaf == "quantiles":
            v = np.array([-8.0, 0.0, 8.0]) + 0.1 * n
        else:
            v = 0.05 * n
        out[k] = v.astype(np.float32)
    return out


class Coders:
    """A JAX CodecCoder and a port CodecCoder on the CPU, same weights."""

    def __init__(self, case, seed=7):
        el, up, levels = CASES[case]
        kw = dict(netType="CDF97", autoencoder="SubbandAutoEncoder", clrch=1,
                  dwtlevels=levels, entropy_layer=el, zt_upsample=up,
                  lambda_=2000.0)
        self.jcfg = jconfig.Config(**kw)
        self.pcfg = pconfig.Config(**kw).validate()
        shapes = jax.eval_shape(lambda: JCodec(self.jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
            False))["params"]
        flat = draw(shapes, seed)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                        weights.unflatten_params(flat))
        self.model = PCodec(self.pcfg)
        weights.load_flax_params(self.model, flat)
        self.j = jcc.CodecCoder(self.jcfg, JCodec(self.jcfg), params)
        self.p = pcc.CodecCoder(self.pcfg, self.model, device="cpu")

    def share_bottleneck_tables(self, plane):
        """Hand both coders the JAX package's bottleneck tables where the
        two packages' quantized CDFs differ; returns whether they did."""
        differ = False
        for attr in ("eb_xe", "eb_xo"):
            jt = self.j._eb_table(plane, attr)
            pt = self.p._eb_table(plane, attr)
            if not all(np.array_equal(a, b) for a, b in zip(jt, pt)):
                differ = True
                self.p._eb_tables[(plane, attr, None)] = tuple(
                    np.asarray(t) for t in jt)
        return differ


@pytest.fixture(scope="module", params=list(CASES))
def coders(request):
    return Coders(request.param)


def subbands(levels, seed):
    """One plane's pyramid, NHWC, spread over a few quantization bins."""
    rng = np.random.RandomState(seed)
    s = SIZE >> levels
    xe = (rng.randn(1, s, s, 1) * 4).astype(np.float32)
    xo = [(rng.randn(1, SIZE >> (i + 1), SIZE >> (i + 1), 3)
           * (2.0 + i)).astype(np.float32) for i in range(levels)]
    return xe, xo


def image(seed):
    img = pdata.synthetic_natural_images(1, SIZE, seed=seed)[0]
    return img[None].astype(np.float32) / 255.0


def test_same_subbands_give_the_same_bytes_and_cross_decode(coders):
    L = coders.pcfg.dwtlevels
    xe, xo = subbands(L, 0)
    shapes = (xe.shape, [t.shape for t in xo])
    for plane in (0, 2):
        coders.share_bottleneck_tables(plane)
        js, jxo, jxe, _ = coders.j._compress_entropy(plane, xe, xo)
        ps, pxo, pxe, _ = coders.p._compress_entropy(plane, xe, xo)
        assert ps.xe == js.xe                       # LL: eb_xe
        assert ps.xo[L - 1] == js.xo[L - 1]         # coarsest: eb_xo
        assert ps.xo[:L - 1] == js.xo[:L - 1]       # finer: Gaussian
        assert min(len(ps.xe), *map(len, ps.xo)) > 0
        # LL and the coarsest details: a bottleneck's median, the same bits;
        # a finer level's writeback is its symbol plus each package's own
        # mu, whose last ulps differ (a different symbol would be 1 off)
        np.testing.assert_array_equal(pxe, np.asarray(jxe))
        np.testing.assert_array_equal(pxo[L - 1], np.asarray(jxo[L - 1]))
        for a, b in zip(pxo[:L - 1], jxo[:L - 1]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=MU_ATOL)
        # each package decodes the other's streams to its own writeback
        for dec, streams, (want_xe, want_xo) in (
                (coders.p._decompress_entropy, js, (pxe, pxo)),
                (coders.j._decompress_entropy, ps, (jxe, jxo))):
            got_xe, got_xo = dec(plane, streams, *shapes)
            np.testing.assert_array_equal(np.asarray(got_xe),
                                          np.asarray(want_xe))
            for a, b in zip(got_xo, want_xo):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_whole_image_round_trip_matches_the_jax_package(coders):
    batch = image(11)
    want = coders.j.compress_decompress(batch)
    got = coders.p.compress_decompress(batch)
    assert got.xhat.shape == batch.shape and got.xhat.dtype == np.float32
    assert 0.0 <= got.xhat.min() and got.xhat.max() <= 1.0
    assert abs(got.bpp - want.bpp) <= BPP_RTOL * want.bpp
    assert abs(got.psnr - want.psnr) <= PSNR_TOL
    assert got.timing == coders.p.last_timing and set(got.timing) == {
        "analysis_ms", "synthesis_ms", "encode_host_ms", "decode_host_ms",
        "host_wall_ms"}
    if coders.pcfg.entropy_layer != "onlyEZWT":
        # each finer level holds its 4 coset streams
        assert [len(c) for c in pcc._unpack_chunks(got.streams[0].xo[0])] \
            == [4]


def test_many_images_code_as_sequential_coding_does():
    """Image-parallel coding: the first image alone, the rest on two
    workers; the bytes of one coder coding the images one by one, in input
    order. ``decompress_plane`` gives the round trip's plane."""
    c = Coders("ztblock", seed=3)
    images = [image(s) for s in (21, 22, 23, 24)]
    seq = [c.p.compress_decompress(im) for im in images]
    fresh = pcc.CodecCoder(c.pcfg, c.model, device="cpu")
    par = fresh.compress_decompress_many(images, workers=2)
    assert len(par) == len(images)
    for a, b in zip(par, seq):
        assert [(s.xe, s.xo) for s in a.streams] \
            == [(s.xe, s.xo) for s in b.streams]
        np.testing.assert_array_equal(a.xhat, b.xhat)
        assert a.bpp == b.bpp and a.psnr == b.psnr
    assert "analysis_ms" in par[0].timing
    assert all("analysis_ms" not in r.timing and r.timing["host_wall_ms"] > 0
               for r in par[1:])
    assert [r.bpp for r in fresh.compress_decompress_many(images[:2], 1)] \
        == [r.bpp for r in seq[:2]]
    assert fresh.compress_decompress_many([]) == []

    y = pcolor.shift_ycbcr(pcolor.rgb_to_ycbcr(
        torch.from_numpy(images[0]).permute(0, 3, 1, 2)))
    streams, _, xe_hat, xo_hats = fresh.compress_plane(1, y[:, 1:2])
    plane = fresh.decompress_plane(1, streams, xe_hat.shape,
                                   [t.shape for t in xo_hats])
    np.testing.assert_array_equal(plane,
                                  fresh.synthesis(1, xe_hat, xo_hats))
    assert plane.shape == (1, SIZE, SIZE, 1)


def test_cold_coder_builds_each_table_once_under_threads(monkeypatch):
    """Eight threads on a cold coder, switching every microsecond: each
    plane's bottleneck tables are built once (a check-then-act without the
    coder's lock builds some twice), and every image codes as it does
    alone."""
    c = Coders("ezwt", seed=5)
    images = [image(31 + (k % 2)) for k in range(8)]
    alone = [c.p.compress_decompress(im).streams for im in images[:2]]
    cold = pcc.CodecCoder(c.pcfg, c.model, device="cpu")
    built = []
    real = pcc.rans.build_cdf_matrix
    monkeypatch.setattr(pcc.rans, "build_cdf_matrix",
                        lambda *a: (built.append(1), real(*a))[1])
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = [pool.submit(cold._round_trip, im, False)
                       for im in images]
            results = [f.result(timeout=300) for f in futures]
    finally:
        sys.setswitchinterval(switch)
    assert len(built) == 2 * 3                 # eb_xe and eb_xo, 3 planes
    for k, r in enumerate(results):
        assert [(s.xe, s.xo) for s in r.streams] \
            == [(s.xe, s.xo) for s in alone[k % 2]]


def test_to_host_carries_dtypes_and_layout():
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(1, 3, 4, 5).astype(np.float32))
    b = torch.from_numpy(rng.randint(-9, 9, (1, 2, 3, 4)).astype(np.int32))
    got = pcc._to_host([a, b, a[:, :1]])
    np.testing.assert_array_equal(got[0], a.permute(0, 2, 3, 1).numpy())
    np.testing.assert_array_equal(got[1], b.permute(0, 2, 3, 1).numpy())
    np.testing.assert_array_equal(got[2], a[:, :1].permute(0, 2, 3, 1).numpy())
    assert [g.dtype for g in got] == [np.float32, np.int32, np.float32]
    cos = [rng.randn(1, 3, 3, 2).astype(np.float32) for _ in range(4)]
    full = pcc._interleave_cosets_nhwc(cos)
    for k, (r, s) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        np.testing.assert_array_equal(full[:, r::2, s::2], cos[k])
