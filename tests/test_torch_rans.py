"""The port's rANS coder, Gaussian coding tables and factorized bottleneck
tables against the JAX package's, on the CPU.

Both packages compile the same C++ (the port's copies of
``coding/csrc/rans.cpp`` and ``rans_core.h``, with the same flags), so from
the same tables and symbols the bytes must be identical, and either decoder
must read the other's streams. The Gaussian tables are computed in float64
with the same numpy/scipy calls: equal arrays. The bottleneck's pmf rows go
through its float32 MLP, whose exp/log1p/tanh differ between XLA's and
PyTorch's CPU kernels by an ulp: pmf rows within 2.5e-7 (two float32 ulps
at 1), and the factorized streams byte-identical from the same tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.coding import (
    codec_coder as pcc, rans as prans)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.entropy import (
    bottleneck as pbn, gaussian as pg)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools import (
    weights)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.coding import (
    codec_coder as jcc, rans as jrans)
from imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu.entropy import (
    bottleneck as jbn, gaussian as jg)

# The suite runs several workers at once, and PyTorch's default of one
# thread per core in each of them oversubscribes the CPU many times over.
torch.set_num_threads(1)

PMF_TOL = 2.5e-7
MODULES_WITH_BUILDS = ((jrans, "librans.so"),)


@pytest.fixture(scope="module", autouse=True)
def private_jax_builds(tmp_path_factory):
    """The JAX package builds its C++ next to its sources at first use, and
    another test worker may be writing those files at this moment: where
    this process has not loaded them yet, build them into a directory of
    its own (the JAX package's build, flags and all)."""
    mp = pytest.MonkeyPatch()
    out = tmp_path_factory.mktemp("jax_coding_build")
    for mod, name in MODULES_WITH_BUILDS:
        if mod._lib is None:
            mp.setattr(mod, "_LIB", str(out / name))
    yield
    mp.undo()


def random_pmfs(rng, n, length):
    pmfs = rng.dirichlet(np.ones(length), size=n) * (1 - 1e-3)
    lengths = rng.randint(2, length + 1, size=n)
    tails = rng.uniform(1e-9, 1e-3, size=n)
    return pmfs, tails, lengths


def test_cdf_quantization_is_the_same():
    rng = np.random.RandomState(0)
    pmfs, tails, lengths = random_pmfs(rng, 12, 40)
    for row in pmfs[:4]:
        np.testing.assert_array_equal(prans.pmf_to_quantized_cdf(row),
                                      jrans.pmf_to_quantized_cdf(row))
    for got, want in zip(prans.build_cdf_matrix(pmfs, tails, lengths),
                         jrans.build_cdf_matrix(pmfs, tails, lengths)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def gaussian_tables():
    return pcc._gc_tables()


def test_gaussian_tables_and_indexes_are_the_same(gaussian_tables):
    got, want = pg.cdf_table(), jg.cdf_table()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-7)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(pg.get_scale_table(), jg.get_scale_table())
    for a, b in zip(gaussian_tables, jcc._gc_tables()):
        np.testing.assert_array_equal(a, b)
    # scales across the whole table, below its bound and on its entries
    rng = np.random.RandomState(1)
    s = np.concatenate([np.exp(rng.uniform(-4, 7, 4000)),
                        jg.get_scale_table(), [0.0, 0.05, 0.11, 300.0]]
                       ).astype(np.float32)
    got = pg.build_indexes(torch.from_numpy(s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jg.build_indexes(jnp.asarray(s))))


def test_streams_are_byte_identical_and_cross_decode(gaussian_tables):
    cdfs, lengths, offsets = gaussian_tables
    rng = np.random.RandomState(2)
    n = 5000
    idx = rng.randint(0, len(lengths), size=n).astype(np.int32)
    scale = pg.get_scale_table()[idx]
    sym = np.round(rng.laplace(0, scale)).astype(np.int32)
    sym[:20] = 10 ** 4                      # escapes past every row's tail
    data = prans.encode_with_indexes(sym, idx, cdfs, lengths, offsets)
    assert data == jrans.encode_with_indexes(sym, idx, cdfs, lengths, offsets)
    # buffered batches, decoded one slice at a time, both ways
    cut = [0, 700, 2500, n]
    enc_p, enc_j = prans.BufferedRansEncoder(), jrans.BufferedRansEncoder()
    for a, b in zip(cut[:-1], cut[1:]):
        enc_p.encode_with_indexes(sym[a:b], idx[a:b], cdfs, lengths, offsets)
        enc_j.encode_with_indexes(sym[a:b], idx[a:b], cdfs, lengths, offsets)
    stream_p, stream_j = enc_p.flush(), enc_j.flush()
    assert stream_p == stream_j == data
    for dec, stream in ((prans.RansDecoder(), stream_j),
                        (jrans.RansDecoder(), stream_p)):
        dec.set_stream(stream)
        got = np.concatenate([dec.decode_stream(idx[a:b], cdfs, lengths,
                                                offsets)
                              for a, b in zip(cut[:-1], cut[1:])])
        np.testing.assert_array_equal(got, sym)
    np.testing.assert_array_equal(
        prans.decode_with_indexes(data, idx, cdfs, lengths, offsets), sym)
    with pytest.raises(ValueError, match="CDF tables changed"):
        enc_p.encode_with_indexes(sym[:4], idx[:4], cdfs, lengths, offsets)
        enc_p.encode_with_indexes(sym[:4], idx[:4], cdfs + 1, lengths,
                                  offsets)


def bottlenecks(channels, seed):
    """A trained-looking bottleneck in both packages: the flax init moved by
    seeded noise, quantiles spread and sorted."""
    jm = jbn.EntropyBottleneck(channels)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, channels)),
                   False)["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in weights.flatten_params(init).items():
        v = np.asarray(v) + 0.3 * rng.randn(*v.shape)
        if "quantiles" in k:
            v = np.sort(3 * v, axis=-1)
        flat[k] = v.astype(np.float32)
    pm = pbn.EntropyBottleneck(channels)
    pm.load_state_dict(weights.state_dict_from_flax(flat))
    return jm, weights.unflatten_params(flat), pm


def test_bottleneck_tables_and_factorized_streams():
    jm, params, pm = bottlenecks(9, 3)
    want = [np.asarray(t) for t in jm.apply(
        {"params": params}, method=lambda m: m.pmf_table())]
    got = [t.numpy() for t in pm.pmf_table()]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=PMF_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=PMF_TOL)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    med = pm.medians().detach().numpy()
    np.testing.assert_array_equal(med, np.asarray(params["quantiles"])[:, 0, 1])

    # the same subbands through each package's factorized coder, from the
    # same tables (the JAX package's)
    cdfs, lengths = jrans.build_cdf_matrix(*want[:3])
    table = (cdfs, lengths, want[3].astype(np.int32), med)
    rng = np.random.RandomState(4)
    x = (rng.randn(1, 16, 12, 9) * 3 + med).astype(np.float32)
    data_p, hat_p = pcc.CodecCoder._eb_encode(None, x, table)
    data_j, hat_j = jcc.CodecCoder._eb_encode(None, x, table)
    assert data_p == data_j
    np.testing.assert_array_equal(hat_p, hat_j)
    np.testing.assert_array_equal(
        pcc.CodecCoder._eb_decode(None, data_j, x.shape, table), hat_j)
    np.testing.assert_array_equal(
        jcc.CodecCoder._eb_decode(None, data_p, x.shape, table), hat_p)

    # the port's own tables: a lossless round trip, the rate within 0.5 %
    own = prans.build_cdf_matrix(*got[:3])
    own_table = (*own, got[3].astype(np.int32), med)
    data, hat = pcc.CodecCoder._eb_encode(None, x, own_table)
    np.testing.assert_array_equal(
        pcc.CodecCoder._eb_decode(None, data, x.shape, own_table), hat)
    np.testing.assert_array_equal(hat, hat_j)
    assert abs(len(data) - len(data_j)) <= 0.005 * len(data_j)


def test_chunk_framing_is_the_same():
    """The length-prefixed framing of nested byte chunks (ZTBlock's level
    streams): the same bytes, and the inverse regroups them."""
    chunks = [[b"ab", b"", b"cde", b"f"], [b"g" * 300, b"h", b"", b"ij"]]
    data = pcc._pack_chunks(chunks)
    assert data == jcc._pack_chunks(chunks)
    assert pcc._unpack_chunks(data) == chunks == jcc._unpack_chunks(data)
