"""The traffic generator: the same seed gives the same bytes, another seed
other pixels at the same sizes, and any whole seed works."""

import numpy as np
import pytest

from bench_port.traffic.deadleaves import dead_leaves
from bench_port.traffic.generator import EVAL_RING, Traffic, stream_seed

EVAL = {"kind": "eval_batches", "pool": 2, "pool_size": 64, "batch": 3,
        "rows": 32, "cols": 48}
TRAIN = {"kind": "train_chunks", "pool": 2, "pool_size": 64, "batch": 2,
         "patch": 16, "steps_per_call": 3}


@pytest.mark.parametrize("params", [EVAL, TRAIN])
def test_same_seed_same_bytes(params):
    a, b = Traffic(params, 2 ** 31 + 11), Traffic(params, 2 ** 31 + 11)
    for _ in range(3):
        x, y = a.next(), b.next()
        assert x.tobytes() == y.tobytes()
    c = Traffic(params, 2 ** 31 + 12).next()
    assert c.shape == x.shape and c.dtype == x.dtype
    assert c.tobytes() != x.tobytes()


def test_eval_batches_come_in_turn_from_the_ring():
    t = Traffic(EVAL, 3)
    first = [t.next() for _ in range(EVAL_RING)]
    assert len({x.tobytes() for x in first}) == EVAL_RING
    assert [x is y for x, y in zip(first, t.ring)] == [True] * EVAL_RING
    assert t.next() is first[0]


def test_request_forms():
    x = Traffic(EVAL, 1).next()
    assert x.shape == (3, 3, 32, 48) and x.dtype == np.float32
    assert x.flags["C_CONTIGUOUS"] and 0.0 <= x.min() and x.max() <= 1.0
    assert Traffic(EVAL, 1).pixels() == 3 * 32 * 48
    c = Traffic(TRAIN, 1).next()
    assert c.shape == (3, 2, 16, 16, 3) and c.dtype == np.uint8


def test_dead_leaves_is_the_program_generator():
    from imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.train \
        import data
    for a, b in zip(dead_leaves(2, 48, 7),
                    data.synthetic_natural_images(2, 48, 7)):
        assert a.tobytes() == b.tobytes()


def test_stream_seeds():
    seeds = [0, 1, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 40, -4]
    got = {stream_seed(s, "pool") for s in seeds}
    assert len(got) == len(seeds)
    assert all(0 <= x < 2 ** 32 for x in got)
    assert stream_seed(5, "pool") != stream_seed(5, "draws")
    assert 0 <= stream_seed(2 ** 35, "noise", 64) < 2 ** 64
