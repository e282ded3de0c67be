"""The port's PRNG (corrosion_tpu_torch/random.py) against jax.random:
keys, splits, fold-ins and draws must be bit-equal (tolerance 0)."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu_torch import random as prng
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

SEEDS = list(range(50)) + [123456, 2**31 - 1, 987654321]
SHAPES = [(7,), (5, 13), (3, 4, 6)]


def _data(k):
    return np.asarray(jr.key_data(k)).astype(np.int64)


def test_key_split_fold_in_match_jax():
    for s in SEEDS:
        k, t = jr.key(s), prng.key(s)
        assert np.array_equal(_data(k), t.numpy())
        for num in (2, 3, 4, 12):
            assert np.array_equal(_data(jr.split(k, num)), prng.split(t, num).numpy())
        for d in (0, 1, 7, 2**31 + 5):
            assert np.array_equal(_data(jr.fold_in(k, d)), prng.fold_in(t, d).numpy())


def test_key_from_data_roundtrip():
    k = jr.fold_in(jr.key(5), 99)
    t = prng.key_from_data(np.asarray(jr.key_data(k)))
    assert np.array_equal(_data(k), t.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bit_equal(shape):
    draw = jax.jit(lambda k: jr.uniform(k, shape))
    for s in SEEDS:
        want = np.asarray(draw(jr.key(s)))
        got = prng.uniform(prng.key(s), shape, "cpu").numpy()
        assert got.dtype == np.float32
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), s


# the ranges the round draws: (0, n) sweep peers / writes, (-1, n) random
# ids, (0, 1 << 20) write values, (0, 1 << pri_bits) election priorities
@pytest.mark.parametrize("lo,hi", [
    (0, 256), (0, 100_000), (-1, 4096), (0, 1 << 20), (0, 1 << 12),
    (0, 1 << 11), (0, 4), (3, 3), (-(1 << 31), (1 << 31) - 1),
])
def test_randint_bit_equal(lo, hi):
    draw = jax.jit(lambda k, a, b: jr.randint(k, (6, 11), a, b, dtype=jnp.int32))
    for s in SEEDS:
        want = np.asarray(draw(jr.key(s), lo, hi))
        got = prng.randint(prng.key(s), (6, 11), lo, hi, "cpu").numpy()
        assert got.dtype == np.int32
        assert np.array_equal(want, got), (s, lo, hi)


def test_top_k_lowest_index_first_among_ties():
    x = np.array([[0.5, 0.2, 0.5, -1.0, 0.5, -1.0, 0.2],
                  [-1.0] * 7, [3.0, 3.0, 1.0, 3.0, 2.0, 2.0, 1.0]], np.float32)
    for k in (1, 3, 5, 7):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = prng.top_k(torch.from_numpy(x), k)
        assert np.array_equal(np.asarray(wv), gv.numpy())
        assert np.array_equal(np.asarray(wi), gi.numpy())
    xi = np.array([[4, 7, 7, -1, 4, 7], [0, 0, 0, 0, 0, 0]], np.int32)
    wv, wi = jax.lax.top_k(jnp.asarray(xi), 4)
    gv, gi = prng.top_k(torch.from_numpy(xi), 4)
    assert np.array_equal(np.asarray(wi), gi.numpy())
    assert np.array_equal(np.asarray(wv), gv.numpy())
