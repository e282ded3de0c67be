"""A bit-exact port of JAX's default PRNG (``threefry2x32``, partitionable).

Every sampling decision of the scale round comes from JAX keys, so the
port reproduces the keys and the draws bit for bit; that is what lets the
whole round be compared with the JAX package by exact equality.

A key is an int64 tensor of shape ``[2]`` holding two uint32 words (the
``jax.random.key_data`` layout). Keys are small host tensors: deriving a
key (``split``, ``fold_in``) is scalar work done in Python integers, while
the draws (``bits``, ``uniform``, ``randint``) are made on the device the
caller names. The generator is explicit: no global state.

The algorithms follow ``jax/_src/prng.py`` (``threefry2x32`` with
``jax_threefry_partitionable=True``, the default) and ``jax/_src/random.py``
(``uniform``: mantissa bits ``| 0x3F800000``; ``randint``: two 32-bit draws
and a multiply-mod). torch has no uint32 ``+``/``>>``/``<<`` on the CPU, so
the tensor rounds run in int64 under ``& 0xFFFFFFFF``.

A draw whose leading axis is the node axis can be made for one shard's rows
only: ``row0`` names the first row of ``shape`` in the whole draw, and the
result is bitwise that slice of the whole draw (element ``i`` hashes count
``i``, so rows ``lo..hi`` of an ``[N, Q]`` draw are counts ``lo*Q ..
hi*Q``).

``split``, ``fold_in``, ``bits``, ``uniform``, ``randint`` and ``top_k``
are priced units (``_units.py``): an open cost counter prices each call
from its shape as the JAX package's model prices the same call, whatever
ops run inside it.
"""

from __future__ import annotations

import math

import torch

from corrosion_tpu_torch._units import unit

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _M32


def _threefry(k1, k2, x0, x1):
    """Threefry-2x32 over uint32 words held in Python ints or int64
    tensors (20 rounds, 5 key injections)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _words(key: torch.Tensor):
    k = key.tolist()
    if len(k) != 2:
        raise ValueError(f"a key is two uint32 words, got shape {tuple(key.shape)}")
    return int(k[0]) & _M32, int(k[1]) & _M32


def _make(w0: int, w1: int) -> torch.Tensor:
    return torch.tensor([w0, w1], dtype=torch.int64)


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``: the 64-bit seed split into two words."""
    seed = int(seed)
    return _make((seed >> 32) & _M32, seed & _M32)


def key_from_data(data) -> torch.Tensor:
    """A key from ``jax.random.key_data`` output (uint32 ``[2]``)."""
    words = data.tolist() if hasattr(data, "tolist") else list(data)
    if len(words) != 2:
        raise ValueError(f"key data has {len(words)} words, need 2")
    return _make(int(words[0]) & _M32, int(words[1]) & _M32)


@unit("split")
def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: int64 ``[num, 2]`` (key i hashes count i)."""
    k1, k2 = _words(k)
    return torch.tensor([list(_threefry(k1, k2, 0, i)) for i in range(num)],
                        dtype=torch.int64).reshape(num, 2)


@unit("fold_in")
def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the count pair ``(0, data)``."""
    k1, k2 = _words(k)
    return _make(*_threefry(k1, k2, 0, int(data) & _M32))


@unit("bits")
def bits(k: torch.Tensor, shape, device, row0: int = 0) -> torch.Tensor:
    """32 random bits per element (int64 values in ``[0, 2**32)``): element
    ``i`` (row-major) hashes the 64-bit count ``i``; the two output words
    are XOR-ed. ``row0 > 0``: ``shape`` is rows ``row0..`` of a larger
    draw along its leading axis."""
    k1, k2 = _words(k)
    shape = tuple(int(s) for s in shape)
    if row0:
        first = int(row0) * math.prod(shape[1:])
        count = torch.arange(first, first + math.prod(shape), dtype=torch.int64,
                             device=device)
    else:
        count = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = _threefry(k1, k2, count >> 32, count & _M32)
    return (b0 ^ b1).reshape(shape)


def _bits(k, shape, device, row0: int):
    """:func:`bits` as the draws call it: the whole draw's call unchanged
    (``row0`` only when a shard's rows are asked for)."""
    return bits(k, shape, device, row0=row0) if row0 else bits(k, shape, device)


@unit("uniform")
def uniform(k: torch.Tensor, shape, device, minval: float = 0.0,
            maxval: float = 1.0, row0: int = 0) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)``, bit-equal to
    ``jax.random.uniform`` (``row0``: as :func:`bits`)."""
    f = ((_bits(k, shape, device, row0) >> 9) | 0x3F800000).to(torch.int32)
    floats = f.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


@unit("randint")
def randint(k: torch.Tensor, shape, minval: int, maxval: int,
            device, row0: int = 0) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)``, bit-equal to
    ``jax.random.randint(..., dtype=int32)`` for bounds inside int32
    (``row0``: as :func:`bits`)."""
    minval, maxval = int(minval), int(maxval)
    if not (-(1 << 31) <= minval < (1 << 31) and -(1 << 31) <= maxval < (1 << 31)):
        raise ValueError(f"randint bounds {minval}, {maxval} outside int32")
    k1, k2 = split(k)
    higher = _bits(k1, shape, device, row0)
    lower = _bits(k2, shape, device, row0)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    mult = (1 << 16) % span
    mult = (mult * mult & _M32) % span
    off = ((higher % span) * mult & _M32) + (lower % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)


@unit("top_k")
def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values and their
    indices, the lowest index first among ties (a stable descending sort).
    Both come back contiguous, whatever ``k`` is, so what a caller does
    with them is the same work at every width."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()
