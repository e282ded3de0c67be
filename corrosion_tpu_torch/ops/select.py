"""Random-candidate selection (port of ``corrosion_tpu/ops/select.py``):
score every candidate with a uniform draw, mask the rest to -1, take the
top scores (lowest index first among ties, like ``lax.top_k``). ``row0``
is the first row of ``mask`` in a larger draw (a mesh shard's rows)."""

from __future__ import annotations

import torch

from corrosion_tpu_torch import random as prng


def sample_k(mask, k: int, key, row0: int = 0):
    """Per-row uniform sample of ``k`` distinct columns where ``mask``:
    ``(cols int32 [N, k], ok bool [N, k])``."""
    u = prng.uniform(key, mask.shape, mask.device, row0=row0)
    scores = torch.where(mask, u, torch.full_like(u, -1.0))
    val, cols = prng.top_k(scores, k)
    return cols.to(torch.int32), val >= 0


def sample_k_biased(mask, bonus, k: int, key, row0: int = 0):
    """:func:`sample_k` with a per-candidate score ``bonus`` added to the
    draw (a bonus >= 1 is strict priority)."""
    u = prng.uniform(key, mask.shape, mask.device, row0=row0) + bonus
    scores = torch.where(mask, u, torch.full_like(u, -1.0))
    val, cols = prng.top_k(scores, k)
    return cols.to(torch.int32), val >= 0


def sample_one(mask, key, row0: int = 0):
    """Per-row uniform sample of one column where ``mask``: ``(col, ok)``
    (the first column among equal scores, like ``jnp.argmax``)."""
    u = prng.uniform(key, mask.shape, mask.device, row0=row0)
    scores = torch.where(mask, u, torch.full_like(u, -1.0))
    col = torch.argmax(scores, dim=1).to(torch.int32)
    return col, mask.any(dim=1)
