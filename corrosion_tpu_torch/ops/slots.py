"""Fixed-capacity slot machinery (port of ``corrosion_tpu/ops/slots.py``):
bounded queues with the reference's drop and evict policies."""

from __future__ import annotations

import torch

from corrosion_tpu_torch.ops.dense import lookup_cols, scatter_cols_set
from corrosion_tpu_torch.ops.lww import INT32_MAX, INT32_MIN


def alloc_slots_evict(free, evict_key, want):
    """Place each row's wanting items into slots in ascending ``evict_key``
    order (free slots first, ties to the lowest slot): the r-th wanting
    item takes the r-th slot; items beyond the slot count drop. Returns
    ``(slot int32 [N, M], placed bool [N, M])``."""
    k = free.shape[1]
    key = torch.where(free, INT32_MIN, evict_key.to(torch.int32))
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    rank = (torch.cumsum(want.to(torch.int32), dim=1) - 1).to(torch.int32)
    placed = want & (rank < k)
    return lookup_cols(order, rank.clamp(0, k - 1)), placed


def budget_mask(live, priority, allowed):
    """Keep the ``allowed`` highest-``priority`` live slots per row (the
    first column among equals); ``allowed`` is an int or an int32 [N]."""
    n, k = live.shape
    if isinstance(allowed, int):
        if allowed >= k:
            return live
        allowed = torch.full((n,), allowed, dtype=torch.int32, device=live.device)
    key = torch.where(live, -priority.to(torch.int32), INT32_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    ranks = torch.arange(k, dtype=torch.int32, device=live.device).expand(n, k)
    # order is a permutation of each row: one writer per (row, column)
    rank = torch.empty((n, k), dtype=torch.int32, device=live.device)
    rank.scatter_(1, order, ranks)
    return live & (rank < allowed[:, None])


def scatter_rows(dest, slot, placed, values):
    """``dest[i, slot[i, j]] = values[i, j]`` where ``placed``."""
    return scatter_cols_set(dest, slot, values, placed)
