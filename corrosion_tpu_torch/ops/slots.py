"""Fixed-capacity slot machinery (port of ``corrosion_tpu/ops/slots.py``):
bounded queues with the reference's drop and evict policies."""

from __future__ import annotations

import torch

from corrosion_tpu_torch.ops.dense import lookup_cols, scatter_cols_set
from corrosion_tpu_torch.ops.lww import INT32_MAX, INT32_MIN


def alloc_slots(free, want):
    """Place each row's wanting items into that row's free slots, in
    column order (the lowest free slot first); items beyond the free-slot
    supply are not placed. Returns ``(slot int32 [N, M], placed bool
    [N, M])``; a slot that is not placed is clipped garbage."""
    k = free.shape[1]
    order = torch.argsort((~free).to(torch.int32), dim=1, stable=True).to(torch.int32)
    n_free = free.sum(dim=1, dtype=torch.int32)
    rank = (torch.cumsum(want.to(torch.int32), dim=1) - 1).to(torch.int32)
    placed = want & (rank < n_free[:, None])
    return lookup_cols(order, rank.clamp(0, k - 1)), placed


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


def mailbox_pack(recv, valid, n_rows: int, capacity: int, fields):
    """Regroup flat messages into dense per-receiver mailboxes.

    ``recv`` int32 [M], ``valid`` bool [M], ``fields`` a tuple of [M]
    payloads. Returns ``(live, packed_fields)`` of shape [n_rows,
    capacity]: one stable sort by receiver, and each message's rank in its
    receiver's run (its index less the run's first index, found by a
    binary search of the sorted receivers); each receiver keeps its first
    ``capacity`` messages in flat order and the rest drop. Every kept
    message has a slot of its own, so the scatter has one writer per slot;
    the dropped ones go to a scratch slot past the end."""
    m = recv.shape[0]
    dev = recv.device
    sort_key = torch.where(valid, recv.to(torch.int32), n_rows)
    order = torch.argsort(sort_key, stable=True)
    r_s = sort_key[order].long()
    rank = torch.arange(m, dtype=torch.int64, device=dev) - torch.searchsorted(r_s, r_s)
    ok = (r_s < n_rows) & (rank < capacity)
    drop = n_rows * capacity
    flat = torch.where(ok, r_s * capacity + rank, drop)

    def pack(vals, dtype):
        out = torch.zeros(drop + 1, dtype=dtype, device=dev)
        out[flat] = vals
        return out[:drop].reshape(n_rows, capacity)

    live = pack(torch.ones(m, dtype=torch.bool, device=dev), torch.bool)
    return live, tuple(pack(f[order], f.dtype) for f in fields)
