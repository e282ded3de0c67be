"""Partial-changeset buffering for multi-cell transactions (port of
``corrosion_tpu/ops/partials.py``).

A transaction's cells share one ``(origin, db_version)`` and carry ``seq``
0..nseq-1. Per node, a pool of P slots keyed by ``(origin, dbv)`` holds a
received-seq bitmask and K payload lanes; arriving cells match or allocate
a slot, set their bit and park their payload, and a slot whose mask covers
``0..nseq-1`` is complete (the caller applies it and frees it). A full pool
drops the cell; sync repairs.

The flat scatters of the JAX package (``.at[...](mode="drop")``) send the
dropped writers to one sentinel element past the end, which is cut off
after the scatter; every ``set`` scatter has one writer per kept element by
construction, and ``max``/``add`` go through ``scatter_reduce_``/
``scatter_add_``, exact in any order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from corrosion_tpu_torch.ops.dense import lookup_cols
from corrosion_tpu_torch.ops.slots import alloc_slots, scatter_rows

NO_SLOT = -1


class Partials(NamedTuple):
    """Per-node partial-version buffer: [N, P] keys + [N, P, K] payloads."""

    origin: torch.Tensor  # int32 [N, P], -1 = free
    dbv: torch.Tensor  # int32 [N, P]
    mask: torch.Tensor  # int32 [N, P] — bitmask of received seqs
    nseq: torch.Tensor  # int32 [N, P]
    cell: torch.Tensor  # int32 [N, P, K]
    ver: torch.Tensor
    val: torch.Tensor
    site: torch.Tensor
    clp: torch.Tensor

    @staticmethod
    def create(n_nodes: int, p_slots: int, k_seqs: int, device) -> "Partials":
        if not 1 <= k_seqs <= 30:
            raise ValueError(
                f"k_seqs {k_seqs} not in 1..30 (seq bitmask lives in an int32)"
            )

        def z(*s):
            return torch.zeros(s, dtype=torch.int32, device=device)

        return Partials(
            origin=torch.full((n_nodes, p_slots), NO_SLOT, dtype=torch.int32,
                              device=device),
            dbv=z(n_nodes, p_slots), mask=z(n_nodes, p_slots),
            nseq=z(n_nodes, p_slots),
            cell=z(n_nodes, p_slots, k_seqs), ver=z(n_nodes, p_slots, k_seqs),
            val=z(n_nodes, p_slots, k_seqs), site=z(n_nodes, p_slots, k_seqs),
            clp=z(n_nodes, p_slots, k_seqs),
        )


def _first_true(x):
    """Index of the first True along the last axis (0 where none), as
    ``jnp.argmax`` of a bool array gives it."""
    m = x.shape[-1]
    ar = torch.arange(m, dtype=torch.int32, device=x.device)
    first = torch.where(x, ar, m).amin(dim=-1)
    return torch.where(first == m, 0, first).to(torch.int32)


def _flat_update(dest, flat_idx, vals, op):
    """``dest.reshape(-1).at[flat_idx].op(vals, mode="drop")`` with every
    index outside ``dest`` sent to a sentinel element that is cut off."""
    size = dest.numel()
    idx = flat_idx.reshape(-1).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.cat([dest.reshape(-1), dest.new_zeros(1)])
    v = vals.reshape(-1).to(dest.dtype)
    if op == "set":
        out.scatter_(0, idx, v)
    elif op == "add":
        out.scatter_add_(0, idx, v)
    else:
        out.scatter_reduce_(0, idx, v, "amax", include_self=True)
    return out[:size].reshape(dest.shape)


def ingest_partials(par: Partials, live, m_origin, m_dbv, m_seq, m_nseq,
                    m_cell, m_ver, m_val, m_site, m_clp):
    """Buffer a per-node batch of chunked-version cells (fields int32
    [N, M]; ``live`` marks candidates the caller has not already seen).
    Returns ``(par, fresh)``: ``fresh`` marks cells newly buffered (a seq
    already held, or repeated earlier in the batch, is not fresh)."""
    n, p = par.origin.shape
    k = par.cell.shape[2]
    m = m_origin.shape[1]
    dev = m_origin.device

    # match existing slots [N, M, P]
    slot_live = par.origin != NO_SLOT
    eq = (live[:, :, None] & slot_live[:, None, :]
          & (par.origin[:, None, :] == m_origin[:, :, None])
          & (par.dbv[:, None, :] == m_dbv[:, :, None]))
    has_match = eq.any(dim=2)
    match_slot = _first_true(eq)

    # group the batch by (origin, dbv) [N, M, M]; one slot per leader
    same_key = (live[:, :, None] & live[:, None, :]
                & (m_origin[:, :, None] == m_origin[:, None, :])
                & (m_dbv[:, :, None] == m_dbv[:, None, :]))
    leader_idx = _first_true(same_key)
    is_leader = live & (leader_idx == torch.arange(m, dtype=torch.int32, device=dev))
    seq_ok = (m_seq >= 0) & (m_seq < k) & (m_nseq >= 1) & (m_nseq <= k)
    slot_alloc, placed = alloc_slots(~slot_live, is_leader & ~has_match & seq_ok)
    lead = leader_idx.long()
    l_placed = torch.gather(placed, 1, lead)
    l_slot = torch.gather(slot_alloc, 1, lead)
    slot = torch.where(has_match, match_slot, l_slot)
    found = has_match | (live & ~has_match & l_placed)

    # per-seq dedupe against the slot's mask and earlier cells of the batch
    seqc = torch.clamp(m_seq, 0, k - 1).to(torch.int32)
    pre_mask = torch.where(has_match, lookup_cols(par.mask, torch.clamp(slot, 0, p - 1)), 0)
    already = ((pre_mask >> seqc) & 1) == 1
    earlier = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
    dup = (same_key & (m_seq[:, :, None] == m_seq[:, None, :]) & earlier).any(dim=2)
    fresh = live & found & seq_ok & ~already & ~dup

    # scatter: slot keys, nseq, mask bits (each fresh bit is new: add == or),
    # payload lanes
    rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    at = rows * p + slot.to(torch.int64)
    flat_slot = torch.where(fresh, at, n * p)
    flat_lane = torch.where(fresh, at * k + seqc, n * p * k)
    bit = torch.where(fresh, torch.ones_like(seqc) << seqc, 0)

    def put(dest, v):
        return _flat_update(dest, flat_lane, v, "set")

    par = Partials(
        origin=scatter_rows(par.origin, slot_alloc, placed, m_origin),
        dbv=scatter_rows(par.dbv, slot_alloc, placed, m_dbv),
        mask=_flat_update(par.mask, flat_slot, bit, "add"),
        nseq=_flat_update(par.nseq, flat_slot, m_nseq, "max"),
        cell=put(par.cell, m_cell), ver=put(par.ver, m_ver),
        val=put(par.val, m_val), site=put(par.site, m_site),
        clp=put(par.clp, m_clp),
    )
    return par, fresh


def complete_mask(par: Partials):
    """bool [N, P]: slots holding every seq ``0..nseq-1`` of their version."""
    full_bits = (torch.ones_like(par.nseq) << par.nseq) - 1
    return (par.origin != NO_SLOT) & (par.nseq > 0) & (par.mask == full_bits)


def free_slots(par: Partials, drop) -> Partials:
    """Release slots marked by ``drop`` bool [N, P]."""
    return par._replace(
        origin=torch.where(drop, NO_SLOT, par.origin),
        dbv=torch.where(drop, 0, par.dbv),
        mask=torch.where(drop, 0, par.mask),
        nseq=torch.where(drop, 0, par.nseq),
    )


def drop_stale_partials(par: Partials, book) -> Partials:
    """Free slots whose version is at/below the node's head for that origin
    (it arrived whole through sync)."""
    from corrosion_tpu_torch.ops.versions import org_slot

    live = par.origin != NO_SLOT
    slot, owned = org_slot(book, par.origin)
    h = lookup_cols(book.head, slot.clamp(0, book.head.shape[1] - 1))
    return free_slots(par, live & owned & (par.dbv <= h))
