"""Column lookups and scatters over small per-row tables (port of
``corrosion_tpu/ops/dense.py``).

The semantics are those of the JAX package's **dense** form: out-of-range
indices are ignored (a lookup returns ``fill``), and ``scatter_cols_set``
lets the largest value win when a (row, column) has several writers. Every
scatter here is deterministic on CUDA: maxima go through
``scatter_reduce_(..., "amax")``, integer sums through ``"sum"`` (exact in
any order), and nothing uses a plain ``scatter_`` with duplicate indices.
"""

from __future__ import annotations

import torch

from corrosion_tpu_torch.ops.lww import INT32_MIN, lex_wins


def _min_of(dtype) -> int:
    return torch.iinfo(dtype).min


def _routed(idx, valid, w):
    """int64 column index with invalid or out-of-range writers routed to the
    scratch column ``w``."""
    valid = valid & (idx >= 0) & (idx < w)
    return torch.where(valid, idx, w).long()


def lookup_cols(table, idx, fill=0):
    """``out[n, m] = table[n, idx[n, m]]``, ``fill`` where out of range."""
    w = table.shape[1]
    in_range = (idx >= 0) & (idx < w)
    got = torch.gather(table, 1, idx.clamp(0, w - 1).long())
    return torch.where(in_range, got, torch.tensor(fill, dtype=table.dtype,
                                                   device=table.device))


def _scatter(dest, idx, vals, valid, reduce, init):
    n, w = dest.shape
    pad = torch.full((n, 1), init, dtype=dest.dtype, device=dest.device)
    out = torch.cat([dest, pad], dim=1)
    out.scatter_reduce_(1, _routed(idx, valid, w), vals.to(dest.dtype),
                        reduce, include_self=True)
    return out[:, :w]


def scatter_cols_max(dest, idx, vals, valid):
    """``dest[n, idx[n, m]] = max(dest, vals[n, m])`` where valid."""
    return _scatter(dest, idx, vals, valid, "amax", _min_of(dest.dtype))


def scatter_cols_add(dest, idx, vals, valid):
    """``dest[n, idx[n, m]] += vals[n, m]`` where valid (in dest's dtype)."""
    return _scatter(dest, idx, vals, valid, "sum", 0)


def scatter_cols_set(dest, idx, vals, valid):
    """``dest[n, idx[n, m]] = vals[n, m]`` where valid; with several writers
    on one (row, column) the largest value wins."""
    n, w = dest.shape
    lo = _min_of(dest.dtype)
    best = _scatter(torch.full_like(dest, lo), idx, vals, valid, "amax", lo)
    has = _scatter(torch.zeros_like(dest, dtype=torch.int32), idx,
                   torch.ones_like(idx, dtype=torch.int32), valid, "amax", 0)
    return torch.where(has > 0, best, dest)


def scatter_cols_or(dest, idx, vals, valid):
    """``dest[n, idx[n, m]] |= vals[n, m]`` where valid (bit patterns in an
    integer dtype). One message column at a time: each step has one writer
    per row, so the gather-or-scatter is exact and deterministic."""
    n, w = dest.shape
    out = torch.cat([dest, torch.zeros((n, 1), dtype=dest.dtype,
                                       device=dest.device)], dim=1)
    col = _routed(idx, valid, w)
    vals = torch.where(valid, vals.to(dest.dtype), torch.zeros_like(vals, dtype=dest.dtype))
    for j in range(idx.shape[1]):
        c = col[:, j:j + 1]
        out.scatter_(1, c, torch.gather(out, 1, c) | vals[:, j:j + 1])
    return out[:, :w]


def select_cols(rows, idx):
    """``out[n, m] = rows[n, idx[n, m]]`` (alias of :func:`lookup_cols`)."""
    return lookup_cols(rows, idx)


def take_rows(table, idx):
    """``table[idx]`` along axis 0 with JAX's gather semantics for the
    indices this port passes (non-negative; past-the-end clamps to the
    last row)."""
    flat = idx.reshape(-1).clamp(0, table.shape[0] - 1).long()
    return table.index_select(0, flat).reshape(tuple(idx.shape) + tuple(table.shape[1:]))



def apply_changes(store, cell, ver, val, site, dbv, clp, valid):
    """LWW apply of per-row message batches to ``(ver, val, site, dbv, clp)``
    planes [N, C]: per cell, the batch's lexicographic max over
    ``(clp, ver, val, site)`` (then the largest ``dbv`` among exact ties)
    replaces the incumbent unless the incumbent wins the four keys."""
    s_ver, s_val, s_site, s_dbv, s_clp = store
    c = s_ver.shape[1]
    alive = valid & (cell >= 0) & (cell < c)
    idx = torch.where(alive, cell, c).long()
    lo = INT32_MIN

    def seg_max(v):
        out = torch.full((v.shape[0], c + 1), lo, dtype=torch.int32, device=v.device)
        return out.scatter_reduce_(1, idx, v, "amax", include_self=True)

    nonempty = seg_max(alive.to(torch.int32))[:, :c] > lo
    mx = []
    for k in (clp, ver, val, site):
        kk = torch.where(alive, k, lo)
        mk = seg_max(kk)
        alive = alive & (kk == torch.gather(mk, 1, idx))
        mx.append(mk[:, :c])
    b_dbv = seg_max(torch.where(alive, dbv, lo))[:, :c]
    take = nonempty & ~lex_wins((s_clp, s_ver, s_val, s_site), mx)
    return (
        torch.where(take, mx[1], s_ver),
        torch.where(take, mx[2], s_val),
        torch.where(take, mx[3], s_site),
        torch.where(take, b_dbv, s_dbv),
        torch.where(take, mx[0], s_clp),
    )
