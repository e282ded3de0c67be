"""Anti-entropy sync as a batched pairwise exchange (port of
``corrosion_tpu/sim/sync.py``).

A syncing node and its peer exchange head vectors; the need per origin is
the interval ``(head_i, min(head_p, head_i + chunk)]`` and the "stream" is
a masked LWW merge of the peer's store cells whose ``(site, dbv)`` fall in
the granted range. Every k-th cohort round lane 0 merges its peer's whole
store (the sweep lane). ``axis`` (``parallel/exchange.NodeAxis``) runs the
exchange on a mesh shard's rows: the peers' cards, load, book and store
rows come through the axis's gathers, and the server-side load and the HLC
fold reach their owners through its owner reductions.
"""

from __future__ import annotations

from typing import Optional

import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.ops.dense import lookup_cols, take_rows
from corrosion_tpu_torch.ops.lww import INT32_MIN, lex_max
from corrosion_tpu_torch.ops.partials import drop_stale_partials
from corrosion_tpu_torch.ops.versions import advance_heads, needs_count, raise_heads
from corrosion_tpu_torch.sim.broadcast import (
    HLC_MAX_DRIFT_ROUNDS,
    HLC_ROUND_BITS,
    LAST_SYNC_CAP,
    CrdtState,
    hlc_fold,
)
from corrosion_tpu_torch.sim.transport import (
    CARD_EXTRA,
    N_RINGS,
    NetModel,
    bi_ok_c,
    card_at,
    link_card,
)


def choose_sync_peers(cfg, book, cand_ids, cand_ok, staleness, rings, k):
    """Need-driven sync peer choice: order candidates by (most versions
    still needed from the peer-as-origin, longest since last sync, closest
    RTT ring), packed into one int32 score, and take the top ``k`` (lowest
    candidate index first among ties). Returns ``(peers, ok, cand_idx)``."""
    n_org = cfg.n_origins
    needs = torch.clamp(needs_count(book), min=0)
    slot = torch.where(cand_ids >= 0, cand_ids % n_org, 0)
    owned = (cand_ids >= 0) & (lookup_cols(book.org_id, slot) == cand_ids)
    need = torch.where(owned, lookup_cols(needs, slot), 0)
    score = (
        (torch.clamp(need, max=4095) << 15)
        + (torch.clamp(staleness.to(torch.int32), max=LAST_SYNC_CAP) << 3)
        + (N_RINGS - 1 - torch.clamp(rings, 0, N_RINGS - 1))
    ).to(torch.int32)
    score = torch.where(cand_ok, score, -1)
    val, idx = prng.top_k(score, k)
    idx = idx.to(torch.int32)
    peers = lookup_cols(cand_ids, idx)
    return torch.clamp(peers, min=0), val >= 0, idx


def sync_step(cfg, cst: CrdtState, peers, p_ok, alive, net: NetModel, key,
              go_all: bool = False, sweep: Optional[bool] = None, axis=None):
    """One sync round over the caller-chosen ``peers`` lanes. ``sweep`` is
    None (no sweep lane configured) or this round's host-side bool.
    Returns ``(state, ok [N, P], info)``."""
    from corrosion_tpu_torch.sim.scale import node_axis

    n_org = cfg.n_origins
    p_cnt = peers.shape[1]
    dev = peers.device
    ax = node_axis(cfg, axis, dev)
    n, big_n, r0 = ax.rows, ax.n, ax.lo
    k_go, k_bi = prng.split(key)
    if peers.shape[0] != n or p_ok.shape != peers.shape:
        raise ValueError(
            f"peers {tuple(peers.shape)} / p_ok {tuple(p_ok.shape)} must both be ({n}, P)"
        )

    if go_all:
        syncing = alive
    else:
        syncing = alive & (
            prng.uniform(k_go, (n,), dev, row0=r0)
            < torch.tensor(1.0 / max(1, cfg.sync_interval), dtype=torch.float32,
                           device=dev)
        )
    card = link_card(net, alive, extra=(cst.hlc,))
    peer_card = card_at(ax.all_gather(card, "sync.card"), peers)  # [N, P, C]
    ok = syncing[:, None] & p_ok & bi_ok_c(net, k_bi, card[:, None, :], peer_card,
                                          row0=r0)

    # --- server-side load adaptation ------------------------------------
    serve_cap = max(1, cfg.serve_cap)
    load = ax.owner_add(torch.zeros(big_n + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(ok, peers, big_n).reshape(-1).long(),
        torch.ones(ok.numel(), dtype=torch.int32, device=dev))[:big_n], "sync.load")
    loadp = card_at(ax.all_gather(load[:, None], "sync.loads"), peers)[..., 0]  # [N, P]
    k_adm = prng.fold_in(k_bi, 7)
    admit_p = torch.where(
        loadp > 4 * serve_cap,
        torch.tensor(4.0 * serve_cap, dtype=torch.float32, device=dev)
        / torch.clamp(loadp, min=1).to(torch.float32),
        torch.tensor(1.0, dtype=torch.float32, device=dev),
    )
    defer_cap = max(1, cfg.sync_defer_cap)
    force = (cst.sync_defer >= defer_cap)[:, None]
    admitted = ok & ((prng.uniform(k_adm, tuple(ok.shape), dev, row0=r0) < admit_p)
                     | force)
    rejects = (ok & ~admitted).sum()
    admitted_any = admitted.any(dim=1)
    shed_all = ok.any(dim=1) & ~admitted_any
    cst = cst._replace(sync_defer=torch.where(
        admitted_any, 0,
        torch.where(shed_all, torch.clamp(cst.sync_defer + 1, max=defer_cap),
                    cst.sync_defer),
    ))
    ok = admitted
    chunk_eff = torch.clamp(
        (cfg.sync_chunk * serve_cap) // torch.clamp(loadp, min=serve_cap),
        min(cfg.sync_min_chunk, cfg.sync_chunk), cfg.sync_chunk,
    )  # [N, P]

    head_p = take_rows(ax.all_gather(cst.book.head, "sync.head"), peers)  # [N, P, O]
    org_p = take_rows(ax.all_gather(cst.book.org_id, "sync.org_id"), peers)  # [N, P, O]
    now = cst.now
    keep = cfg.org_keep_rounds
    evictable = (cst.book.org_id < 0) | (cst.book.org_last + keep < now)
    claim = ok[:, 0, None] & evictable & (org_p[:, 0, :] > cst.book.org_id)
    if not sweep:
        # outside a sweep round a claim needs something to grant
        claim = claim & (head_p[:, 0, :] > 0)
    org_id2 = torch.where(claim, org_p[:, 0, :], cst.book.org_id)
    head_i = torch.where(claim, 0, cst.book.head)
    book0 = cst.book._replace(
        head=head_i,
        known_max=torch.where(claim, 0, cst.book.known_max),
        seen=torch.where(claim[:, :, None], 0, cst.book.seen),
        org_id=org_id2,
        org_last=torch.where(claim, now, cst.book.org_last),
    )
    match = ok[:, :, None] & (org_p == org_id2[:, None, :]) & (org_id2[:, None, :] >= 0)
    granted = torch.minimum(head_p, head_i[:, None, :] + chunk_eff[:, :, None])
    granted = torch.where(match, granted, 0)  # [N, P, O]
    if sweep:
        # a sweep round's full-store merge backs adopting the peer's head
        granted[:, 0, :] = torch.where(match[:, 0, :], head_p[:, 0, :], granted[:, 0, :])

    # --- transfer: masked elementwise merge per peer --------------------
    # (a lane that grants nothing selects no cell, so every lane is merged
    # unconditionally: the same result as the JAX package's cond)
    store = tuple(cst.store)
    stores = tuple(ax.all_gather(pl, "sync.store") for pl in cst.store)
    pulled = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(p_cnt):
        pj = peers[:, j]
        p_ver, p_val, p_site, p_dbv, p_clp = (take_rows(pl, pj) for pl in stores)
        slot_c = torch.where(p_site >= 0, p_site % n_org, 0)
        owned_c = (p_site >= 0) & (lookup_cols(org_id2, slot_c) == p_site)
        lo = lookup_cols(head_i, slot_c)
        hi = lookup_cols(granted[:, j, :], slot_c)
        sel = ok[:, j:j + 1] & owned_c & (p_dbv > lo) & (p_dbv <= hi) & (p_ver > 0)
        # each [N, C] plane goes once it is spent (1.64 GB at N = 100,000
        # and 4,096 cells), not when the next peer's replaces it
        del slot_c, owned_c, lo, hi
        if sweep and j == 0:
            sel = sel | (ok[:, 0:1] & (p_ver > 0))
        b = tuple(torch.where(sel, v, INT32_MIN) for v in (p_clp, p_ver, p_val, p_site))
        del p_clp, p_ver, p_val, p_site
        m_clp, m_ver, m_val, m_site, m_dbv = lex_max(
            (store[4], store[0], store[1], store[2]), b, (store[3], p_dbv)
        )
        del b, p_dbv
        merged = (m_ver, m_val, m_site, m_dbv, m_clp)
        store = tuple(torch.where(sel, mv, s) for mv, s in zip(merged, store))
        pulled = pulled + sel.sum()
        del sel, merged, m_clp, m_ver, m_val, m_site, m_dbv

    # --- head jump (the window rebases with it) -------------------------
    new_head = torch.maximum(head_i, granted.amax(dim=1))
    book = advance_heads(raise_heads(book0, new_head))
    if sweep:
        km_collapse = ok[:, 0, None] & match[:, 0, :]
        book = book._replace(
            known_max=torch.where(km_collapse, book.head, book.known_max)
        )
    if cst.partials.origin.shape[1] > 1 or cst.partials.cell.shape[2] > 1:
        cst = cst._replace(partials=drop_stale_partials(cst.partials, book))

    # sync handshake exchanges HLC clocks; both sides fold
    hlc, _, _ = hlc_fold(cst.hlc, cst.now, peer_card[..., CARD_EXTRA], ok)
    client_ts = cst.hlc[:, None].expand(peers.shape)
    within = ok & ((client_ts >> HLC_ROUND_BITS) <= cst.now + HLC_MAX_DRIFT_ROUNDS)
    flat = torch.where(within, peers, big_n).reshape(-1).long()
    hlc = torch.cat([ax.spread(hlc, INT32_MIN),
                     torch.zeros(1, dtype=torch.int32, device=dev)])
    hlc = ax.owner_max(hlc.scatter_reduce_(0, flat, client_ts.reshape(-1), "amax",
                                           include_self=True)[:big_n], "sync.hlc")
    cst = cst._replace(hlc=hlc)

    info = {
        "syncs": ok.sum(),
        "cells_pulled": pulled,
        "versions_granted": torch.clamp(granted.amax(dim=1) - head_i, min=0).sum(),
        "serve_rejects": rejects,
    }
    return cst._replace(store=store, book=book), ok, info
