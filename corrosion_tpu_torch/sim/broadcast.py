"""CRDT state, hybrid logical clock, the write and ingest entry points and
the full view's broadcast flush (port of ``corrosion_tpu/sim/broadcast.py``).

Every node carries an LWW store, version bookkeeping (``Book``), a buffer
of incomplete multi-cell versions (``Partials``) and a fixed-width queue of
changesets awaiting re-broadcast. The route is the config's, as in the JAX
package (:func:`kernel_ingest`): single-cell configurations without the
wire-budget lane write and ingest through the ingest kernel
(``ops/megakernel.py``); multi-cell transactions (``tx_max_cells > 1``) and
the wire-budget lane run the plain PyTorch bodies here, on whatever device
the tensors are on.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.ops.dense import apply_changes, lookup_cols
from corrosion_tpu_torch.ops.partials import (
    Partials,
    complete_mask,
    free_slots,
    ingest_partials,
)
from corrosion_tpu_torch.ops.slots import (
    alloc_slots_evict,
    budget_mask,
    mailbox_pack,
    scatter_rows,
)
from corrosion_tpu_torch.ops.versions import (
    Book,
    bump_known_max,
    org_slot,
    record_versions,
    seen_versions,
)
from corrosion_tpu_torch.sim.transport import NetModel, uni_ok

NO_Q = -1
LAST_SYNC_CAP = 4095  # staleness saturates (never-synced == very stale)
# stamps are ``round << HLC_ROUND_BITS | logical``; drift rejection compares
# the stamp's round part against the receiver's current round
HLC_ROUND_BITS = 10
HLC_MAX_DRIFT_ROUNDS = 2
# wire-size estimate of one changeset cell (the send-budget unit)
CHANGE_WIRE_BYTES = 64


def hlc_tick(hlc, now, active):
    """Per-node stamps, strictly monotonic and >= ``now << bits``:
    ``(stamp [N], hlc')``."""
    stamp = torch.maximum(hlc + 1, now << HLC_ROUND_BITS)
    return stamp, torch.where(active, stamp, hlc)


def hlc_fold(hlc, now, m_ts, live):
    """Fold received stamps into each node's clock, rejecting stamps too far
    ahead of local time: ``(hlc', ok [N, M], rejects)``."""
    phys = m_ts >> HLC_ROUND_BITS
    ok = live & (phys <= now + HLC_MAX_DRIFT_ROUNDS)
    folded = torch.where(ok, m_ts, 0).amax(dim=1)
    return torch.maximum(hlc, folded), ok, (live & ~ok).sum()


def plane_dtypes(cfg) -> tuple:
    """(``q_cell``/``last_sync``, ``q_tx``/``q_seq``/``q_nseq``) plane dtypes
    of ``cfg``: int16 under ``narrow_dtypes``, int8 for the second under
    ``narrow_q_int8``, else int32 (the full view's ``SimConfig`` has neither
    field)."""
    ndt = torch.int16 if getattr(cfg, "narrow_dtypes", False) else torch.int32
    return ndt, torch.int8 if getattr(cfg, "narrow_q_int8", False) else ndt


class CrdtState(NamedTuple):
    """LWW store + bookkeeping + broadcast queues for all N nodes (same leaf
    order and dtypes as the JAX ``CrdtState``)."""

    store: Tuple[torch.Tensor, ...]  # (ver, val, site, dbv, clp) int32 [N, C]
    book: Book
    next_dbv: torch.Tensor  # int32 [N]
    q_origin: torch.Tensor  # int32 [N, Q] — -1 = free slot
    q_dbv: torch.Tensor
    q_cell: torch.Tensor  # narrow dtype
    q_ver: torch.Tensor
    q_val: torch.Tensor
    q_site: torch.Tensor
    q_clp: torch.Tensor
    q_seq: torch.Tensor  # q dtype
    q_nseq: torch.Tensor  # q dtype
    q_ts: torch.Tensor
    q_tx: torch.Tensor  # q dtype — remaining transmissions
    partials: Partials
    hlc: torch.Tensor  # int32 [N]
    now: torch.Tensor  # int32 [] — round counter
    last_sync: torch.Tensor  # narrow dtype [N, S]
    sync_defer: torch.Tensor  # int32 [N]

    @staticmethod
    def create(cfg, device="cuda") -> "CrdtState":
        dev = resolve_device(device)
        n, q, c = cfg.n_nodes, cfg.bcast_queue, cfg.n_cells
        ndt, qdt = plane_dtypes(cfg)

        def z(*s, dtype=torch.int32):
            return torch.zeros(s, dtype=dtype, device=dev)

        return CrdtState(
            store=tuple(z(n, c) for _ in range(5)),
            book=Book.create(n, cfg.n_origins, cfg.buf_slots, dev),
            next_dbv=torch.ones(n, dtype=torch.int32, device=dev),
            q_origin=torch.full((n, q), NO_Q, dtype=torch.int32, device=dev),
            q_dbv=z(n, q),
            q_cell=z(n, q, dtype=ndt),
            q_ver=z(n, q),
            q_val=z(n, q),
            q_site=z(n, q),
            q_clp=z(n, q),
            q_seq=z(n, q, dtype=qdt),
            q_nseq=torch.ones((n, q), dtype=qdt, device=dev),
            q_ts=z(n, q),
            q_tx=z(n, q, dtype=qdt),
            partials=Partials.create(
                n, cfg.partial_slots if cfg.tx_max_cells > 1 else 1,
                max(1, cfg.tx_max_cells), dev,
            ),
            hlc=z(n),
            now=torch.zeros((), dtype=torch.int32, device=dev),
            last_sync=torch.full((n, cfg.sync_tracks), LAST_SYNC_CAP, dtype=ndt,
                                 device=dev),
            sync_defer=z(n),
        )


def kernel_ingest(cfg) -> bool:
    """Does ``cfg`` route its ingest through the ingest kernel? As in the JAX
    package: single-cell versions (``tx_max_cells <= 1``) without the
    wire-budget lane. Every other configuration runs the plain body below,
    on CUDA tensors too."""
    return cfg.tx_max_cells <= 1 and not getattr(cfg, "bcast_wire_budget", False)


def _enqueue(cst: CrdtState, want, origin, dbv, cell, ver, val, site, clp,
             seq, nseq, ts, tx):
    """Place per-node batches of changes into queue slots; on overflow the
    most-sent queued changeset (lowest remaining budget) is evicted."""
    slot, placed = alloc_slots_evict(cst.q_origin == NO_Q, cst.q_tx, want)

    def put(plane, v):
        return scatter_rows(plane, slot, placed, v)

    return cst._replace(
        q_origin=put(cst.q_origin, origin), q_dbv=put(cst.q_dbv, dbv),
        q_cell=put(cst.q_cell, cell), q_ver=put(cst.q_ver, ver),
        q_val=put(cst.q_val, val), q_site=put(cst.q_site, site),
        q_clp=put(cst.q_clp, clp), q_seq=put(cst.q_seq, seq),
        q_nseq=put(cst.q_nseq, nseq), q_ts=put(cst.q_ts, ts),
        q_tx=put(cst.q_tx, tx),
    )


def _writers(cfg, mask, ids=None):
    """The nodes whose writes commit: any node under ``any_writer``, else
    the first ``n_origins`` (``ids``: the rows' global node ids, else
    ``0..N-1``)."""
    if getattr(cfg, "any_writer", False):
        return mask
    if ids is None:
        ids = torch.arange(cfg.n_nodes, device=mask.device)
    return mask & (ids < cfg.n_origins)


def local_write(cfg, cst: CrdtState, write_mask, cell, val, clp=None, ids=None):
    """Commit one-cell write transactions at the writer nodes: assign the
    db_version, bump the cell's clock, apply locally, record, queue for
    broadcast. Through the ingest kernel where :func:`kernel_ingest`, else
    the plain body. ``ids``: the rows' global node ids (a mesh shard's),
    else ``0..N-1``."""
    if kernel_ingest(cfg):
        from corrosion_tpu_torch.ops import megakernel

        return megakernel.local_write_fused(cfg, cst, write_mask, cell, val, clp,
                                            ids=ids)
    n = write_mask.shape[0]
    dev = write_mask.device
    iarr = torch.arange(n, dtype=torch.int32, device=dev) if ids is None else ids
    w = _writers(cfg, write_mask, ids)
    if clp is None:
        clp = torch.zeros(n, dtype=torch.int32, device=dev)
    dbv = cst.next_dbv
    ver = lookup_cols(cst.store[0], cell[:, None])[:, 0] + 1
    ts, hlc = hlc_tick(cst.hlc, cst.now, w)
    col = lambda v: v[:, None]  # noqa: E731
    store = apply_changes(cst.store, col(cell), col(ver), col(val), col(iarr),
                          col(dbv), col(clp), col(w))
    book, _, _ = record_versions(cst.book, col(iarr), col(dbv), col(w),
                                 now=cst.now, keep_rounds=cfg.org_keep_rounds)
    cst = cst._replace(store=store, book=book, hlc=hlc,
                       next_dbv=torch.where(w, dbv + 1, cst.next_dbv))
    ones = torch.ones((n, 1), dtype=torch.int32, device=dev)
    return _enqueue(cst, col(w), col(iarr), col(dbv), col(cell), col(ver),
                    col(val), col(iarr), col(clp), ones - 1, ones, col(ts),
                    ones * cfg.bcast_max_transmissions)


def local_write_tx(cfg, cst: CrdtState, tx_mask, tx_cell, tx_val, tx_clp, tx_len,
                   ids=None):
    """Commit multi-cell write transactions: ``tx_cell``/``tx_val``/``tx_clp``
    int32 [N, K] (K <= ``tx_max_cells``), ``tx_len`` [N] real lanes. The
    cells share one db_version and one HLC stamp, carry seq 0..len-1, apply
    atomically to the writer's store (the batch's LWW max where a cell
    repeats) and queue one chunk each (``ids``: as :func:`local_write`)."""
    n, k = tx_cell.shape
    if k > max(1, cfg.tx_max_cells):
        raise ValueError(
            f"tx_cell has {k} lanes > tx_max_cells {max(1, cfg.tx_max_cells)}")
    dev = tx_mask.device
    i32 = torch.int32
    w = _writers(cfg, tx_mask, ids)
    lane = torch.arange(k, dtype=i32, device=dev)[None, :].expand(n, k)
    lane_ok = w[:, None] & (lane < tx_len[:, None])
    dbv = cst.next_dbv
    ver = lookup_cols(cst.store[0], tx_cell) + 1
    site = (torch.arange(n, dtype=i32, device=dev) if ids is None
            else ids)[:, None].expand(n, k)
    ts, hlc = hlc_tick(cst.hlc, cst.now, w)
    wide = lambda v: v[:, None].expand(n, k)  # noqa: E731
    store = apply_changes(cst.store, tx_cell, ver, tx_val, site, wide(dbv),
                          tx_clp, lane_ok)
    book, _, _ = record_versions(cst.book, site[:, :1], dbv[:, None], w[:, None],
                                 now=cst.now, keep_rounds=cfg.org_keep_rounds)
    cst = cst._replace(store=store, book=book, hlc=hlc,
                       next_dbv=torch.where(w, dbv + 1, cst.next_dbv))
    return _enqueue(cst, lane_ok, site, wide(dbv), tx_cell, ver, tx_val, site,
                    tx_clp, lane, wide(tx_len), wide(ts),
                    torch.full((n, k), cfg.bcast_max_transmissions, dtype=i32,
                               device=dev))


def _dead_column(live, fields):
    """An empty batch (M = 0) as one message that is not live: the
    reductions over the message axis then have an element, and the result
    is the empty batch's."""
    if live.shape[1]:
        return live, fields
    return (torch.zeros((live.shape[0], 1), dtype=torch.bool, device=live.device),
            [f.new_zeros((f.shape[0], 1)) for f in fields])


def ingest_changes(cfg, cst: CrdtState, live, m_origin, m_dbv, m_cell, m_ver,
                   m_val, m_site, m_clp, m_seq=None, m_nseq=None, m_ts=None,
                   m_tx=None):
    """Receiver ingest of per-row message batches [N, M]: fold the HLC
    stamps (dropping those too far ahead), dedupe via the Book, apply fresh
    single-cell versions, buffer the cells of chunked versions
    (``nseq > 1``) and apply each version whole once its seq range is
    complete, re-enqueue recorded changes (and fresh fragments of owned
    actors) for re-broadcast. Under ``bcast_wire_budget`` with the wire lane
    ``m_tx``, unowned fresh messages re-enqueue at the incoming budget minus
    one. Through the ingest kernel where :func:`kernel_ingest` (the chunking
    stamps are then all single-cell), else the plain body. Returns
    ``(cst, info)``."""
    if m_seq is None:
        m_seq = torch.zeros_like(m_origin)
    if m_nseq is None:
        m_nseq = torch.ones_like(m_origin)
    if m_ts is None:
        m_ts = torch.zeros_like(m_origin)
    if kernel_ingest(cfg):
        from corrosion_tpu_torch.ops import megakernel

        return megakernel.ingest_changes_fused(
            cfg, cst, live, m_origin, m_dbv, m_cell, m_ver, m_val, m_site,
            m_clp, m_ts)
    wire = m_tx is not None and getattr(cfg, "bcast_wire_budget", False)
    fields = [m_origin, m_dbv, m_cell, m_ver, m_val, m_site, m_clp, m_seq,
              m_nseq, m_ts] + ([m_tx] if wire else [])
    live, fields = _dead_column(live, fields)
    (m_origin, m_dbv, m_cell, m_ver, m_val, m_site, m_clp, m_seq, m_nseq,
     m_ts) = fields[:10]
    n = live.shape[0]
    keep = cfg.org_keep_rounds
    re_max = max(1, cfg.bcast_max_transmissions - 1)
    rebudget = torch.full_like(m_origin, re_max)

    hlc, live, drift_rejects = hlc_fold(cst.hlc, cst.now, m_ts, live)
    cst = cst._replace(hlc=hlc)

    # complete (single-cell) versions: record and apply on arrival
    book, fresh1, rec1 = record_versions(cst.book, m_origin, m_dbv,
                                         live & (m_nseq <= 1), now=cst.now,
                                         keep_rounds=keep)
    store = apply_changes(cst.store, m_cell, m_ver, m_val, m_site, m_dbv, m_clp, fresh1)
    cst = cst._replace(store=store, book=book)
    fresh, enq, wire_extra = fresh1, rec1, None
    if wire:
        # unowned fresh messages follow the incoming budget down
        wire_next = torch.clamp(fields[10] - 1, 0, re_max)
        wire_extra = fresh1 & ~org_slot(book, m_origin)[1] & (wire_next > 0)
        enq = rec1 | wire_extra
        rebudget = torch.where(wire_extra, wire_next, rebudget)
    completed = torch.zeros((), dtype=torch.int64, device=live.device)
    if cfg.tx_max_cells > 1:
        # chunked versions: buffer, complete, then apply each one whole
        multi = live & (m_nseq > 1)
        seen = seen_versions(cst.book, m_origin, m_dbv, multi)
        book = bump_known_max(cst.book, m_origin, m_dbv, multi)
        par, fresh_m = ingest_partials(cst.partials, multi & ~seen, m_origin,
                                       m_dbv, m_seq, m_nseq, m_cell, m_ver,
                                       m_val, m_site, m_clp)
        full = complete_mask(par)
        p, k = par.cell.shape[1], par.cell.shape[2]
        lane = torch.arange(k, dtype=torch.int32, device=live.device)
        lane_ok = full[:, :, None] & (lane < par.nseq[:, :, None])

        def flat(a):
            return a.reshape(n, p * k)

        store = apply_changes(
            cst.store, flat(par.cell), flat(par.ver), flat(par.val),
            flat(par.site), flat(par.dbv[:, :, None].expand(n, p, k)),
            flat(par.clp), flat(lane_ok))
        book, _, _ = record_versions(book, par.origin, par.dbv, full,
                                     now=cst.now, keep_rounds=keep)
        cst = cst._replace(store=store, book=book, partials=free_slots(par, full))
        fresh = fresh1 | fresh_m
        # a fragment re-broadcasts only where its actor's slot is owned: an
        # unowned one re-buffers fresh on every arrival
        enq = rec1 | (fresh_m & org_slot(book, m_origin)[1])
        if wire_extra is not None:
            enq = enq | wire_extra
        completed = full.sum()

    cst = _enqueue(cst, enq, m_origin, m_dbv, m_cell, m_ver, m_val, m_site,
                   m_clp, m_seq, m_nseq, m_ts, rebudget)
    info = {
        "delivered": live.sum(),
        "fresh": fresh.sum(),
        "tx_completed": completed,
        "clock_drift_rejects": drift_rejects,
        "queued": (cst.q_origin != NO_Q).sum(),
    }
    return cst, info


def bcast_step(cfg, cst: CrdtState, targets, t_ok, alive, net: NetModel, key):
    """One broadcast flush + ingest round of the full view: every node fires
    its sendable queue slots at its ``bcast_fanout`` targets over the lossy
    uni channel, the sender x slot x target messages are packed into
    ``recv_slots``-wide mailboxes per receiver, the senders' budgets burn
    once per flush, and the receivers ingest their mailboxes. Returns
    ``(cst, info)``."""
    n, q, f = cfg.n_nodes, cfg.bcast_queue, cfg.bcast_fanout
    if tuple(targets.shape) != (n, f):
        raise ValueError(
            f"targets shape {tuple(targets.shape)} != ({n}, {f}) "
            f"(n_nodes, bcast_fanout)"
        )
    dev = targets.device

    # sendable slots: queued with budget left, then the per-round send budget
    live_slot = (cst.q_origin != NO_Q) & (cst.q_tx > 0)
    allowed = max(1, cfg.bcast_budget_bytes // (CHANGE_WIRE_BYTES * max(1, f)))
    live_slot = budget_mask(live_slot, cst.q_tx, allowed)

    # messages: sender x slot x target
    src = torch.arange(n, dtype=torch.int32, device=dev)[:, None, None].expand(n, q, f)
    dst = targets[:, None, :].expand(n, q, f)
    m_ok = live_slot[:, :, None] & t_ok[:, None, :] & uni_ok(net, key, alive, src, dst)

    def flat(a):
        return a[:, :, None].expand(n, q, f).reshape(-1)

    live, packed = mailbox_pack(
        dst.reshape(-1), m_ok.reshape(-1), n_rows=n, capacity=cfg.recv_slots,
        fields=tuple(flat(a) for a in (
            cst.q_origin, cst.q_dbv, cst.q_cell, cst.q_ver, cst.q_val,
            cst.q_site, cst.q_clp, cst.q_seq, cst.q_nseq, cst.q_ts)),
    )

    # sender-side budget decrement on the attempt, in the plane dtype; free
    # exhausted slots
    attempted = (live_slot & t_ok.any(dim=1)[:, None]).to(cst.q_tx.dtype)
    q_tx = torch.where(live_slot, cst.q_tx - attempted, cst.q_tx)
    exhausted = (cst.q_origin != NO_Q) & (q_tx <= 0)
    cst = cst._replace(
        q_tx=torch.clamp(q_tx, min=0),
        q_origin=torch.where(exhausted, NO_Q, cst.q_origin),
    )
    cst, info = ingest_changes(cfg, cst, live, *packed)
    return cst, {**info, "sent": m_ok.sum()}
