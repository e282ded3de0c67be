"""CRDT state, hybrid logical clock, the single-cell write/ingest entry
points and the full view's broadcast flush (port of
``corrosion_tpu/sim/broadcast.py``).

Every node carries an LWW store, version bookkeeping (``Book``) and a
fixed-width queue of changesets awaiting re-broadcast. A local write and a
receiver batch both go through the ingest kernel (``ops/megakernel.py``):
the scale round's piggyback batches and the full view's ``recv_slots``-wide
mailboxes alike.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.ops.partials import Partials
from corrosion_tpu_torch.ops.slots import budget_mask, mailbox_pack
from corrosion_tpu_torch.ops.versions import Book
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


def _single_cell(cfg) -> None:
    if cfg.tx_max_cells > 1:
        raise ValueError(
            "multi-cell transactions (tx_max_cells > 1) are not ported yet "
            "(ROADMAP Queue 1: multi-cell transactions with ops/partials.py ingest)"
        )


def local_write(cfg, cst: CrdtState, write_mask, cell, val, clp=None):
    """Commit one-cell write transactions at the writer nodes, through the
    ingest kernel (apply locally, record, queue for broadcast)."""
    from corrosion_tpu_torch.ops import megakernel

    _single_cell(cfg)
    return megakernel.local_write_fused(cfg, cst, write_mask, cell, val, clp)


def ingest_changes(cfg, cst: CrdtState, live, m_origin, m_dbv, m_cell, m_ver,
                   m_val, m_site, m_clp, m_seq=None, m_nseq=None, m_ts=None):
    """Receiver ingest of single-cell changes through the ingest kernel:
    dedupe via the Book, apply fresh cells, re-enqueue recorded ones.
    ``m_seq``/``m_nseq`` (the chunking stamps) are ignored: every version
    is one cell at ``tx_max_cells == 1``. Returns ``(cst, info)``."""
    from corrosion_tpu_torch.ops import megakernel

    _single_cell(cfg)
    if m_ts is None:
        m_ts = torch.zeros_like(m_origin)
    return megakernel.ingest_changes_fused(
        cfg, cst, live, m_origin, m_dbv, m_cell, m_ver, m_val, m_site, m_clp, m_ts
    )


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
