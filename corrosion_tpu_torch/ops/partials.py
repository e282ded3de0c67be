"""Partial-changeset buffer container (port of the parts of
``corrosion_tpu/ops/partials.py`` the single-cell round carries: the
container, ``free_slots`` and the sync step's ``drop_stale_partials``).
The multi-cell ingest waits for a later slice of the port."""

from __future__ import annotations

from typing import NamedTuple

import torch

from corrosion_tpu_torch.ops.dense import lookup_cols

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
