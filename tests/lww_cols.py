"""The JAX package's column form of the LWW apply (``apply_changes_cols``,
the TPU's form) as the reference for the port's store updates on torch
tensors, and the full four-key ties that tell it from the CPU form.

``apply_changes_cols`` resolves each column alone (a Python loop over the
columns: ~18 s eagerly at 4,096 of them), so it runs here on the columns
the batch addresses, and every other column keeps its incumbent."""

import numpy as np
import torch

from corrosion_tpu.ops.lww import apply_changes_cols


def cols_reference(store, cell, ver, val, site, dbv, clp, valid):
    """``apply_changes_cols`` over ``store`` (five [N, C] int32 tensors) and
    the [N, M] messages, as numpy planes."""
    planes = [t.numpy() for t in store]
    c = planes[0].shape[1]
    msg = [t.numpy() for t in (ver, val, site, dbv, clp)]
    cell, valid = cell.numpy(), valid.numpy()
    on = valid & (cell >= 0) & (cell < c)
    cols = np.unique(cell[on])
    local = np.where(on, np.searchsorted(cols, np.clip(cell, 0, c - 1)), -1).astype(np.int32)
    got = apply_changes_cols(tuple(p[:, cols] for p in planes), local, *msg, on)
    out = [p.copy() for p in planes]
    for dst, g in zip(out, got):
        dst[:, cols] = np.asarray(g)
    return out


def four_key_ties(cell, ver, val, site, dbv, clp, valid, past: int = 0) -> int:
    """Rows with a cell at or past ``past`` that two valid messages address
    with equal ``(clp, ver, val, site)`` and different versions (the ties on
    which the CPU form keeps the first message's version and the column
    form the largest)."""
    n, m = cell.shape
    key = torch.stack([cell, clp, ver, val, site], dim=2)
    same = (key[:, :, None, :] == key[:, None, :, :]).all(dim=3)
    other = dbv[:, :, None] != dbv[:, None, :]
    both = valid[:, :, None] & valid[:, None, :] & (cell >= past)[:, :, None]
    return int((same & other & both).any(dim=2).any(dim=1).sum())
