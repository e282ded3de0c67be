"""Full four-key ties past 256 cells: messages that tie on ``(clp, ver, val,
site)`` but carry different versions, on a 1024x4 = 4,096-cell row. The
JAX package's two LWW forms part there: its CPU form
(``apply_changes_to_store``) keeps the version of the message that its
segment argmax picks, its column form (``apply_changes_cols``, the TPU's)
the largest. The port follows the column form: its ``apply_changes`` and
``ingest_plain``'s store are held bitwise to ``apply_changes_cols`` on the
tie-heavy inputs that ``chip_smoke.py`` holds the card to (each row's
messages on two cells with equal keys, the store's incumbents often tying
them too)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu.ops.lww import apply_changes_to_store
from corrosion_tpu_torch.ops import dense
from corrosion_tpu_torch.ops import megakernel as mk
from corrosion_tpu_torch.sim.scale_step import scale_sim_config
from lww_cols import cols_reference, four_key_ties
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N_ROWS = 16
SEEDS = (101, 102)


def _inputs(seed):
    cfg = scale_sim_config(100_000, n_rows=1024, n_cols=4)
    assert cfg.n_cells == 4096
    return chip_smoke._ingest_inputs(cfg, N_ROWS, "receive", seed, "cpu", ties=True)


def _same(got, want):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert np.array_equal(a.numpy(), b), i


@pytest.mark.parametrize("seed", SEEDS)
def test_apply_changes_takes_the_column_form_on_four_key_ties(seed):
    """The port's ``apply_changes`` at 4,096 cells equals JAX's column form
    on the live messages, which tie on four keys with other versions past
    cell 256; JAX's CPU form differs from both on these inputs."""
    _, x = _inputs(seed)
    msgs = (x.cell, x.ver, x.val, x.site, x.dbv, x.clp, x.live)
    assert four_key_ties(*msgs, past=chip_smoke.STAGED_CELLS) > 0
    want = cols_reference(x.store, *msgs)
    _same(dense.apply_changes(x.store, *msgs), want)
    n, c = x.store[0].shape
    flat = x.cell.numpy() + c * np.arange(n, dtype=np.int32)[:, None]
    valid = x.live.numpy() & (x.cell.numpy() >= 0) & (x.cell.numpy() < c)
    cpu_form = apply_changes_to_store(
        tuple(jnp.asarray(p.numpy().reshape(-1)) for p in x.store), flat.reshape(-1),
        *(jnp.asarray(t.numpy().reshape(-1)) for t in (x.ver, x.val, x.site, x.dbv, x.clp)),
        valid.reshape(-1))
    assert not all(np.array_equal(np.asarray(a).reshape(n, c), b)
                   for a, b in zip(cpu_form, want))


@pytest.mark.parametrize("seed", SEEDS)
def test_ingest_plain_takes_the_column_form_on_four_key_ties(seed):
    """``ingest_plain``'s store at 4,096 cells equals JAX's column form on
    the batch's fresh messages, which tie on four keys with other versions
    past cell 256."""
    p, x = _inputs(seed)
    out = mk.ingest_plain(p, x)
    msgs = (x.cell, x.ver, x.val, x.site, x.dbv, x.clp, out.fresh)
    assert four_key_ties(*msgs, past=chip_smoke.STAGED_CELLS) > 0
    _same(out.store, cols_reference(x.store, *msgs))
    assert not all(torch.equal(a, b) for a, b in zip(out.store, x.store))
