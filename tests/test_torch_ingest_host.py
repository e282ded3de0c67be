"""The ingest kernel's CUDA source (corrosion_tpu_torch/csrc/ingest.cu) run
on the CPU: compiled with the host compiler against the stand-in runtime in
tests/cuda_host/ (a warp's lanes as fibers of one thread that meet at its
collectives),
launched through the wrapper's own argument packing, and held bitwise
against the plain version, ``ingest_plain``, in every form the paths run,
on the random and the tie-heavy inputs that ``chip_smoke.py`` holds the
card to (fewer rows: N = 61, a partial last block of rows), and in every
other instantiation of the wide rows (8 cells a lane) on the tie-heavy
inputs.

This checks the kernel's lane logic (ranks, ties, chunked batches, the
per-warp shared memory) and that no collective diverges; it says nothing
of the card's speed, and only ``chip_smoke.py`` runs the kernel on the card.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from corrosion_tpu_torch.ops import megakernel as mk
from corrosion_tpu_torch.sim.config import full_view_config
from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config
from corrosion_tpu_torch.testing import cluster_config
from cuda_host import host_build

N_ROWS = 61



def _wide(q_slots: int, **dtypes):
    """The widths ``_ingest_inputs`` reads, for a 144-cell row (36x4, the
    kernel's 8 cells a lane) at the scale round's other widths, ``q_slots``
    queue slots (32: one slot a lane, 64: two) and the full view's 96
    mailboxes, so that one shape runs every form."""
    cfg = scale_sim_config(100_000, n_rows=36, bcast_queue=q_slots, **dtypes)
    widths = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return SimpleNamespace(**widths, n_cells=cfg.n_cells, recv_slots=96)


CONFIGS = {
    "flagship": lambda: scale_sim_config(100_000),
    "wide": lambda: scale_sim_config(100_000, narrow_dtypes=False),
    "million": lambda: million_config(1_000_000),
    "full": lambda: full_view_config(8192),
    # the overload bench's rig: 36x4 = 144 cells a row, the kernel's wide
    # rows (8 cells a lane)
    "overload": lambda: cluster_config(n_rows=36).sim_config(),
    # every other instantiation at 8 cells a lane: each plane-dtype pair x
    # one or two queue slots a lane x the emitting, the narrow and the
    # wide (m > 32) non-emitting batch
    "wide16_q32": lambda: _wide(32),
    "wide16_q64": lambda: _wide(64),
    "wide8_q32": lambda: _wide(32, narrow_q_int8=True),
    "wide8_q64": lambda: _wide(64, narrow_q_int8=True),
    "wide32_q32": lambda: _wide(32, narrow_dtypes=False),
    "wide32_q64": lambda: _wide(64, narrow_dtypes=False),
}
# (configuration, form): every form of chip_smoke.py's kernels phase
FORMS = [("flagship", "receive"), ("flagship", "write_emit"), ("flagship", "write"),
         ("million", "receive"), ("million", "write_emit"), ("million", "write"),
         ("full", "receive_full"), ("full", "write"),
         ("wide", "receive"), ("wide", "write"), ("wide", "write_emit"),
         ("overload", "receive"), ("overload", "write_emit")]
# the other wide-row instantiations, on the tie-heavy inputs only
WIDE_FORMS = [("wide16_q32", "receive_full"),
              *[(c, f) for c in ("wide16_q64", "wide8_q32", "wide8_q64", "wide32_q32",
                                 "wide32_q64")
                for f in ("receive", "write_emit", "receive_full")]]
CASES = [(c, f, ties) for c, f in FORMS for ties in (False, True)] + [
    (c, f, True) for c, f in WIDE_FORMS]


@pytest.fixture(scope="module")
def host_ingest(tmp_path_factory):
    """The ingest library built for the host, loaded with ctypes."""
    return host_build.build("ingest", tmp_path_factory.mktemp("ingest_host"))


@pytest.mark.parametrize("config,form,ties", CASES, ids=[
    f"{c}-{f}-{'tie_heavy' if t else 'random'}" for c, f, t in CASES])
def test_ingest_source_on_host_matches_plain(host_ingest, monkeypatch, config, form, ties):
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = CONFIGS[config]()
    p, x = chip_smoke._ingest_inputs(cfg, N_ROWS, form, 3 + 7 * ties, "cpu", ties=ties)
    got, want = mk._ingest_cuda(p, x), mk.ingest_plain(p, x)
    for name, a, b in zip(want._fields, got, want):
        for u, v in zip(chip_smoke._flat(a), chip_smoke._flat(b)):
            assert u.dtype == v.dtype and torch.equal(u, v), name
    assert int(want.fresh.sum()) > 0
