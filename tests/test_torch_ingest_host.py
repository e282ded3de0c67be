"""The ingest kernel's CUDA source (corrosion_tpu_torch/csrc/ingest.cu) run
on the CPU: compiled with the host compiler against the stand-in runtime in
tests/cuda_host/ (a warp's lanes as threads, its collectives at a barrier),
launched through the wrapper's own argument packing, and held bitwise
against the plain version, ``ingest_plain``, in every form the paths run,
on the random and the tie-heavy inputs that ``chip_smoke.py`` holds the
card to (fewer rows: N = 61, a partial last block of rows).

This checks the kernel's lane logic (ranks, ties, chunked batches, the
per-warp shared memory) and that no collective diverges; it says nothing
of the card's speed, and only ``chip_smoke.py`` runs the kernel on the card.
"""

import pytest
import torch

import chip_smoke
from corrosion_tpu_torch.ops import megakernel as mk
from corrosion_tpu_torch.sim.config import full_view_config
from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config
from cuda_host import host_build

N_ROWS = 61

CONFIGS = {
    "flagship": lambda: scale_sim_config(100_000),
    "wide": lambda: scale_sim_config(100_000, narrow_dtypes=False),
    "million": lambda: million_config(1_000_000),
    "full": lambda: full_view_config(8192),
}
# (configuration, form): every form of chip_smoke.py's kernels phase
FORMS = [("flagship", "receive"), ("flagship", "write_emit"), ("flagship", "write"),
         ("million", "receive"), ("million", "write_emit"), ("million", "write"),
         ("full", "receive_full"), ("full", "write"),
         ("wide", "receive"), ("wide", "write"), ("wide", "write_emit")]


@pytest.fixture(scope="module")
def host_ingest(tmp_path_factory):
    """The ingest library built for the host, loaded with ctypes."""
    return host_build.build("ingest", tmp_path_factory.mktemp("ingest_host"))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie_heavy"])
@pytest.mark.parametrize("config,form", FORMS, ids=[f"{c}-{f}" for c, f in FORMS])
def test_ingest_source_on_host_matches_plain(host_ingest, monkeypatch, config, form, ties):
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = CONFIGS[config]()
    p, x = chip_smoke._ingest_inputs(cfg, N_ROWS, form, 3 + 7 * ties, "cpu", ties=ties)
    got, want = mk._ingest_cuda(p, x), mk.ingest_plain(p, x)
    for name, a, b in zip(want._fields, got, want):
        for u, v in zip(chip_smoke._flat(a), chip_smoke._flat(b)):
            assert u.dtype == v.dtype and torch.equal(u, v), name
    assert int(want.fresh.sum()) > 0
