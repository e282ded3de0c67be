"""The swim kernel's CUDA source (corrosion_tpu_torch/csrc/swim_tables.cu)
run on the CPU: compiled with the host compiler against the stand-in
runtime in tests/cuda_host/ (a warp's lanes as fibers of one thread that
meet at its collectives), launched through the wrapper's own argument packing, and held
bitwise against the plain version, ``swim_tables_plain``, in every timer /
budget dtype pair of both channel forms at the configurations' m = 64 and
k = 16, at m = 16, 32 and 128 (masked lanes, 1 and 4 columns a lane,
packets wider than a warp), at m = 20, 48 and 96 (the general modulo
of a width that is not a power of two), and in the wide form past 128
slots (chunks of 32 columns, the self slot's chunk first, the packed row
staged in the output planes) at m = 129, 160, 200, 256 and 1024, on the random and the tie-heavy inputs that
``chip_smoke.py`` holds the card to (fewer rows: N = 61, a partial last
block of rows).

This checks the kernel's lane logic (the ranked packed merge, the
row-addressed steps on the owning lane, the masked columns, the wide
form's chunk order) and that no
collective diverges; it says nothing of the card's speed, and only
``chip_smoke.py`` runs the kernel on the card.
"""

import pytest
import torch

import chip_smoke
from corrosion_tpu_torch.ops import megakernel as mk
from corrosion_tpu_torch.sim.scale_step import scale_sim_config
from cuda_host import host_build
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N_ROWS = 61
I8, I16, I32 = torch.int8, torch.int16, torch.int32
# (m, pig_k, timer dtype, budget dtype): every dtype pair of both forms at
# the configurations' widths, then narrower and wider tables, and widths
# that are not a power of two (the kernel's general modulo)
FORMS = [(64, 0, I16, I8), (64, 0, I16, I16), (64, 0, I32, I32),
         (64, 16, I16, I8), (64, 16, I16, I16), (64, 16, I32, I32),
         (16, 0, I32, I32), (16, 16, I16, I8), (32, 0, I16, I16), (32, 8, I32, I32),
         (128, 0, I16, I8), (128, 40, I16, I16), (128, 128, I16, I8),
         (20, 0, I16, I16), (48, 12, I32, I32), (96, 24, I16, I8),
         # the wide form (past 128 slots): one past the register form, a
         # width that is not a power of two in both forms, the wide member
         # table in both forms, a packet of m entries a channel (1,024 a
         # row), and the widest of the card's forms
         (129, 0, I16, I16), (160, 40, I32, I32), (200, 0, I16, I8),
         (256, 0, I16, I8), (256, 16, I16, I8), (256, 256, I16, I16),
         (1024, 0, I32, I32), (1024, 64, I16, I16)]


@pytest.fixture(scope="module")
def host_swim(tmp_path_factory):
    """The swim library built for the host, loaded with ctypes."""
    return host_build.build("swim_tables", tmp_path_factory.mktemp("swim_host"))


def _id(form):
    m, k, tt, xt = form
    return f"m{m}-{'packed' if k else 'aligned'}{k or ''}-{chip_smoke._bits(tt)}_{chip_smoke._bits(xt)}"


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie_heavy"])
@pytest.mark.parametrize("form", FORMS, ids=[_id(f) for f in FORMS])
def test_swim_source_on_host_matches_plain(host_swim, monkeypatch, form, ties):
    host_build.route_launches(monkeypatch, host_swim)
    m, k, tt, xt = form
    cfg = scale_sim_config(100_000)
    consts = (m, cfg.suspicion_rounds, cfg.down_purge_rounds, cfg.max_transmissions, k)
    args = chip_smoke._swim_inputs(N_ROWS, m, tt, 5 + 11 * ties + m + k, "cpu",
                                   tx_dtype=xt, pig_k=k, ties=ties)
    mk.reset_launches()
    got, want = mk._swim_cuda(consts, *args), mk.swim_tables_plain(consts, *args)
    names = ("mem_id", "mem_view", "timer", "mem_tx", "inc", "refute")
    for name, a, b in zip(names, got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # the launch is counted under its form, with the row's width past the
    # register form
    wide = f"/m{m}" if m > chip_smoke.REGISTER_SLOTS else ""
    form = f"{'packed' if k else 'aligned'}/{chip_smoke._bits(tt)}/{chip_smoke._bits(xt)}{wide}"
    assert mk.FORM_LAUNCHES == {("swim_tables", form): 1}
    if ties:
        assert chip_smoke._swim_collisions(args, k) > 0
