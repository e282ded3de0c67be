"""The ingest kernel's CUDA source (corrosion_tpu_torch/csrc/ingest.cu) run
on the CPU: compiled with the host compiler against the stand-in runtime in
tests/cuda_host/ (a warp's lanes as fibers of one thread that meet at its
collectives),
launched through the wrapper's own argument packing, and held bitwise
against the plain version, ``ingest_plain``, in every form the paths run,
on the random and the tie-heavy inputs that ``chip_smoke.py`` holds the
card to (fewer rows: N = 61, a partial last block of rows), in every
other instantiation of the wide rows (8 cells a lane) on the tie-heavy
inputs, in every instantiation of the row kept in global memory (more
than 256 cells: 4,096, 4,100 and 32,767), in every instantiation of the
deep form (more than 64 queue slots or 4 seen words, up to 128 and 8,
and up to 32 payload picks), in a covering set of the long form's
(more than 128 messages or 32 picks, up to 512 and 128), and in a covering
set of the global book's (more than 256 origins: 257, 1,024 and 4,099).

This checks the kernel's lane logic (ranks, ties, chunked batches, the
per-warp shared memory) and that no collective diverges; it says nothing
of the card's speed, and only ``chip_smoke.py`` runs the kernel on the card.
"""

import ctypes
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu_torch.ops import megakernel as mk
from corrosion_tpu_torch.sim.config import full_view_config
from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config
from corrosion_tpu_torch.testing import cluster_config
from cuda_host import host_build
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N_ROWS = 61
# the full view's 96-message mailbox past 256 cells, in every instantiation:
# fewer rows (still a partial last block at 4 and at 2 rows a block), since
# its O(m) lane loops are the stand-in's slowest form
N_ROWS_TABLE_MAILBOX = 13



def _wide(q_slots: int, n_rows: int = 36, **over):
    """The widths ``_ingest_inputs`` reads, for an ``n_rows`` x 4 row (36:
    144 cells, the kernel's 8 cells a lane; 1024 and 1025: 4,096 and 4,100
    cells, past its staged 256, the latter a partial last group of 32) at
    the scale round's other widths, ``q_slots`` queue slots (32: one slot a
    lane, 64: two), ``over`` (plane dtypes, ``n_origins``) and the full
    view's 96 mailboxes, so that one shape runs every form."""
    cfg = scale_sim_config(100_000, n_rows=n_rows, bcast_queue=q_slots, **over)
    widths = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return SimpleNamespace(**widths, n_cells=cfg.n_cells, recv_slots=96)


# the row in global memory (more than 256 cells): each plane-dtype pair x
# one or two queue slots a lane x the register book and 256 origins, at
# 4,096 or 4,100 cells; (name, q_slots, n_rows, n_origins, dtype overrides)
TABLES = [
    (f"table{bits}_q{q}_o{o}", q, 1025 if (q == 64) != (o == 256) else 1024, o, over)
    for bits, over in (("16", {}), ("8", dict(narrow_q_int8=True)),
                       ("32", dict(narrow_dtypes=False)))
    for q in (32, 64) for o in (16, 256)
]


# the deep form (4 queue slots a lane, up to 8 seen words): each plane-dtype
# pair x the register book at 64, 144 and 4,096 (or 4,100) cells and the
# wide book at 256 (256 or 48 origins) and 4,096 cells; at the full widths
# (Q = 128, W = 8, R = 32: buf_slots 256, 32 changes a packet, a receive
# of 128 messages) or partial ones (Q = 100, W = 7, R = 17: a receive of
# 68), and where the deep form runs for one axis alone, Q = 48 with W = 8
# or Q = 128 with W = 1. (name, n_rows, n_origins, q_slots, buf_slots,
# pig_changes, dtype overrides)
FULL_DEEP, PART_DEEP = (128, 256, 32), (100, 200, 17)
DEEP = [
    (f"deep{bits}_{book}", rows, o, *widths, over)
    for bits, over in (("16", {}), ("8", dict(narrow_q_int8=True)),
                       ("32", dict(narrow_dtypes=False)))
    for book, rows, o, widths in (
        ("c64", 16, 16, (48, 256, 32) if bits == "32" else FULL_DEEP),
        ("c144", 36, 16, PART_DEEP),
        ("c4096", 1025 if bits == "8" else 1024, 16,
         (128, 32, 32) if bits == "16" else FULL_DEEP),
        ("wide_c256", 64, 48 if bits == "8" else 256, FULL_DEEP),
        ("wide_c4096", 1024, 256, PART_DEEP))
]
# fewer rows than N_ROWS (still a partial last block at 4 and at 2 rows a
# block): the deep form's 128-message receive and the long form's up to
# 512 are the stand-in's slowest
N_ROWS_DEEP = 13
# the deep cases held on the random inputs as well: one a dtype pair
DEEP_RANDOM = ("deep16_c64", "deep8_wide_c4096", "deep32_c144")

# the long form (the batch in global memory: past 128 messages, or past 32
# picks), a covering set: each book and cell width (the register book at
# 64, 144 and 4,096 cells, the wide book at 256 and 4,100) with its receive
# and its emitting write, each plane-dtype pair, a receive past 128 by a
# partial chunk (m = 132, the 33 picks that the register forms refuse), the
# wide packet's (m = 256, 64 picks), the widest (m = 512, 128 picks) and
# queues that the deep form pads (Q = 64, W = 1); (name, n_rows, n_origins,
# q_slots, buf_slots, pig_changes, dtype overrides)
LONG = [
    ("long16_c64", 16, 16, 64, 32, 64, {}),
    ("long8_c144", 36, 16, 33, 32, 33, dict(narrow_q_int8=True)),
    ("long32_c4096", 1024, 16, 128, 256, 64, dict(narrow_dtypes=False)),
    ("long16_wide_c256", 64, 256, 128, 256, 64, {}),
    ("long32_wide_c256", 64, 256, 128, 256, 128, dict(narrow_dtypes=False)),
    ("long8_wide_c4100", 1025, 256, 100, 200, 40, dict(narrow_q_int8=True)),
]


# the global book (more than 256 origins, the book row in global memory), a
# covering set: each cell width (8 cells a lane, the row in global memory),
# queue form (QH 1, 2 and 4), batch form (m <= 32 with and without EMIT,
# m <= 128, the long form) and plane-dtype pair, at 257 (one slot past the
# staged 256), 1,024 and 4,099 (off the 32-slot grid) origins; (name,
# n_rows, n_origins, q_slots, buf_slots, pig_changes, dtype overrides)
GLOBAL = [
    ("global16_o1024", 64, 1024, 32, 32, 4, {}),
    ("global8_o257_c4096", 1024, 257, 64, 32, 4, dict(narrow_q_int8=True)),
    ("global32_o4099_deep", 64, 4099, 128, 256, 32, dict(narrow_dtypes=False)),
    ("global16_o1024_long_c4096", 1024, 1024, 128, 256, 64, {}),
    ("global8_o1024_m64", 64, 1024, 32, 32, 16, dict(narrow_q_int8=True)),
    ("global32_o257_m64_c4096", 1024, 257, 64, 32, 16, dict(narrow_dtypes=False)),
]


def _deep(n_rows, n_origins, q_slots, buf_slots, pig_changes, **over):
    return scale_sim_config(100_000, n_rows=n_rows, n_cols=4, n_origins=n_origins,
                            bcast_queue=q_slots, buf_slots=buf_slots,
                            pig_changes=pig_changes, **over)


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
    # the wide book (more than 32 origins, the book in shared memory): the
    # many-writer flagship (256 origins, 64x4 cells, int16/int16), 48 origins
    # (not a multiple of 32) at int16/int8 and the full view's mailbox at 64
    # origins (int32/int32)
    "writers": lambda: scale_sim_config(100_000, n_origins=256, n_rows=64),
    "writers48_q8": lambda: scale_sim_config(100_000, n_origins=48, narrow_q_int8=True),
    "full_o64": lambda: full_view_config(8192, n_origins=64),
    **{name: (lambda q=q, r=r, o=o, over=over: _wide(q, r, n_origins=o, **over))
       for name, q, r, o, over in TABLES},
    **{name: (lambda a=(r, o, q, b, pig), over=over: _deep(*a, **over))
       for name, r, o, q, b, pig, over in DEEP + LONG + GLOBAL},
    # the full view's mailbox at recv_slots = 256 (int32/int32, Q = 64)
    "long_full_m256": lambda: full_view_config(8192, recv_slots=256),
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
# the wide book's forms, on the random and the tie-heavy inputs
WIDE_BOOK_FORMS = [(c, f) for c in ("writers", "writers48_q8")
                   for f in ("receive", "write", "write_emit")] + [("full_o64", "receive_full")]
# the row in global memory: on the tie-heavy inputs every instantiation
# (receive, emitting write and the full view's 96-message mailbox in each
# of TABLES); on the random inputs as well, a set that takes each dtype
# pair, queue width and book at least once; and two non-emitting writes
TABLE_RANDOM = ("table16_q32_o16", "table8_q64_o256", "table32_q32_o256")
TABLE_FORMS = [(name, f) for name in TABLE_RANDOM for f in ("receive", "write_emit")] + [
    ("table16_q32_o16", "write"), ("table8_q64_o256", "write"),
    ("table16_q32_o16", "receive_full"), ("table32_q64_o256", "receive_full")]
# the deep form: every instantiation (the receive of more than 32 messages,
# the emitting and the non-emitting write in each of DEEP) on the tie-heavy
# inputs, DEEP_RANDOM's on the random ones too
DEEP_FORMS = [(name, f) for name, *_ in DEEP for f in ("receive", "write_emit", "write")]
# the long form: each of LONG's receive and emitting write, and the full
# view's 256-message mailbox, on the random and the tie-heavy inputs
LONG_FORMS = [(name, f) for name, *_ in LONG for f in ("receive", "write_emit")] + [
    ("long_full_m256", "receive_full")]
# the global book: each of GLOBAL's receive, emitting write and
# non-emitting write, on the random and the tie-heavy inputs
GLOBAL_FORMS = [(name, f) for name, *_ in GLOBAL for f in ("receive", "write_emit", "write")]
CASES = [(c, f, ties) for c, f in FORMS + WIDE_BOOK_FORMS + TABLE_FORMS + LONG_FORMS
         + GLOBAL_FORMS for ties in (False, True)] + [(c, f, True) for c, f in WIDE_FORMS] + [
    (name, f, True) for name, *_ in TABLES for f in ("receive", "write_emit", "receive_full")
    if (name, f) not in TABLE_FORMS] + [
    (c, f, ties) for c, f in DEEP_FORMS for ties in (False, True)
    if ties or c in DEEP_RANDOM]


def _rows(config, form, cfg) -> int:
    """The rows a case runs at: fewer for the stand-in's slowest forms (the
    full view's mailbox past 256 cells; the long form's batches, the deep
    form's receive of up to 128 messages and the global book's receives of
    more than 32), N_ROWS for the rest (the deep form's one-message writes
    too, whose few messages need the rows to reach the book's slots past
    32)."""
    if form == "receive_full" and config.startswith("table"):
        return N_ROWS_TABLE_MAILBOX
    if config.startswith("long") or (form.startswith("receive") and (
            config.startswith("deep")
            or (config.startswith("global") and 4 * cfg.pig_changes > 32))):
        return N_ROWS_DEEP
    return N_ROWS


@pytest.fixture(scope="module")
def host_ingest(tmp_path_factory):
    """The ingest library built for the host, loaded with ctypes."""
    return host_build.build("ingest", tmp_path_factory.mktemp("ingest_host"))


@pytest.mark.parametrize("config,form,ties", CASES, ids=[
    f"{c}-{f}-{'tie_heavy' if t else 'random'}" for c, f, t in CASES])
def test_ingest_source_on_host_matches_plain(host_ingest, monkeypatch, config, form, ties):
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = CONFIGS[config]()
    p, x = chip_smoke._ingest_inputs(cfg, _rows(config, form, cfg), form, 3 + 7 * ties, "cpu",
                                     ties=ties)
    mk.reset_launches()
    got, want = mk._ingest_cuda(p, x), mk.ingest_plain(p, x)
    for name, a, b in zip(want._fields, got, want):
        for u, v in zip(chip_smoke._flat(a), chip_smoke._flat(b)):
            assert u.dtype == v.dtype and torch.equal(u, v), name
    assert int(want.fresh.sum()) > 0
    if p.n_origins > chip_smoke.NARROW_BOOK:
        rows = chip_smoke._wide_slot_rows(p, x, want)
        assert min(rows.values()) > 0, rows
    if p.n_cells > chip_smoke.STAGED_CELLS:
        assert chip_smoke._past_staged_rows(x, want) > 0
    if config.startswith("deep") or config.endswith("_deep"):
        _check_deep(p, x, want, form, ties)
    if config.startswith("long") or "_long" in config:
        _check_long(p, x, want, form, ties)
    if config.startswith("global"):
        _check_global(p, x, want)


def _check_global(p, x, want):
    """The global book's launch under its form key (``/o{O}``), and rows
    that take, evict and record on the book's slots past the staged 256."""
    (key, label), = mk.FORM_LAUNCHES
    assert key == ("ingest_emit" if p.pig_r else "ingest")
    assert f"/o{p.n_origins}" in label
    rows = chip_smoke._wide_slot_rows(p, x, want, chip_smoke.STAGED_ORIGINS)
    assert min(rows.values()) > 0, rows


def _check_deep(p, x, want, form, ties):
    """The deep form's launch under its form key, and its axes reached:
    the receive places messages past slot 64 and records seen bits past
    word 4 where its widths have them; the random emitting write picks more
    than 16 live slots."""
    (key, label), = mk.FORM_LAUNCHES
    assert key == ("ingest_emit" if p.pig_r else "ingest")
    assert ((f"/q{p.q_slots}" in label) == (p.q_slots > chip_smoke.SHALLOW_QUEUE)
            and (f"/w{p.seen_words}" in label) == (p.seen_words > chip_smoke.SHALLOW_WORDS))
    rows = chip_smoke._deep_rows(p, x, want)
    if form == "receive":
        assert rows["placed"] > 0 or p.q_slots <= chip_smoke.SHALLOW_QUEUE, rows
        assert rows["far_bits"] > 0 or p.seen_words <= chip_smoke.SHALLOW_WORDS, rows
    if form == "write_emit" and not ties:
        assert rows["picks"] > 0, rows


def _check_long(p, x, want, form, ties):
    """The long form's launch under its form key, and its axes reached: a
    receive has fresh messages past 128; duplicates across the 128
    boundary on the tie-heavy inputs (messages repeat up to 8 back) and on
    the random ones where the rows' keys repeat often enough (the register
    book's 64 origins and 40 versions, 256 messages or more); cells won
    past message 128 where 128 messages or more lie past it; the random
    emitting write over 128 queue slots makes more than 32 live picks."""
    (key, label), = mk.FORM_LAUNCHES
    m = x.origin.shape[1]
    assert key == ("ingest_emit" if p.pig_r else "ingest")
    assert (f"/m{m}" in label) == (m > 32) and (f"/r{p.pig_r}" in label) == (p.pig_r > 32)
    rows = chip_smoke._long_rows(p, x, want)
    if form.startswith("receive"):
        assert rows["fresh_past"] > 0, rows
        full = m >= 2 * chip_smoke.REGISTER_MSGS
        if ties or (full and p.n_origins <= chip_smoke.NARROW_BOOK):
            assert rows["cross_dups"] > 0, rows
        if full:
            assert rows["late_winners"] > 0, rows
    if form == "write_emit" and not ties and p.q_slots > chip_smoke.SHALLOW_QUEUE:
        assert rows["picks"] > 0, rows


def test_host_library_reports_256_origins(host_ingest):
    """The shared book's 256 origins, past which the global book runs;
    origins of any form: any count whose seen words the global book's copy
    walks in int32; the register book's one slot a lane up to 32."""
    limits = (ctypes.c_int * 8)()
    assert host_ingest.ingest_limits(limits) == 0
    assert (limits[1], limits[7]) == ((2**31 - 128) // 8, 32)
    assert host_ingest.ingest_staged_origins() == chip_smoke.STAGED_ORIGINS == 256


def test_257_origins_run_bitwise(host_ingest, monkeypatch):
    """257 origins (the shared book's first count refused, and the
    launcher's before the global book): bitwise equal to the plain version
    under the global book's key, with rows taking, evicting and recording
    on slot 256."""
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = scale_sim_config(100_000, n_origins=257, n_rows=64)
    p, x = chip_smoke._ingest_inputs(cfg, N_ROWS, "receive", 5, "cpu")
    mk.reset_launches()
    got, want = mk._ingest_cuda(p, x), mk.ingest_plain(p, x)
    for name, a, b in zip(want._fields, got, want):
        for u, v in zip(chip_smoke._flat(a), chip_smoke._flat(b)):
            assert u.dtype == v.dtype and torch.equal(u, v), name
    assert mk.FORM_LAUNCHES == {("ingest", "16/16/o257"): 1}
    rows = chip_smoke._wide_slot_rows(p, x, want, chip_smoke.STAGED_ORIGINS)
    assert min(rows.values()) > 0, rows


@pytest.mark.parametrize("o", [0, (2**31 - 128) // 8 + 1], ids=["o0", "past_int32_copy"])
def test_invalid_origins_raise_with_the_widths(host_ingest, monkeypatch, o):
    """No origins, or more than the global book's copy walks in int32: the
    wrapper raises with the widths named, and the launcher refuses them
    too (the count is refused before the rows are looked at)."""
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = scale_sim_config(100_000, n_rows=64)
    p, x = chip_smoke._ingest_inputs(cfg, N_ROWS, "receive", 5, "cpu")
    with pytest.raises(ValueError, match=rf"ingest widths m=16 O={o} W=1 Q=32 R=0 C=256 "
                                         r"exceed the kernel's limits \[512, "):
        mk._ingest_cuda(p._replace(n_origins=o), x)
    a = mk._IngestArgs(m=16, n_origins=o, n_cells=256, q_slots=32, seen_words=1)
    invalid_value = 1
    assert host_ingest.ingest_launch(ctypes.byref(a), 2, 2, 0, None) == invalid_value
    a.n_origins = 257
    assert host_ingest.ingest_launch(ctypes.byref(a), 2, 2, 0, None) == 0


def test_host_library_reports_the_deep_limits(host_ingest):
    """Seen words, queue slots and payload picks: up to 8, 128 and 128 in
    all; the shallow forms hold up to 4 words and 64 slots."""
    limits = (ctypes.c_int * 8)()
    assert host_ingest.ingest_limits(limits) == 0
    assert (limits[2], limits[3], limits[4]) == (8, 128, 128)
    shallow = (ctypes.c_int * 2)()
    assert host_ingest.ingest_shallow_limits(shallow) == 0
    assert tuple(shallow) == (chip_smoke.SHALLOW_WORDS, chip_smoke.SHALLOW_QUEUE)


def test_host_library_reports_the_long_limits(host_ingest):
    """Messages and payload picks of any form: up to 512 and 128; the
    register batch holds up to 128 messages and one pick a lane up to 32
    (past either the long form runs)."""
    limits = (ctypes.c_int * 8)()
    assert host_ingest.ingest_limits(limits) == 0
    assert (limits[0], limits[4], limits[5]) == (512, 128, 32)
    long_limits = (ctypes.c_int * 2)()
    assert host_ingest.ingest_long_limits(long_limits) == 0
    assert tuple(long_limits) == (chip_smoke.REGISTER_MSGS, chip_smoke.ONE_PICK)


# the widths the register forms refused (33 changes a packet: a receive of
# 132 messages, a payload of 33 picks), now the long form's
PAST_REGISTERS = [
    (dict(pig_changes=33, bcast_queue=33), "receive", "16/16/m132"),
    (dict(pig_changes=33, bcast_queue=33), "write_emit", "16/16/r33"),
]


@pytest.mark.parametrize("over,form,label", PAST_REGISTERS, ids=["m132", "r33"])
def test_widths_past_the_register_forms_run_bitwise(host_ingest, monkeypatch, over, form,
                                                    label):
    """A receive of 132 messages and a payload of 33 picks (the register
    forms' first widths refused, and the launcher's before the long form):
    bitwise equal to the plain version under the long form's key."""
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = scale_sim_config(100_000, **over)
    p, x = chip_smoke._ingest_inputs(cfg, N_ROWS_DEEP, form, 19, "cpu")
    mk.reset_launches()
    got, want = mk._ingest_cuda(p, x), mk.ingest_plain(p, x)
    for name, a, b in zip(want._fields, got, want):
        for u, v in zip(chip_smoke._flat(a), chip_smoke._flat(b)):
            assert u.dtype == v.dtype and torch.equal(u, v), name
    assert mk.FORM_LAUNCHES == {("ingest_emit" if p.pig_r else "ingest", label): 1}


# widths past the deep and the long forms: (overrides, form, the wrapper's message)
PAST_DEEP = [
    (dict(bcast_queue=129), "receive", "m=16 O=16 W=1 Q=129 R=0 C=64"),
    (dict(buf_slots=288), "write_emit", "m=1 O=16 W=9 Q=32 R=4 C=64"),
]


@pytest.mark.parametrize("over,form,widths", PAST_DEEP, ids=["q129", "w9"])
def test_widths_past_the_deep_form_raise(host_ingest, monkeypatch, over, form, widths):
    """129 queue slots or 9 seen words: the wrapper raises with the widths
    named, and the launcher refuses them too."""
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = scale_sim_config(100_000, **over)
    p, x = chip_smoke._ingest_inputs(cfg, N_ROWS_DEEP, form, 19, "cpu")
    with pytest.raises(ValueError, match=rf"ingest widths {widths} exceed the kernel's "
                                         rf"limits \[512, 268435440, 8, 128, 128, 32,"):
        mk._ingest_cuda(p, x)
    a = mk._IngestArgs(m=x.origin.shape[1], n_origins=p.n_origins, n_cells=p.n_cells,
                       q_slots=p.q_slots, seen_words=p.seen_words, pig_r=p.pig_r)
    invalid_value = 1
    assert host_ingest.ingest_launch(ctypes.byref(a), 2, 2, int(p.pig_r > 0), None) == \
        invalid_value


def test_513_messages_raise_with_the_widths(host_ingest, monkeypatch):
    """A mailbox of 513 messages, past the long form's 512: the wrapper
    raises with the widths named, and the launcher refuses them too."""
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = full_view_config(8192, recv_slots=513)
    p, x = chip_smoke._ingest_inputs(cfg, 3, "receive_full", 23, "cpu")
    with pytest.raises(ValueError, match=r"ingest widths m=513 O=16 W=2 Q=64 R=0 C=64 "
                                         r"exceed the kernel's limits \[512, "):
        mk._ingest_cuda(p, x)
    a = mk._IngestArgs(m=513, n_origins=16, n_cells=64, q_slots=64, seen_words=2)
    invalid_value = 1
    assert host_ingest.ingest_launch(ctypes.byref(a), 4, 4, 0, None) == invalid_value


def test_staged_cells_and_the_cell_limit(host_ingest):
    """Rows of up to 256 cells are staged in shared memory; the kernel takes
    any wider row (the configuration's own bound is the limit)."""
    limits = (ctypes.c_int * 8)()
    assert host_ingest.ingest_limits(limits) == 0
    assert host_ingest.ingest_staged_cells() == 256
    assert limits[6] >= 2**31 - 128


def test_int16_cell_ceiling_runs_bitwise(host_ingest, monkeypatch):
    """A row of 32,767 cells, the most an int16 ``q_cell`` plane holds
    (``ScaleSimConfig.validate``), through the wrapper: bitwise equal to the
    plain version, with winners past cell 256, under the row's own form key."""
    host_build.route_launches(monkeypatch, host_ingest)
    cfg = scale_sim_config(100_000, n_rows=32767, n_cols=1)
    assert cfg.n_cells == 32767
    p, x = chip_smoke._ingest_inputs(cfg, N_ROWS, "receive", 17, "cpu")
    mk.reset_launches()
    got, want = mk._ingest_cuda(p, x), mk.ingest_plain(p, x)
    for name, a, b in zip(want._fields, got, want):
        for u, v in zip(chip_smoke._flat(a), chip_smoke._flat(b)):
            assert u.dtype == v.dtype and torch.equal(u, v), name
    assert chip_smoke._past_staged_rows(x, want) > 0
    assert mk.FORM_LAUNCHES == {("ingest", "16/16/c32767"): 1}


@pytest.mark.parametrize("seed", (101, 102))
def test_four_key_ties_past_256_cells_take_the_column_form(host_ingest, monkeypatch, seed):
    """The row in global memory (CH = 0, 4,096 cells) on messages that tie
    on ``(clp, ver, val, site)`` with other versions past cell 256: bitwise
    equal to the plain version, and its store equal to the JAX package's
    column form (``apply_changes_cols``: the largest version among the
    tied) on the batch's fresh messages."""
    from lww_cols import cols_reference, four_key_ties

    host_build.route_launches(monkeypatch, host_ingest)
    cfg = scale_sim_config(100_000, n_rows=1024, n_cols=4)
    p, x = chip_smoke._ingest_inputs(cfg, 16, "receive", seed, "cpu", ties=True)
    mk.reset_launches()
    got, want = mk._ingest_cuda(p, x), mk.ingest_plain(p, x)
    for name, a, b in zip(want._fields, got, want):
        for u, v in zip(chip_smoke._flat(a), chip_smoke._flat(b)):
            assert u.dtype == v.dtype and torch.equal(u, v), name
    assert mk.FORM_LAUNCHES == {("ingest", "16/16/c4096"): 1}
    msgs = (x.cell, x.ver, x.val, x.site, x.dbv, x.clp, got.fresh)
    assert four_key_ties(*msgs, past=chip_smoke.STAGED_CELLS) > 0
    for i, (a, b) in enumerate(zip(got.store, cols_reference(x.store, *msgs))):
        assert np.array_equal(a.numpy(), b), i
