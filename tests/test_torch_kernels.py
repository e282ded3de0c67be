"""The plain versions of the port's kernels (corrosion_tpu_torch/ops/
megakernel.py) against the JAX package's kernels: the pallas kernels in
interpret mode and the XLA path they are pinned equal to. Integer state is
compared exactly (tolerance 0); the pre-drawn uniforms are shared.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each one bitwise against these plain versions there (the ingest kernel's
source also runs on the CPU under a host stand-in runtime,
``tests/test_torch_ingest_host.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import megakernel as jmk
from corrosion_tpu.sim import broadcast as jbroadcast
from corrosion_tpu.sim import scale as jscale
from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.ops import megakernel as mk
from corrosion_tpu_torch.sim import broadcast
from corrosion_tpu_torch.sim import scale_step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)


def T(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def leaves_equal(want, got):
    """Every leaf equal in value, dtype and shape (uint32 seen words
    compared by bit pattern)."""
    w = jax.tree.leaves(convert.as_numpy_tree(want))
    g = jax.tree.leaves(scale_step_tree(got))
    assert len(w) == len(g)
    for i, (a, b) in enumerate(zip(w, g)):
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype)
        assert np.array_equal(a, b), i


def scale_step_tree(x):
    if hasattr(x, "_fields"):
        return {k: scale_step_tree(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (tuple, list)):
        return [scale_step_tree(v) for v in x]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- K1: the SWIM back half ------------------------------------------------

def swim_operands(rng, n, m):
    """Random valid operands of swim_tables_update (after ``consts``)."""
    i32 = np.int32
    iarr = np.arange(n, dtype=i32)
    self_slot = iarr % m
    mem_id = np.where(rng.random((n, m)) < 0.2, -1, rng.integers(0, n, (n, m))).astype(i32)
    own = rng.random(n) < 0.5
    mem_id[iarr[own], self_slot[own]] = iarr[own]
    mem_view = rng.integers(-1, 64, (n, m)).astype(i32)
    old_id = np.where(rng.random((n, m)) < 0.8, mem_id, rng.integers(-1, n, (n, m))).astype(i32)
    old_view = np.where(rng.random((n, m)) < 0.8, mem_view,
                        rng.integers(-1, 64, (n, m))).astype(i32)
    ch = [[], [], [], [], [], []]
    for _ in range(4):
        ch[0].append(np.where(rng.random((n, m)) < 0.5, mem_id,
                              rng.integers(-1, n, (n, m))).astype(i32))
        ch[1].append(rng.integers(-1, 64, (n, m)).astype(i32))
        ch[2].append(rng.random((n, m)) < 0.7)
        ch[3].append(rng.random(n) < 0.8)
        ch[4].append(rng.integers(0, n, n).astype(i32))
        ch[5].append(rng.integers(0, 8, n).astype(i32))
    return (
        mem_id, mem_view, old_id, old_view,
        rng.integers(0, 12, (n, m)).astype(np.int16),
        rng.integers(0, 14, (n, m)).astype(np.int16),
        rng.random(n) < 0.9, rng.integers(0, 8, n).astype(i32), iarr, self_slot,
        rng.integers(-1, 40, n).astype(i32), rng.integers(0, 4, n).astype(i32),
        rng.integers(0, m, n).astype(i32), rng.integers(0, 40, n).astype(i32),
        rng.random(n) < 0.3, *ch,
    )


def _jax_args(ops):
    return tuple([jnp.asarray(x) for x in o] if isinstance(o, list) else jnp.asarray(o)
                 for o in ops)


def _torch_args(ops):
    return tuple([T(x) for x in o] if isinstance(o, list) else T(o) for o in ops)


_swim_ref = jax.jit(jscale.swim_tables_update, static_argnums=0)


# past 128 slots (the CUDA kernel's wide form): a power of two, and a width
# that is not one with a row count off the kernel's blocks of 4 rows
@pytest.mark.parametrize("n,m,seed", [(64, 16, 0), (128, 32, 1), (256, 64, 2),
                                      (200, 64, 3), (64, 256, 4), (61, 200, 5)])
def test_swim_plain_matches_swim_tables_update(n, m, seed):
    ops = swim_operands(np.random.default_rng(seed), n, m)
    consts = (m, 6, 48, 10, 0)
    want = _swim_ref(consts, *_jax_args(ops))
    got = mk.swim_tables_fused(consts, *_torch_args(ops))
    # the XLA form returns mem_tx widened; the store dtype is the plane's
    want = list(want)
    want[3] = want[3].astype(jnp.int16)
    for a, b in zip(want, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("m", [16, 256])
def test_swim_plain_matches_pallas_kernel_interpret(m):
    n = 64
    ops = swim_operands(np.random.default_rng(7), n, m)
    consts = (m, 6, 48, 10, 0)
    want = jmk.swim_tables_fused(consts, *_jax_args(ops), interpret=True)
    got = mk.swim_tables_fused(consts, *_torch_args(ops))
    for a, b in zip(want, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


# --- K2 / K3: ingest -------------------------------------------------------

N_INGEST = 64
# narrow store and queue widths keep the interpret-mode kernels quick; the
# message width stays the flagship's 4 channels x pig_changes
SMALL = dict(n_rows=4, n_cols=4, n_origins=8, bcast_queue=16)


# every tie-heavy message's (ver, val, site, clp); half the store cells
# hold the same keys, so the incumbent ties them
TIE_KEYS = (5, 1, 2, 1)


def random_state(seed, n=N_INGEST, ties=False, next_hi=100, full_p=0.0, q_empty=0.5,
                 **over):
    """A JAX ScaleSimState with a random (valid) CRDT half, and the port's
    copy of it: seen bits in every word of the window (a share ``full_p``
    of the words all ones, so that heads advance across words), a writer's
    next version in [70, ``next_hi``), a share ``q_empty`` of the queue
    slots empty. With ``ties``: queue counters from {1, 2}, and store cells
    that tie the tie-heavy messages' keys."""
    over = {**SMALL, **over}
    cfg = jstep.scale_sim_config(n, **over)
    st = jstep.ScaleSimState.create(cfg)
    rng = np.random.default_rng(seed)
    c, o, q = cfg.n_cells, cfg.n_origins, cfg.bcast_queue
    w = max(1, -(-cfg.buf_slots // 32))
    i32 = np.int32
    now = 20
    head = rng.integers(0, 30, (n, o)).astype(i32)
    seen = np.where(rng.random((n, o, w)) < 0.3, rng.integers(0, 8, (n, o, w)),
                    rng.integers(0, 2**32, (n, o, w))).astype(np.uint32)
    if full_p:
        seen = np.where(rng.random((n, o, w)) < full_p, np.uint32(0xFFFFFFFF), seen)
    store = [rng.integers(0, hi, (n, c)).astype(i32) for hi in (8, 4, 4, 40, 2)]
    book = st.crdt.book._replace(
        head=jnp.asarray(head),
        known_max=jnp.asarray(head + rng.integers(0, 10, (n, o)).astype(i32)),
        seen=jnp.asarray(seen),
        org_id=jnp.asarray(np.where(rng.random((n, o)) < 0.8, np.arange(o),
                                    rng.integers(-1, 64, (n, o))).astype(i32)),
        org_last=jnp.asarray(rng.integers(0, now, (n, o)).astype(i32)),
    )
    # a writer's next version lies past its own head and window
    next_dbv = rng.integers(70, next_hi, n).astype(i32)
    queue = dict(
        q_origin=np.where(rng.random((n, q)) < q_empty, -1,
                          rng.integers(0, 64, (n, q))).astype(i32),
        q_cell=rng.integers(0, c, (n, q)).astype(np.int16),
        q_dbv=rng.integers(0, 40, (n, q)).astype(i32),
        q_ver=rng.integers(0, 8, (n, q)).astype(i32),
        q_val=rng.integers(0, 4, (n, q)).astype(i32),
        q_site=rng.integers(0, 4, (n, q)).astype(i32),
        q_clp=rng.integers(0, 2, (n, q)).astype(i32),
        q_ts=rng.integers(0, now << 10, (n, q)).astype(i32),
        q_tx=rng.integers(0, 4, (n, q)).astype(np.int16),
    )
    hlc = rng.integers(0, now << 10, n).astype(i32)
    if ties:
        # drawn after the random case's draws, so that case's inputs stay
        tie_rng = np.random.default_rng(seed + 1)
        for i, v in zip((0, 1, 2, 4), TIE_KEYS):
            store[i] = np.where(tie_rng.random((n, c)) < 0.5, v, store[i]).astype(i32)
        queue["q_tx"] = tie_rng.integers(1, 3, (n, q)).astype(np.int16)
    crdt = st.crdt._replace(
        store=tuple(jnp.asarray(x) for x in store), book=book,
        next_dbv=jnp.asarray(next_dbv), hlc=jnp.asarray(hlc), now=jnp.int32(now),
        **{k: jnp.asarray(v) for k, v in queue.items()})
    st = st._replace(crdt=crdt)
    tcfg = scale_step.scale_sim_config(n, **{k: v for k, v in over.items() if k != "fused"})
    tst = convert.scale_state_from_numpy(tcfg, convert.as_numpy_tree(st), "cpu")
    return cfg, st, tcfg, tst


def random_messages(seed, n, m, now=20, n_cells=16, o_hi=64, dbv_hi=40):
    rng = np.random.default_rng(seed)
    i32 = np.int32
    live = rng.random((n, m)) < 0.7
    fields = [
        rng.integers(-1, o_hi, (n, m)), rng.integers(0, dbv_hi, (n, m)),
        rng.integers(-1, n_cells + 1, (n, m)), rng.integers(0, 8, (n, m)),
        rng.integers(0, 4, (n, m)), rng.integers(0, 4, (n, m)),
        rng.integers(0, 2, (n, m)),
        rng.integers((now - 3) << 10, (now + 4) << 10, (n, m)),
    ]
    return live, [f.astype(i32) for f in fields]


def two_cells(rng, n, m, n_cells):
    """Each row's messages on two cells (and a few on none)."""
    a = rng.integers(0, n_cells, (n, 1))
    b = (a + rng.integers(1, n_cells, (n, 1))) % n_cells
    cell = np.where(rng.random((n, m)) < 0.5, a, b)
    return np.where(rng.random((n, m)) < 0.05, -1, cell).astype(np.int32)


def tie_messages(seed, n, m, now=20, n_cells=16, o_hi=12, dbv_hi=40):
    """Messages where a lane-parallel rank can part from a sequential loop:
    two cells a row with equal (ver, val, site, clp), repeated (origin, dbv)
    pairs and versions repeated across origins in a row, live and dead."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    live = rng.random((n, m)) < 0.6
    origin = rng.integers(-1, o_hi, (n, m))
    dbv = rng.integers(0, dbv_hi, (n, m))
    idx = np.arange(m)
    back = np.maximum(idx - rng.integers(1, 9, (n, m)), 0)
    rep = (rng.random((n, m)) < 0.3) & (idx > 0)
    origin = np.where(rep, np.take_along_axis(origin, back, 1), origin)
    dbv = np.where(rep, np.take_along_axis(dbv, back, 1), dbv)
    back = np.maximum(idx - rng.integers(1, 9, (n, m)), 0)
    dbv = np.where((rng.random((n, m)) < 0.2) & (idx > 0),
                   np.take_along_axis(dbv, back, 1), dbv)
    ver, val, site, clp = (np.full((n, m), v) for v in TIE_KEYS)
    fields = [origin, dbv, two_cells(rng, n, m, n_cells), ver, val, site, clp,
              rng.integers((now - 3) << 10, (now + 4) << 10, (n, m))]
    return live, [f.astype(i32) for f in fields]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie_heavy"])
def test_ingest_plain_matches_pallas_kernel_interpret(ties):
    cfg, st, tcfg, tst = random_state(0, ties=ties)
    make = tie_messages if ties else random_messages
    live, msgs = make(1, N_INGEST, 4 * cfg.pig_changes)
    want_cst, want_info = jmk.ingest_changes_fused(
        cfg, st.crdt, jnp.asarray(live), *map(jnp.asarray, msgs), interpret=True)
    got_cst, got_info = mk.ingest_changes_fused(tcfg, tst.crdt, T(live), *map(T, msgs))
    leaves_equal(want_cst, got_cst)
    for k in want_info:
        assert int(want_info[k]) == int(got_info[k]), k


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie_heavy"])
def test_local_write_emit_plain_matches_pallas_kernel_interpret(ties):
    """With ``ties``: queue counters from {1, 2}, uniforms on a grid of
    quarters (equal float32 draws), writes on two cells with the tie keys,
    and a payload budget of three changes, so that the budget mask ranks."""
    budget = {"bcast_budget_bytes": 3 * broadcast.CHANGE_WIRE_BYTES} if ties else {}
    cfg, st, tcfg, tst = random_state(2, ties=ties, **budget)
    rng = np.random.default_rng(3)
    n, q = N_INGEST, cfg.bcast_queue
    wm = rng.random(n) < 0.6
    cell = rng.integers(0, cfg.n_cells, n).astype(np.int32)
    val = rng.integers(0, 1 << 20, n).astype(np.int32)
    clp = rng.integers(0, 2, n).astype(np.int32)
    rand = rng.random((n, q)).astype(np.float32)
    if ties:
        cell = two_cells(rng, 1, n, cfg.n_cells)[0].clip(min=0)
        val = np.full(n, TIE_KEYS[1], np.int32)
        clp = np.full(n, TIE_KEYS[3], np.int32)
        rand = np.floor(rand * 4) / 4
    carried = rng.integers(0, 5, n).astype(np.int32)
    want_cst, want_emit = jmk.local_write_fused(
        cfg, st.crdt, *map(jnp.asarray, (wm, cell, val, clp)),
        rand=jnp.asarray(rand), carried=jnp.asarray(carried), interpret=True)
    got_cst, got_emit = mk.local_write_fused(
        tcfg, tst.crdt, *map(T, (wm, cell, val, clp)), rand=T(rand), carried=T(carried))
    leaves_equal(want_cst, got_cst)
    for a, b in zip(want_emit, got_emit):
        assert np.array_equal(np.asarray(a), b.numpy())


# past the CUDA kernel's register book of 32 slots, and not a multiple of 32
WIDE_BOOK = dict(n_origins=48)


def _wide_slots_moved(before, after):
    """Some book slot past 32 changed: claimed, recorded or advanced."""
    return any(not torch.equal(getattr(before, f)[:, 32:], getattr(after, f)[:, 32:])
               for f in ("head", "known_max", "seen", "org_id", "org_last"))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie_heavy"])
def test_ingest_plain_matches_pallas_kernel_interpret_48_origins(ties):
    """Origins over all 48 slots and ids 48 apart that meet on one slot."""
    cfg, st, tcfg, tst = random_state(8, ties=ties, **WIDE_BOOK)
    make = tie_messages if ties else random_messages
    live, msgs = make(9, N_INGEST, 4 * cfg.pig_changes, o_hi=96)
    want_cst, want_info = jmk.ingest_changes_fused(
        cfg, st.crdt, jnp.asarray(live), *map(jnp.asarray, msgs), interpret=True)
    got_cst, got_info = mk.ingest_changes_fused(tcfg, tst.crdt, T(live), *map(T, msgs))
    leaves_equal(want_cst, got_cst)
    for k in want_info:
        assert int(want_info[k]) == int(got_info[k]), k
    assert _wide_slots_moved(tst.crdt.book, got_cst.book)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie_heavy"])
def test_local_write_emit_plain_matches_pallas_kernel_interpret_48_origins(ties):
    """Rows 48..63 write on the slots of rows 0..15. Both cases take the
    tie case's payload budget of three changes, so that they share one
    compile of the interpret-mode kernel."""
    budget = {"bcast_budget_bytes": 3 * broadcast.CHANGE_WIRE_BYTES}
    cfg, st, tcfg, tst = random_state(10, ties=ties, **WIDE_BOOK, **budget)
    rng = np.random.default_rng(11)
    n, q = N_INGEST, cfg.bcast_queue
    wm = rng.random(n) < 0.6
    cell = rng.integers(0, cfg.n_cells, n).astype(np.int32)
    val = rng.integers(0, 1 << 20, n).astype(np.int32)
    clp = rng.integers(0, 2, n).astype(np.int32)
    rand = rng.random((n, q)).astype(np.float32)
    if ties:
        cell = two_cells(rng, 1, n, cfg.n_cells)[0].clip(min=0)
        val = np.full(n, TIE_KEYS[1], np.int32)
        clp = np.full(n, TIE_KEYS[3], np.int32)
        rand = np.floor(rand * 4) / 4
    carried = rng.integers(0, 5, n).astype(np.int32)
    want_cst, want_emit = jmk.local_write_fused(
        cfg, st.crdt, *map(jnp.asarray, (wm, cell, val, clp)),
        rand=jnp.asarray(rand), carried=jnp.asarray(carried), interpret=True)
    got_cst, got_emit = mk.local_write_fused(
        tcfg, tst.crdt, *map(T, (wm, cell, val, clp)), rand=T(rand), carried=T(carried))
    leaves_equal(want_cst, got_cst)
    for a, b in zip(want_emit, got_emit):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert _wide_slots_moved(tst.crdt.book, got_cst.book)


# the deep queue's widths (the ingest kernel's deep form on the card): 128
# queue slots, a 256-version window (8 seen words) and 32 changes a packet,
# so a receive batch of 4 x 32 = 128 messages and a payload of 32 picks
DEEP = dict(buf_slots=256, bcast_queue=128, pig_changes=32)
# message and next versions up to ~300 past the heads (0..29): offsets over
# every word of the window and past it
DEEP_DBV = 330


def _deep_moved(before, after):
    """(a slot kept its owner and head and gained a seen bit past word 4,
    a slot kept its owner and its head moved 32 or more: across a word)."""
    kept = before.org_id == after.org_id
    new = (after.seen[:, :, 4:] & ~before.seen[:, :, 4:]) != 0
    same = kept & (after.head == before.head)
    return (bool((same[:, :, None] & new).any()),
            bool((kept & (after.head - before.head >= 32)).any()))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie_heavy"])
def test_ingest_plain_matches_pallas_kernel_interpret_deep_queue(ties):
    """The receive at m = 128 into a 128-slot queue with an 8-word window:
    seen bits set in every word, a fifth of the words all ones, versions up
    to ~300 past the heads, a queue with few empty slots and origins mostly
    on their own slots, so that rows place messages past slot 64. JAX's
    interpret compile at these widths takes about 30 s on the CPU."""
    cfg, st, tcfg, tst = random_state(20, ties=ties, full_p=0.2, q_empty=0.02, **DEEP)
    make = tie_messages if ties else random_messages
    live, msgs = make(21, N_INGEST, 4 * cfg.pig_changes, o_hi=12, dbv_hi=DEEP_DBV)
    assert live.shape[1] == 128 and cfg.bcast_queue == 128
    want_cst, want_info = jmk.ingest_changes_fused(
        cfg, st.crdt, jnp.asarray(live), *map(jnp.asarray, msgs), interpret=True)
    got_cst, got_info = mk.ingest_changes_fused(tcfg, tst.crdt, T(live), *map(T, msgs))
    leaves_equal(want_cst, got_cst)
    for k in want_info:
        assert int(want_info[k]) == int(got_info[k]), k
    assert _deep_moved(tst.crdt.book, got_cst.book) == (True, True)
    # messages placed past slot 64
    assert not torch.equal(tst.crdt.q_origin[:, 64:], got_cst.q_origin[:, 64:])


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie_heavy"])
def test_local_write_emit_plain_matches_pallas_kernel_interpret_deep_queue(ties):
    """The emitting write at Q = 128 and R = 32 with an 8-word window; next
    versions up to ~300 past the heads. The random case takes the default
    payload budget, so rows pick more than 16 live slots; the tie case a
    budget of three changes, so that the budget mask ranks."""
    budget = {"bcast_budget_bytes": 3 * broadcast.CHANGE_WIRE_BYTES} if ties else {}
    cfg, st, tcfg, tst = random_state(22, ties=ties, next_hi=DEEP_DBV, full_p=0.2,
                                      q_empty=0.02, **DEEP, **budget)
    rng = np.random.default_rng(23)
    n, q = N_INGEST, cfg.bcast_queue
    wm = rng.random(n) < 0.6
    cell = rng.integers(0, cfg.n_cells, n).astype(np.int32)
    val = rng.integers(0, 1 << 20, n).astype(np.int32)
    clp = rng.integers(0, 2, n).astype(np.int32)
    rand = rng.random((n, q)).astype(np.float32)
    if ties:
        cell = two_cells(rng, 1, n, cfg.n_cells)[0].clip(min=0)
        val = np.full(n, TIE_KEYS[1], np.int32)
        clp = np.full(n, TIE_KEYS[3], np.int32)
        rand = np.floor(rand * 4) / 4
    carried = rng.integers(0, 5, n).astype(np.int32)
    want_cst, want_emit = jmk.local_write_fused(
        cfg, st.crdt, *map(jnp.asarray, (wm, cell, val, clp)),
        rand=jnp.asarray(rand), carried=jnp.asarray(carried), interpret=True)
    got_cst, got_emit = mk.local_write_fused(
        tcfg, tst.crdt, *map(T, (wm, cell, val, clp)), rand=T(rand), carried=T(carried))
    leaves_equal(want_cst, got_cst)
    for a, b in zip(want_emit, got_emit):
        assert np.array_equal(np.asarray(a), b.numpy())
    payload, sel, sel_ok = got_emit
    assert sel.shape == (n, 32) and payload.shape == (n, 11 * 32)
    if not ties:
        assert int((sel_ok.sum(dim=1) > 16).sum()) > 0
    assert _deep_moved(tst.crdt.book, got_cst.book)[0]
    assert not torch.equal(tst.crdt.q_origin[:, 64:], got_cst.q_origin[:, 64:])


def test_ingest_chain_matches_xla_path():
    """Several local writes and receive batches in a row against the JAX
    XLA path (fused="off"), which the JAX package pins equal to the kernels."""
    cfg, st, tcfg, tst = random_state(4, fused="off")
    cst, tcst = st.crdt, tst.crdt
    rng = np.random.default_rng(5)
    n, m = N_INGEST, 4 * cfg.pig_changes
    lw = jax.jit(lambda c, *a: jbroadcast.local_write(cfg, c, *a))
    ing = jax.jit(lambda c, *a: jbroadcast.ingest_changes(cfg, c, *a))
    for r in range(4):
        cst = cst._replace(now=cst.now + 1)
        tcst = tcst._replace(now=tcst.now + 1)
        wm = rng.random(n) < 0.5
        cell = rng.integers(0, cfg.n_cells, n).astype(np.int32)
        val = rng.integers(0, 1 << 20, n).astype(np.int32)
        clp = np.zeros(n, np.int32)
        cst = lw(cst, *map(jnp.asarray, (wm, cell, val, clp)))
        tcst = broadcast.local_write(tcfg, tcst, *map(T, (wm, cell, val, clp)))
        live, msgs = random_messages(10 + r, n, m, now=21 + r)
        jm = list(map(jnp.asarray, msgs))
        cst, info = ing(cst, jnp.asarray(live), *jm[:7], None, None, jm[7])
        tm = list(map(T, msgs))
        tcst, tinfo = broadcast.ingest_changes(tcfg, tcst, T(live), *tm[:7], None, None, tm[7])
        leaves_equal(cst, tcst)
        for k in info:
            assert int(info[k]) == int(tinfo[k]), (r, k)


def test_kernel_wrappers_count_only_cuda_launches():
    cfg, st, tcfg, tst = random_state(6)
    mk.reset_launches()
    live, msgs = random_messages(7, N_INGEST, 4)
    mk.ingest_changes_fused(tcfg, tst.crdt, T(live), *map(T, msgs))
    assert mk.LAUNCHES == {"swim_tables": 0, "ingest": 0, "ingest_emit": 0}


# past the CUDA kernel's 256 staged cells (its row-in-global-memory form),
# and not a multiple of 32: 1025 x 4 = 4,100 cells
LARGE_TABLE = dict(n_rows=1025, fused="off")


@pytest.mark.parametrize("contended", [False, True], ids=["random", "two_cells"])
def test_ingest_plain_matches_xla_path_4100_cells(contended):
    """Local writes then a receive batch a round, two rounds, against the
    JAX XLA path (its kernels' plain reference; the pallas body unrolls over
    the cells, too slow to compile at this width in interpret mode). With
    ``contended`` each row's writes and messages land on two cells, ranked
    by their keys; their values are drawn wide so that no two tie on all
    four keys with different versions, where the XLA path's CPU form keeps
    the first message and its column form and the kernels the largest
    version (tied keys name one change, ``corrosion_tpu/ops/lww.py``).
    Cells past 256 are written."""
    cfg, st, tcfg, tst = random_state(12, **LARGE_TABLE)
    cst, tcst = st.crdt, tst.crdt
    rng = np.random.default_rng(13)
    n, m, c = N_INGEST, 4 * cfg.pig_changes, cfg.n_cells
    lw = jax.jit(lambda s, *a: jbroadcast.local_write(cfg, s, *a))
    ing = jax.jit(lambda s, *a: jbroadcast.ingest_changes(cfg, s, *a))
    for r in range(2):
        cst = cst._replace(now=cst.now + 1)
        tcst = tcst._replace(now=tcst.now + 1)
        wm = rng.random(n) < 0.5
        cell = (two_cells(rng, 1, n, c)[0].clip(min=0) if contended
                else rng.integers(0, c, n).astype(np.int32))
        val = rng.integers(0, 1 << 20, n).astype(np.int32)
        clp = np.zeros(n, np.int32)
        cst = lw(cst, *map(jnp.asarray, (wm, cell, val, clp)))
        tcst = broadcast.local_write(tcfg, tcst, *map(T, (wm, cell, val, clp)))
        live, msgs = random_messages(14 + r, n, m, now=21 + r, n_cells=c)
        if contended:
            msgs[2] = two_cells(rng, n, m, c)
            msgs[4] = rng.integers(0, 1 << 20, (n, m)).astype(np.int32)
        jm = list(map(jnp.asarray, msgs))
        cst, info = ing(cst, jnp.asarray(live), *jm[:7], None, None, jm[7])
        tm = list(map(T, msgs))
        tcst, tinfo = broadcast.ingest_changes(tcfg, tcst, T(live), *tm[:7], None, None, tm[7])
        leaves_equal(cst, tcst)
        for k in info:
            assert int(info[k]) == int(tinfo[k]), (r, k)
    assert c == 4100
    moved = [not torch.equal(a[:, 256:], b[:, 256:]) for a, b in zip(tst.crdt.store, tcst.store)]
    assert any(moved)
