"""Multi-cell transactions and the plain ingest route: the port on the CPU
against the JAX package (its XLA path, ``fused="off"``), exact integer
equality (tolerance 0).

Module by module (numpy-seeded inputs, several seeds and edge cases each):
the receive-side bookkeeping of ``ops/versions.py``, the partial-changeset
buffer of ``ops/partials.py``, the plain ``local_write``, ``local_write_tx``
and ``ingest_changes`` of ``sim/broadcast.py``, and ``piggyback_bcast_step``'s
own selection. Then whole rounds, every state leaf and info value after
every round: the scale round at ``tx_max_cells=4`` (also with the int8
queue counters), under ``bcast_wire_budget`` and at ``pig_changes=0``; the
quiet round at ``tx_max_cells=4``; and the full view at ``wan_config``'s
default ``tx_max_cells=8`` with seeded transactions and a partition window.

At ``pig_changes=0`` the piggyback batch is empty (M = 0). The JAX
package's ingest cannot take an empty batch (``jnp.max`` over the empty
message axis raises, in ``hlc_fold`` and in its kernel alike), so its
reference run here gives that one call a batch of one message that is not
live, which is what the empty batch means; the port's ingest takes M = 0
as it is.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import dense as jdense
from corrosion_tpu.ops import partials as jpartials
from corrosion_tpu.ops import versions as jversions
from corrosion_tpu.sim import broadcast as jbroadcast
from corrosion_tpu.sim import config as jconfig
from corrosion_tpu.sim import scale_step as jscale
from corrosion_tpu.sim import scenario as jscenario
from corrosion_tpu.sim import step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.ops import partials, versions
from corrosion_tpu_torch.sim import broadcast, config, scale_step, step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

SEEDS = (0, 1)


def _t(a):
    return convert._t(np.asarray(a), "cpu")


def _eq(want, got, where):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert want.dtype == got.dtype and want.shape == got.shape, (where, want.dtype, got.dtype)
    assert np.array_equal(want, got), where


def _leaves_equal(want, got, where):
    assert len(want) == len(got), where
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, i)


# --- ops/versions.py: seen_versions, record_versions, bump_known_max -------

BN, BO, BW, BM, NOW = 32, 8, 2, 12, 40


def _book_case(seed, case):
    """A random Book and an [N, M] batch. ``dups``: half the columns repeat
    earlier ones; ``beyond``: versions past the window; ``untracked``:
    origins >= O on free or idle slots, which claim them."""
    rng = np.random.default_rng(seed)
    n, o, w = BN, BO, BW
    head = rng.integers(0, 40, (n, o))
    km = head + rng.integers(0, 20, (n, o))
    seen = (rng.integers(0, 1 << 32, (n, o, w), dtype=np.uint64)
            & rng.integers(0, 1 << 32, (n, o, w), dtype=np.uint64)).astype(np.uint32)
    org_id = np.broadcast_to(np.arange(o), (n, o)).copy()
    org_id[rng.random((n, o)) < 0.2] = -1
    org_last = rng.integers(NOW - 30, NOW + 1, (n, o))
    origin = rng.integers(-1, o, (n, BM))
    if case == "untracked":
        origin = rng.integers(-1, 3 * o, (n, BM))
        org_last = rng.integers(0, NOW - 20, (n, o))
    slot = np.where(origin >= 0, origin % o, 0)
    h_at = np.take_along_axis(head, slot, axis=1)
    ver = h_at + rng.integers(-3, 32 * w + 6, (n, BM))
    if case == "beyond":
        ver = h_at + rng.integers(32 * w - 2, 32 * w + 40, (n, BM))
    valid = rng.random((n, BM)) < 0.8
    if case == "dups":
        src = rng.integers(0, BM // 2, BM // 2)
        origin[:, BM // 2:] = origin[:, src]
        ver[:, BM // 2:] = ver[:, src]
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    book = (i32(head), i32(km), seen, i32(org_id), i32(org_last))
    return book, i32(origin), i32(ver), valid


def _books(book):
    jb = jversions.Book(*map(jnp.asarray, book))
    tb = versions.Book(*map(_t, book))
    return jb, tb


def _book_eq(want, got, where):
    for f, a, b in zip(want._fields, want, got):
        _eq(a, b, (where, f))


@pytest.mark.parametrize("form", ["element", "dense"])
@pytest.mark.parametrize("case", ["random", "dups", "beyond", "untracked"])
@pytest.mark.parametrize("seed", SEEDS)
def test_record_versions_matches_jax(monkeypatch, form, case, seed):
    """``seen_versions``, ``record_versions`` (with slot claims) and
    ``bump_known_max`` against both of the JAX package's scatter forms."""
    monkeypatch.setattr(jdense, "FORCE_DENSE", form == "dense")
    book, origin, ver, valid = _book_case(seed, case)
    jb, tb = _books(book)
    jo, jv, jval = map(jnp.asarray, (origin, ver, valid))
    to, tv, tval = _t(origin), _t(ver), torch.from_numpy(valid)

    _eq(jversions.seen_versions(jb, jo, jv, jval), versions.seen_versions(tb, to, tv, tval),
        "seen")
    want, wfresh, wrec = jversions.record_versions(jb, jo, jv, jval, now=jnp.int32(NOW),
                                                   keep_rounds=16)
    got, gfresh, grec = versions.record_versions(tb, to, tv, tval,
                                                 now=torch.tensor(NOW, dtype=torch.int32),
                                                 keep_rounds=16)
    _book_eq(want, got, "record")
    _eq(wfresh, gfresh, "fresh")
    _eq(wrec, grec, "rec")
    _book_eq(jversions.record_versions(jb, jo, jv, jval)[0],
             versions.record_versions(tb, to, tv, tval)[0], "record, no claims")
    _book_eq(jversions.bump_known_max(jb, jo, jv, jval),
             versions.bump_known_max(tb, to, tv, tval), "bump")
    if case == "dups":
        assert np.asarray(jval).sum() > np.asarray(wfresh).sum()
    if case == "untracked":
        assert (np.asarray(want.org_id) != book[3]).any()


# --- ops/partials.py: ingest_partials, complete_mask ------------------------

PN, PP, PK, PM = 24, 6, 4, 16


def _partials_case(seed, case):
    """A partial buffer and a batch of chunked cells. ``repeated``: cells
    repeat (key, seq) pairs of the batch; ``out_of_range``: seqs and nseqs
    outside 0..K-1 and 1..K; ``full``: every slot holds a key the batch
    never names, so no new version finds a slot."""
    rng = np.random.default_rng(100 + seed)
    n, p, k, m = PN, PP, PK, PM
    origin = np.where(rng.random((n, p)) < 0.5, rng.integers(0, 4, (n, p)), -1)
    dbv = rng.integers(1, 4, (n, p))
    if case == "full":
        origin = np.broadcast_to(10 + np.arange(p), (n, p)).copy()
    nseq = np.where(origin >= 0, rng.integers(2, k + 1, (n, p)), 0)
    mask = np.where(origin >= 0, rng.integers(0, 1 << k, (n, p)) & ((1 << nseq) - 1), 0)
    lanes = [rng.integers(0, 1 << 20, (n, p, k)) for _ in range(5)]
    m_origin = rng.integers(0, 4, (n, m))
    m_dbv = rng.integers(1, 4, (n, m))
    m_nseq = rng.integers(2, k + 1, (n, m))
    m_seq = rng.integers(0, k, (n, m)) % m_nseq
    if case == "repeated":
        src = rng.integers(0, m // 2, m // 2)
        for a in (m_origin, m_dbv, m_nseq, m_seq):
            a[:, m // 2:] = a[:, src]
    if case == "out_of_range":
        m_seq = rng.integers(-2, k + 2, (n, m))
        m_nseq = rng.integers(-1, k + 3, (n, m))
    live = rng.random((n, m)) < 0.85
    fields = [m_origin, m_dbv, m_seq, m_nseq] + [rng.integers(0, 1 << 20, (n, m))
                                                 for _ in range(5)]
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    par = tuple(map(i32, (origin, dbv, mask, nseq, *lanes)))
    return par, live, [i32(f) for f in fields]


def _ingest_both(jpar, tpar, live, fields):
    want, wfresh = jpartials.ingest_partials(jpar, jnp.asarray(live),
                                             *map(jnp.asarray, fields))
    got, gfresh = partials.ingest_partials(tpar, torch.from_numpy(live), *map(_t, fields))
    for f, a, b in zip(want._fields, want, got):
        _eq(a, b, f)
    _eq(wfresh, gfresh, "fresh")
    _eq(jpartials.complete_mask(want), partials.complete_mask(got), "complete")
    return want, got, np.asarray(wfresh)


@pytest.mark.parametrize("case", ["random", "repeated", "out_of_range", "full"])
@pytest.mark.parametrize("seed", SEEDS)
def test_ingest_partials_matches_jax(case, seed):
    par, live, fields = _partials_case(seed, case)
    want, _, fresh = _ingest_both(jpartials.Partials(*map(jnp.asarray, par)),
                                  partials.Partials(*map(_t, par)), live, fields)
    if case == "repeated":
        assert fresh.sum() < (live & (fields[2] < fields[3])).sum()
    if case == "full":
        # only cells of keys already buffered could be fresh: none here
        assert not fresh.any() and (np.asarray(want.origin) == par[0]).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_partial_versions_complete_across_two_batches(seed):
    """Versions whose seqs arrive split over two batches: incomplete after
    the first, complete after the second; the free buffer fills from empty."""
    rng = np.random.default_rng(200 + seed)
    n, k = PN, PK
    nseq = rng.integers(2, k + 1, (n, 3))
    cells = [(j, s) for j in range(3) for s in range(k)]
    batches = ([], [])
    for j, s in cells:
        batches[s % 2].append((j, s))
    jpar = jpartials.Partials.create(n, PP, k)
    tpar = partials.Partials.create(n, PP, k, "cpu")
    for b, batch in enumerate(batches):
        js = np.array([j for j, _ in batch])
        seq = np.broadcast_to(np.array([s for _, s in batch]), (n, len(batch)))
        m_nseq = nseq[:, js]
        live = seq < m_nseq
        fields = [np.broadcast_to(7 + js, seq.shape), np.broadcast_to(1 + js, seq.shape),
                  seq, m_nseq] + [rng.integers(0, 1 << 20, seq.shape) for _ in range(5)]
        jpar, tpar, fresh = _ingest_both(jpar, tpar, live,
                                         [np.asarray(f, np.int32) for f in fields])
        assert fresh.sum() == live.sum()
        done = np.asarray(jpartials.complete_mask(jpar))
        assert (done.sum(axis=1) == (0 if b == 0 else 3)).all(), b


# --- sim/broadcast.py: the plain write and ingest ---------------------------

WN = 32


def _wan(**over):
    kw = dict(n_origins=8, n_rows=4, n_cols=4, bcast_queue=16, partial_slots=6)
    kw.update(over)
    return jconfig.wan_config(WN, fused="off", **kw), config.wan_config(WN, **kw)


def _scale(**over):
    kw = dict(n_origins=8, n_rows=4, n_cols=4, bcast_queue=16, partial_slots=6,
              tx_max_cells=4)
    kw.update(over)
    return jscale.scale_sim_config(WN, fused="off", **kw), scale_step.scale_sim_config(WN, **kw)


def _crdt_start(jcfg, seed, now=20):
    """A CRDT state with some history: random store, clocks, counters, a
    half-full queue and heads."""
    rng = np.random.default_rng(300 + seed)
    cst = jbroadcast.CrdtState.create(jcfg)
    n, c, q = jcfg.n_nodes, jcfg.n_cells, jcfg.bcast_queue
    o = jcfg.n_origins
    i32 = lambda a, dt=np.int32: jnp.asarray(np.asarray(a, dt))  # noqa: E731
    store = tuple(i32(rng.integers(0, 5, (n, c))) for _ in range(5))
    head = rng.integers(0, 6, (n, o))
    book = cst.book._replace(head=i32(head), known_max=i32(head + rng.integers(0, 3, (n, o))))
    qdt = cst.q_tx.dtype
    return cst._replace(
        store=store, book=book, now=jnp.int32(now),
        next_dbv=i32(np.maximum(head[np.arange(n), np.arange(n) % o], 0) + 1),
        hlc=i32(rng.integers(0, now << 10, n)),
        q_origin=i32(np.where(rng.random((n, q)) < 0.5, -1, rng.integers(0, o, (n, q)))),
        q_tx=jnp.asarray(rng.integers(0, 4, (n, q)), qdt),
    )


def _port_crdt(cst):
    return convert._crdt(convert.as_numpy_tree(cst), torch.device("cpu"))


def _crdt_eq(want, got, where):
    _leaves_equal(jax.tree.leaves(convert.as_numpy_tree(want)),
                  jax.tree.leaves(_np_crdt(got)), where)


def _np_crdt(cst):
    tree = {}
    for f, v in zip(cst._fields, cst):
        if f == "store":
            tree[f] = [p.numpy() for p in v]
        elif hasattr(v, "_fields"):
            tree[f] = {g: w.numpy() for g, w in zip(v._fields, v)}
        else:
            tree[f] = v.numpy()
    tree["book"]["seen"] = tree["book"]["seen"].view(np.uint32)
    return tree


@pytest.mark.parametrize("seed", SEEDS)
def test_local_write_plain_matches_jax(seed):
    """The plain one-cell local write (the route of every multi-cell
    configuration), with writers inside and outside the origin set."""
    jcfg, tcfg = _wan()
    assert not broadcast.kernel_ingest(tcfg)
    cst = _crdt_start(jcfg, seed)
    rng = np.random.default_rng(seed)
    args = [rng.random(WN) < 0.6, rng.integers(0, jcfg.n_cells, WN),
            rng.integers(0, 1 << 20, WN), rng.integers(0, 3, WN)]
    args = [np.asarray(a, np.int32) if a.dtype != bool else a for a in args]
    want = jbroadcast.local_write(jcfg, cst, *map(jnp.asarray, args))
    got = broadcast.local_write(tcfg, _port_crdt(cst), *map(_t, args))
    _crdt_eq(want, got, "local_write")


@pytest.mark.parametrize("case", ["len1", "lenK", "mixed", "dup_cells"])
def test_local_write_tx_matches_jax(case):
    """Multi-cell transactions of 1..K cells; ``dup_cells`` draws each
    transaction's cells from two, so most repeat a cell."""
    jcfg, tcfg = _wan()
    k = jcfg.tx_max_cells
    cst = _crdt_start(jcfg, 5)
    rng = np.random.default_rng(7)
    tx_len = {"len1": np.ones(WN), "lenK": np.full(WN, k)}.get(
        case, rng.integers(1, k + 1, WN))
    cells = rng.integers(0, 2 if case == "dup_cells" else jcfg.n_cells, (WN, k))
    args = [rng.random(WN) < 0.7, cells, rng.integers(0, 1 << 20, (WN, k)),
            rng.integers(0, 2, (WN, k)), tx_len]
    args = [a if a.dtype == bool else np.asarray(a, np.int32) for a in args]
    want = jbroadcast.local_write_tx(jcfg, cst, *map(jnp.asarray, args))
    got = broadcast.local_write_tx(tcfg, _port_crdt(cst), *map(_t, args))
    _crdt_eq(want, got, case)
    assert (np.asarray(want.q_nseq) > 1).any() == (case != "len1")


def _chunked_batch(rng, n, m, o, k, now, dup=True):
    """Per row: cells of a few versions, single-cell (nseq 1) and chunked
    (nseq 2..k), in random order with repeats; fields as ingest takes them."""
    out = np.zeros((10, n, m), np.int64)
    for i in range(n):
        row = []
        for _ in range(4):
            org, dbv = rng.integers(0, 2 * o), rng.integers(1, 12)
            ns = rng.choice([1, rng.integers(2, k + 1)])
            for s in range(ns):
                row.append((org, dbv, s, ns))
        pick = rng.choice(len(row), m, replace=dup)
        for j, t in enumerate(pick):
            org, dbv, s, ns = row[t]
            out[:, i, j] = (org, dbv, rng.integers(-1, 17), rng.integers(0, 8),
                            rng.integers(0, 1 << 20), org, rng.integers(0, 2), s, ns,
                            rng.integers((now - 3) << 10, (now + 4) << 10))
    return [a.astype(np.int32) for a in out]


@pytest.mark.parametrize("case", ["wan_mixed_nseq", "scale_tx4", "scale_tx4_wire",
                                  "scale_tx1_wire"])
def test_ingest_changes_plain_matches_jax(case):
    """The plain ingest over two batches of mixed single-cell and chunked
    versions (the second completes some of the first's), with the wire-budget
    lane where the config carries it."""
    if case == "wan_mixed_nseq":
        jcfg, tcfg = _wan()
    else:
        jcfg, tcfg = _scale(tx_max_cells=1 if case == "scale_tx1_wire" else 4,
                            bcast_wire_budget=case.endswith("wire"))
    assert not broadcast.kernel_ingest(tcfg)
    rng = np.random.default_rng(11)
    cst = _crdt_start(jcfg, 3)
    tst = _port_crdt(cst)
    m, k = 16, max(2, jcfg.tx_max_cells)
    completed = 0
    for b in range(2):
        msgs = _chunked_batch(rng, WN, m, jcfg.n_origins, k, 20)
        if jcfg.tx_max_cells <= 1:
            msgs[7][:], msgs[8][:] = 0, 1
        live = rng.random((WN, m)) < 0.85
        extra = {}
        if jcfg.__class__ is jscale.ScaleSimConfig:
            extra = {"m_tx": rng.integers(0, 4, (WN, m)).astype(np.int32)}
        cst, winfo = jbroadcast.ingest_changes(
            jcfg, cst, jnp.asarray(live), *map(jnp.asarray, msgs),
            **{a: jnp.asarray(v) for a, v in extra.items()})
        tst, ginfo = broadcast.ingest_changes(tcfg, tst, torch.from_numpy(live),
                                              *map(_t, msgs),
                                              **{a: _t(v) for a, v in extra.items()})
        _crdt_eq(cst, tst, (case, b))
        assert {a: int(v) for a, v in winfo.items()} == {a: int(v) for a, v in ginfo.items()}
        completed += int(winfo["tx_completed"])
        assert int(winfo["fresh"]) > 0
    assert completed > 0 or jcfg.tx_max_cells <= 1


def test_empty_batch_ingest_is_the_identity_on_the_queue_and_store():
    """M = 0 (the scale round at pig_changes=0) on both routes: nothing is
    delivered, recorded or enqueued; the clock stays."""
    for over in (dict(tx_max_cells=1), dict(tx_max_cells=4)):
        jcfg, tcfg = _scale(**over)
        tst = _port_crdt(_crdt_start(jcfg, 1))
        empty = torch.zeros((WN, 0), dtype=torch.int32)
        got, info = broadcast.ingest_changes(tcfg, tst, empty.bool(), *([empty] * 7))
        assert all(int(v) == 0 for k, v in info.items() if k != "queued")
        for a, b in zip(jax.tree.leaves(_np_crdt(tst)), jax.tree.leaves(_np_crdt(got))):
            assert np.array_equal(a, b)


# --- sim/scale_step.py: piggyback_bcast_step's own selection ----------------


@pytest.fixture(scope="module")
def pig_states():
    """JAX states after four rounds at N=64 for the three plain-selection
    configurations."""
    out = {}
    for name, over in (("tx4", dict(tx_max_cells=4)),
                       ("wirebudget", dict(bcast_wire_budget=True)),
                       ("tx4_q8", dict(tx_max_cells=4, narrow_q_int8=True))):
        cfg = jscale.scale_sim_config(64, fused="off", sync_interval=2, **over)
        inputs = jscale.make_write_inputs(cfg, jr.key(5), 4,
                                          jr.uniform(jr.key(9), (4, 64)) < 0.3)
        st, _ = jax.jit(lambda s, i, cfg=cfg: jscale.scale_run_rounds(
            cfg, s, JNet.create(64, drop_prob=0.05), jr.key(3), i))(
                jscale.ScaleSimState.create(cfg), inputs)
        out[name] = (over, st)
    return out


@pytest.mark.parametrize("carried", ["given", "counted"])
@pytest.mark.parametrize("name", ["tx4", "wirebudget", "tx4_q8"])
def test_piggyback_bcast_step_selection_matches_jax(pig_states, name, carried):
    """``emitted=None``: the byte budget, the sample under the round key,
    the packed payload (with the wire lane under the budget flag), the
    budget burn and the ingest."""
    over, st = pig_states[name]
    jcfg = jscale.scale_sim_config(64, fused="off", sync_interval=2, **over)
    tcfg = scale_step.scale_sim_config(64, sync_interval=2, **over)
    rng = np.random.default_rng(21)
    chans = [(rng.integers(-1, 64, 64).astype(np.int32), rng.random(64) < 0.8)
             for _ in range(4)]
    car = (rng.integers(0, 5, 64).astype(np.int32) if carried == "given" else None)
    key = jr.key(17)
    want, winfo = jscale.piggyback_bcast_step(
        jcfg, st.crdt, [(jnp.asarray(s), jnp.asarray(v)) for s, v in chans], key,
        None if car is None else jnp.asarray(car))
    tst = convert.scale_state_from_numpy(tcfg, convert.as_numpy_tree(st), "cpu")
    got, ginfo = scale_step.piggyback_bcast_step(
        tcfg, tst.crdt, [(_t(s), torch.from_numpy(v)) for s, v in chans],
        convert.key_from_numpy(jr.key_data(key)), None if car is None else _t(car))
    _crdt_eq(want, got, name)
    assert {a: int(v) for a, v in winfo.items()} == {a: int(v) for a, v in ginfo.items()}
    assert int(winfo["delivered"]) > 0


@pytest.mark.parametrize("which", ["scale_tx4", "full_tx8"])
def test_multi_slot_state_round_trips(which):
    """A state with a multi-slot partial buffer ([N, P, K] payload lanes,
    P = 8 or 16, K = 4 or 8), every leaf random over its dtype's range,
    survives the trip to the port and back, leaf for leaf."""
    rng = np.random.default_rng(31)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return jnp.asarray(rng.random(a.shape) < 0.5)
        info = np.iinfo(a.dtype)
        return jnp.asarray(rng.integers(info.min, info.max, a.shape, dtype=a.dtype,
                                        endpoint=True))

    if which == "scale_tx4":
        jcfg = jscale.scale_sim_config(48, tx_max_cells=4)
        st = jax.tree.map(fill, jscale.ScaleSimState.create(jcfg))
        back = convert.scale_state_from_numpy(
            scale_step.scale_sim_config(48, tx_max_cells=4), convert.as_numpy_tree(st), "cpu")
    else:
        jcfg = jconfig.wan_config(40)
        st = jax.tree.map(fill, jstep.SimState.create(jcfg))
        back = convert.full_state_from_numpy(config.wan_config(40), convert.as_numpy_tree(st),
                                             "cpu")
    k = jcfg.tx_max_cells
    assert back.crdt.partials.cell.shape == (jcfg.n_nodes, jcfg.partial_slots, k)
    _leaves_equal(jax.tree.leaves(convert.as_numpy_tree(st)),
                  jax.tree.leaves(convert.state_to_numpy(back)), which)


# --- whole rounds ------------------------------------------------------------

N, ROUNDS = 256, 12
OVER = dict(sync_interval=2, sync_sweep_every=2)
SCALE = {
    "tx4": dict(tx_max_cells=4),
    "tx4_q8": dict(tx_max_cells=4, narrow_q_int8=True),
    "wirebudget": dict(bcast_wire_budget=True),
    "pig0": dict(pig_changes=0),
}


def _dead_column_ingest(orig):
    """JAX's ingest with an empty batch given as one message that is not
    live (see the module docstring)."""
    def ingest(cfg, cst, live, *m, **kw):
        if live.shape[1] == 0:
            def pad(a):
                return None if a is None else jnp.zeros((a.shape[0], 1), a.dtype)
            live, m = pad(live), [pad(a) for a in m]
            kw = {k: pad(v) for k, v in kw.items()}
        return orig(cfg, cst, live, *m, **kw)
    return ingest


@pytest.fixture(scope="module", params=sorted(SCALE))
def scale_reference(request):
    """The JAX trajectory of one configuration, one round per call of the
    scan entry point, with kills, revives, 5 % loss, sync and sweep rounds."""
    name = request.param
    cfg = jscale.scale_sim_config(N, fused="off", **OVER, **SCALE[name])
    st = jscale.ScaleSimState.create(cfg)
    net = JNet.create(N, drop_prob=0.05)
    key = jr.key(3)
    inputs = jscale.make_write_inputs(cfg, jr.key(5), ROUNDS,
                                      jr.uniform(jr.key(9), (ROUNDS, N)) < 0.1)
    kill = np.zeros((ROUNDS, N), bool)
    revive = np.zeros((ROUNDS, N), bool)
    kill[3, 10:20] = True
    revive[7, 10:15] = True
    inputs = inputs._replace(kill=jnp.asarray(kill), revive=jnp.asarray(revive))
    start = dict(state=convert.as_numpy_tree(st), net=convert.as_numpy_tree(net),
                 key=np.asarray(jr.key_data(key)), inputs=convert.as_numpy_tree(inputs))
    states, infos = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jscale, "ingest_changes", _dead_column_ingest(jbroadcast.ingest_changes))
        run = jax.jit(lambda s, k, i: jscale.scale_run_rounds_carry(cfg, s, net, k, i))
        for r in range(ROUNDS):
            (st, key), info = run(st, key, jax.tree.map(lambda a: a[r:r + 1], inputs))
            states.append(jax.tree.leaves(convert.as_numpy_tree(st)))
            infos.append({k: int(np.asarray(v)[0]) for k, v in info.items()})
    return name, start, states, infos


def _scale_port_start(name, start):
    cfg = scale_step.scale_sim_config(N, **OVER, **SCALE[name])
    return (cfg, convert.scale_state_from_numpy(cfg, start["state"], "cpu"),
            convert.net_from_numpy(start["net"], "cpu"), convert.key_from_numpy(start["key"]),
            convert.round_input_from_numpy(scale_step.ScaleRoundInput, start["inputs"], "cpu"))


def test_scale_round_every_round_bitwise_equal_to_jax(scale_reference):
    name, start, states, infos = scale_reference
    cfg, st, net, key, inputs = _scale_port_start(name, start)
    for r in range(ROUNDS):
        one = scale_step.ScaleRoundInput(*(a[r:r + 1] for a in inputs))
        (st, key), info = scale_step.scale_run_rounds_carry(cfg, st, net, key, one)
        _leaves_equal(states[r], jax.tree.leaves(convert.state_to_numpy(st)), (name, r))
        assert {k: int(v[0]) for k, v in info.items()} == infos[r], (name, r)


def test_scale_run_rounds_equals_the_reference(scale_reference):
    name, start, states, infos = scale_reference
    cfg, st, net, key, inputs = _scale_port_start(name, start)
    st, stacked = scale_step.scale_run_rounds(cfg, st, net, key, inputs)
    _leaves_equal(states[-1], jax.tree.leaves(convert.state_to_numpy(st)), name)
    for k in infos[0]:
        assert [int(v) for v in stacked[k]] == [i[k] for i in infos], (name, k)


def test_scale_reference_exercises_its_path(scale_reference):
    name, _, _, infos = scale_reference
    total = {k: sum(i[k] for i in infos) for k in infos[0]}
    assert total["syncs"] > 0 and total["cells_pulled"] > 0
    if name == "pig0":
        assert total["delivered"] == 0 and total["queued"] > 0
    else:
        assert total["fresh"] > 0
    assert (total["tx_completed"] > 0) == name.startswith("tx4")


def test_scale_round_kernel_route_follows_the_config():
    """The kernels' route is chosen by the config, as in the JAX package:
    the plain route under multi-cell transactions and the wire-budget lane;
    no emitting local write at pig_changes=0."""
    def route(**over):
        return broadcast.kernel_ingest(scale_step.scale_sim_config(64, **over))
    assert route() and route(pig_changes=0)
    assert not route(tx_max_cells=4) and not route(bcast_wire_budget=True)
    assert not broadcast.kernel_ingest(config.wan_config(64))
    assert broadcast.kernel_ingest(config.full_view_config(64))


def test_make_write_inputs_tx_matches_jax():
    cfg = jscale.scale_sim_config(N, tx_max_cells=4)
    wm = jr.uniform(jr.key(1), (4, N)) < 0.25
    want = convert.as_numpy_tree(jscale.make_write_inputs(cfg, jr.key(2), 4, wm))
    got = scale_step.make_write_inputs(scale_step.scale_sim_config(N, tx_max_cells=4),
                                       prng.key(2), 4, torch.from_numpy(np.array(wm)), "cpu")
    for k, v in want.items():
        _eq(v, getattr(got, k), k)
    assert got.tx_mask.any() and not got.write_mask.any() and got.tx_cell.shape == (4, N, 4)


# --- the quiet round at tx_max_cells=4 --------------------------------------

QN, QROUNDS = 48, 48
QSHAPE = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=4, tx_max_cells=4,
              partial_slots=4)


@pytest.fixture(scope="module")
def quiet_tx():
    """A seeded transaction trace that settles (writes in the first 4
    rounds only; the queues drain by round 34): JAX's quiet round, and the
    port's quiet and dense rounds."""
    cfg = jscale.scale_sim_config(QN, quiet="on", fused="off", **QSHAPE)
    key = jr.key(7)
    w = ((jr.uniform(key, (QROUNDS, QN)) < 0.3) & (jnp.arange(QN) < cfg.n_origins)[None, :]
         & (jnp.arange(QROUNDS) < 4)[:, None])
    inputs = jscale.make_write_inputs(cfg, jr.fold_in(key, 1), QROUNDS, w)
    st, infos = jax.jit(lambda s, i: jscale.scale_run_rounds(
        cfg, s, JNet.create(QN), jr.key(0), i))(jscale.ScaleSimState.create(cfg), inputs)
    port = {}
    for quiet in ("on", "off"):
        tcfg = scale_step.scale_sim_config(QN, quiet=quiet, **QSHAPE)
        tst, tinfos = scale_step.scale_run_rounds(
            tcfg, scale_step.ScaleSimState.create(tcfg, "cpu"),
            scale_step.NetModel.create(QN, device="cpu"),
            convert.key_from_numpy(np.asarray(jr.key_data(jr.key(0)))),
            convert.round_input_from_numpy(scale_step.ScaleRoundInput,
                                           convert.as_numpy_tree(inputs), "cpu"))
        port[quiet] = (jax.tree.leaves(convert.state_to_numpy(tst)),
                       {k: v.numpy() for k, v in tinfos.items()})
    return (jax.tree.leaves(convert.as_numpy_tree(st)),
            {k: np.asarray(v) for k, v in infos.items()}, port)


def test_quiet_round_tx4_equals_jax_quiet_round(quiet_tx):
    want, winfos, port = quiet_tx
    _leaves_equal(want, port["on"][0], "quiet tx4")
    assert sorted(winfos) == sorted(port["on"][1])
    for k, v in winfos.items():
        assert np.array_equal(v.astype(np.int64), port["on"][1][k].astype(np.int64)), k
    assert int(winfos["tx_completed"].sum()) > 0


def test_quiet_round_tx4_equals_dense_round(quiet_tx):
    _, _, port = quiet_tx
    _leaves_equal(port["off"][0], port["on"][0], "quiet vs dense")
    for k, v in port["off"][1].items():
        assert np.array_equal(v, port["on"][1][k]), k
    assert int(port["on"][1]["quiet_round"].sum()) > 0


# --- the full view at tx_max_cells=8 -----------------------------------------

FN, FROUNDS = 64, 20
PARTITION = range(6, 12)


def _tx_inputs(jcfg, inputs, seed=12):
    """One transaction a round per writer (origins write at p=0.5), length
    uniform in 1..K, cells and values from the seed."""
    rng = np.random.default_rng(seed)
    n, k = jcfg.n_nodes, jcfg.tx_max_cells
    shape = (FROUNDS, n, k)
    return inputs._replace(
        tx_mask=jnp.asarray((rng.random((FROUNDS, n)) < 0.5) & (np.arange(n) < jcfg.n_origins)),
        tx_len=jnp.asarray(rng.integers(1, k + 1, (FROUNDS, n)).astype(np.int32)),
        tx_cell=jnp.asarray(rng.integers(0, jcfg.n_cells, shape).astype(np.int32)),
        tx_val=jnp.asarray(rng.integers(0, 1 << 20, shape).astype(np.int32)),
        tx_clp=jnp.asarray(rng.integers(0, 2, shape).astype(np.int32)),
    )


@pytest.fixture(scope="module")
def full_tx_reference():
    jcfg = jconfig.wan_config(FN, n_origins=8, fused="off")
    assert jcfg.tx_max_cells == 8 and jcfg.partial_slots == 16
    nets = (JNet.create(FN, drop_prob=0.05), jscenario.partitioned_net(jcfg, 2, 0.05))
    st = jstep.SimState.create(jcfg)
    key = jr.key(3)
    inputs = _tx_inputs(jcfg, jscenario.full_mix(jcfg, FROUNDS, jr.key(5)))
    start = dict(state=convert.as_numpy_tree(st), key=np.asarray(jr.key_data(key)),
                 inputs=convert.as_numpy_tree(inputs),
                 nets=[convert.as_numpy_tree(net) for net in nets])
    run = jax.jit(lambda s, k, i, net: jstep.run_rounds_carry(jcfg, s, net, k, i))
    states, infos = [], []
    for r in range(FROUNDS):
        (st, key), info = run(st, key, jax.tree.map(lambda a: a[r:r + 1], inputs),
                              nets[r in PARTITION])
        states.append(jax.tree.leaves(convert.as_numpy_tree(st)))
        infos.append({k: int(np.asarray(v)[0]) for k, v in info.items()})
    return start, states, infos


def test_full_view_tx8_every_round_bitwise_equal_to_jax(full_tx_reference):
    start, states, infos = full_tx_reference
    cfg = config.wan_config(FN, n_origins=8)
    st = convert.full_state_from_numpy(cfg, start["state"], "cpu")
    nets = [convert.net_from_numpy(n, "cpu") for n in start["nets"]]
    key = convert.key_from_numpy(start["key"])
    inputs = convert.round_input_from_numpy(step.RoundInput, start["inputs"], "cpu")
    for r in range(FROUNDS):
        one = step.RoundInput(*(a[r:r + 1] for a in inputs))
        (st, key), info = step.run_rounds_carry(cfg, st, nets[r in PARTITION], key, one)
        _leaves_equal(states[r], jax.tree.leaves(convert.state_to_numpy(st)), r)
        assert {k: int(v[0]) for k, v in info.items()} == infos[r], r


def test_full_view_tx8_reference_completes_transactions(full_tx_reference):
    start, _, infos = full_tx_reference
    assert sum(i["tx_completed"] for i in infos) > 0
    assert sum(i["syncs"] for i in infos) > 0 and start["inputs"]["kill"].any()
    assert min(infos[r]["failed_probes"] for r in PARTITION) > 0


def test_full_view_tx8_run_rounds_in_one_call(full_tx_reference):
    """``wan_config``'s default runs through ``step.run_rounds``."""
    start, states, _ = full_tx_reference
    cfg = config.wan_config(FN, n_origins=8)
    st = convert.full_state_from_numpy(cfg, start["state"], "cpu")
    inputs = convert.round_input_from_numpy(step.RoundInput, start["inputs"], "cpu")
    st, infos = step.run_rounds(cfg, st, convert.net_from_numpy(start["nets"][0], "cpu"),
                                convert.key_from_numpy(start["key"]),
                                step.RoundInput(*(a[:PARTITION.start] for a in inputs)))
    _leaves_equal(states[PARTITION.start - 1], jax.tree.leaves(convert.state_to_numpy(st)),
                  "run_rounds")
    assert int(infos["tx_completed"].sum()) > 0
