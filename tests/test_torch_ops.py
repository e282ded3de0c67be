"""The port's tensor primitives (corrosion_tpu_torch/ops, sim/config,
sim/transport) against the JAX package: exact equality, tolerance 0.

The JAX column ops run in their dense form (``FORCE_DENSE``), whose
semantics the port implements (max value wins a duplicate set-scatter)."""

import dataclasses

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import dense as jdense
from corrosion_tpu.ops import lww as jlww
from corrosion_tpu.ops import partials as jpartials
from corrosion_tpu.ops import select as jselect
from corrosion_tpu.ops import slots as jslots
from corrosion_tpu.ops import versions as jversions
from corrosion_tpu.sim import broadcast as jbroadcast
from corrosion_tpu.sim import config as jconfig
from corrosion_tpu.sim import scale as jscale
from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim import transport as jtransport
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.ops import dense, lww, partials, select, slots, versions
from corrosion_tpu_torch.sim import broadcast, config, scale, scale_step, transport
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)


def T(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def same(want, got):
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if w.dtype == np.uint32:
        g = g.view(np.uint32)
    return w.shape == g.shape and w.dtype == g.dtype and np.array_equal(w, g)


@pytest.fixture
def dense_form(monkeypatch):
    monkeypatch.setattr(jdense, "FORCE_DENSE", True)


@pytest.fixture
def arrays():
    k1, k2, k3, k4 = jr.split(jr.key(3), 4)
    n, w, m = 64, 16, 24
    table = jr.randint(k1, (n, w), 0, 100, dtype=jnp.int32)
    idx = jr.randint(k2, (n, m), -2, w + 2, dtype=jnp.int32)  # incl. oob
    vals = jr.randint(k3, (n, m), 1, 1000, dtype=jnp.int32)
    valid = jr.uniform(k4, (n, m)) < 0.7
    return table, idx, vals, valid


# --- constants and configs ---------------------------------------------------

def test_constants_pinned_to_jax():
    pins = [
        (broadcast.NO_Q, jbroadcast.NO_Q),
        (broadcast.HLC_ROUND_BITS, jbroadcast.HLC_ROUND_BITS),
        (broadcast.HLC_MAX_DRIFT_ROUNDS, jbroadcast.HLC_MAX_DRIFT_ROUNDS),
        (broadcast.CHANGE_WIRE_BYTES, jbroadcast.CHANGE_WIRE_BYTES),
        (broadcast.LAST_SYNC_CAP, jbroadcast.LAST_SYNC_CAP),
        (lww.STATE_ALIVE, jlww.STATE_ALIVE),
        (lww.STATE_SUSPECT, jlww.STATE_SUSPECT),
        (lww.STATE_DOWN, jlww.STATE_DOWN),
        (lww.INT32_MIN, jlww.INT32_MIN),
        (scale.FREE, jscale.FREE),
        (partials.NO_SLOT, jpartials.NO_SLOT),
        (transport.N_RINGS, jtransport.N_RINGS),
        (transport.CARD_EXTRA, jtransport.CARD_EXTRA),
        (config.FUSED_MODES, jconfig.FUSED_MODES),
        (config.QUIET_MODES, jconfig.QUIET_MODES),
    ]
    for ours, theirs in pins:
        assert ours == (theirs if isinstance(theirs, tuple) else int(theirs))


@pytest.mark.parametrize("n", [16, 64, 256, 4096, 100_000, 1_000_000])
def test_configs_field_for_field(n):
    ours, theirs = scale_step.scale_sim_config(n), jstep.scale_sim_config(n)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(scale.scale_config(n)) == dataclasses.asdict(
        jscale.scale_config(n))
    assert (ours.n_cells, ours.sync_tracks) == (theirs.n_cells, theirs.sync_tracks)
    assert scale._election_pri_bits(n) == jscale._election_pri_bits(n)


# --- lww ---------------------------------------------------------------------

def test_lex_wins_and_lex_max(arrays):
    _, _, vals, _ = arrays
    a = [vals % 3, vals % 5, vals % 2]
    b = [(vals // 3) % 3, (vals // 7) % 5, (vals // 11) % 2]
    assert same(jlww.lex_wins(a, b), lww.lex_wins([T(x) for x in a], [T(x) for x in b]))
    want = jlww.lex_max(a, b, (vals, vals + 1))
    got = lww.lex_max([T(x) for x in a], [T(x) for x in b], (T(vals), T(vals + 1)))
    assert all(same(w, g) for w, g in zip(want, got))
    inc = np.array([0, 1, 5, 7], np.int32)
    for s in (0, 1, 2):
        assert int(lww.pack_inc_state(7, s)) == int(jlww.pack_inc_state(7, s))
        assert same(jlww.unpack_inc_state(jnp.asarray(inc * 4 + s))[0],
                    lww.unpack_inc_state(T(inc * 4 + s))[0])


# --- dense -------------------------------------------------------------------

def test_lookup_and_select_cols(arrays, dense_form):
    table, idx, _, _ = arrays
    for fill in (0, -1):
        assert same(jdense.lookup_cols(table, idx, fill), dense.lookup_cols(T(table), T(idx), fill))
    assert same(jdense.select_cols(table, idx), dense.select_cols(T(table), T(idx)))


@pytest.mark.parametrize("op", ["scatter_cols_max", "scatter_cols_add", "scatter_cols_set"])
def test_scatter_cols(arrays, dense_form, op):
    table, idx, vals, valid = arrays
    want = getattr(jdense, op)(table, idx, vals, valid)
    assert same(want, getattr(dense, op)(T(table), T(idx), T(vals), T(valid)))
    # narrowed planes keep their dtype in the port (JAX's dense add sums
    # in int32; the value is the same)
    t16 = table.astype(jnp.int16)
    want = getattr(jdense, op)(t16, idx, vals % 300, valid).astype(jnp.int16)
    assert same(want, getattr(dense, op)(T(t16), T(idx), T(vals % 300), T(valid)))


def test_scatter_cols_or(arrays, dense_form):
    table, idx, vals, valid = arrays
    bits = (jnp.uint32(1) << (vals % 32).astype(jnp.uint32))
    base = table.astype(jnp.uint32) * jnp.uint32(0x01010101)
    want = jdense.scatter_cols_or(base, idx, bits, valid)
    assert same(want, dense.scatter_cols_or(T(base), T(idx), T(bits), T(valid)))


def test_apply_changes(dense_form):
    rng = np.random.default_rng(11)
    n, c, m = 48, 16, 20
    i32 = np.int32
    store = tuple(rng.integers(0, 4, (n, c)).astype(i32) for _ in range(5))
    cell = rng.integers(-1, c + 1, (n, m)).astype(i32)
    msg = [rng.integers(0, 4, (n, m)).astype(i32) for _ in range(5)]
    valid = rng.random((n, m)) < 0.8
    want = jax.jit(jdense.apply_changes)(store, cell, *msg, valid)
    got = dense.apply_changes(tuple(T(s) for s in store), T(cell),
                              *(T(x) for x in msg), T(valid))
    assert all(same(w, g) for w, g in zip(want, got))


def test_take_rows_clamps_past_the_end():
    table = np.arange(20, dtype=np.int32).reshape(5, 4)
    idx = np.array([[0, 4], [7, 2]], np.int32)
    want = jnp.asarray(table)[jnp.asarray(idx)]
    assert same(want, dense.take_rows(T(table), T(idx)))


# --- select / slots ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_k_and_sample_one(seed):
    key = jr.key(seed)
    mask = jr.uniform(jr.fold_in(key, 9), (40, 32)) < 0.3
    tk = prng.key(seed)
    for k in (1, 3, 8):
        want = jselect.sample_k(mask, k, key)
        got = select.sample_k(T(mask), k, tk)
        assert same(want[0], got[0]) and same(want[1], got[1])
    bonus = (jnp.arange(32) % 3).astype(jnp.float32)
    want = jselect.sample_k_biased(mask, bonus, 4, key)
    got = select.sample_k_biased(T(mask), T(bonus), 4, tk)
    assert same(want[0], got[0]) and same(want[1], got[1])
    want = jselect.sample_one(mask, key)
    got = select.sample_one(T(mask), tk)
    assert same(want[0], got[0]) and same(want[1], got[1])


def test_budget_mask_alloc_and_scatter_rows(dense_form):
    rng = np.random.default_rng(4)
    n, q, m = 50, 32, 16
    live = rng.random((n, q)) < 0.6
    prio = rng.integers(0, 5, (n, q)).astype(np.int16)
    allowed = rng.integers(0, 12, (n,)).astype(np.int32)
    assert same(jax.jit(jslots.budget_mask)(live, prio, allowed),
                slots.budget_mask(T(live), T(prio), T(allowed)))
    assert same(jax.jit(jslots.budget_mask, static_argnums=2)(live, prio, 6),
                slots.budget_mask(T(live), T(prio), 6))
    want_w = rng.random((n, m)) < 0.5
    free = ~live
    ws, wp = jax.jit(jslots.alloc_slots_evict)(free, prio, want_w)
    gs, gp = slots.alloc_slots_evict(T(free), T(prio), T(want_w))
    assert same(wp, gp) and same(jnp.where(wp, ws, 0), torch.where(gp, gs, 0))
    vals = rng.integers(0, 99, (n, m)).astype(np.int32)
    dest = np.zeros((n, q), np.int16)
    assert same(jax.jit(jslots.scatter_rows)(dest, ws, wp, vals),
                slots.scatter_rows(T(dest), gs, gp, T(vals)))


# --- versions / partials -----------------------------------------------------

_record = jax.jit(lambda b, o, v, ok, now: jversions.record_versions(
    b, o, v, ok, now=now, keep_rounds=2)[0])


def _book(seed, n=24, o=4, slots_=64, rounds=6, batch=8, max_ver=40):
    """A JAX Book grown by record_versions (out-of-order, gaps, dupes)."""
    rng = np.random.default_rng(seed)
    book = jversions.Book.create(n, o, slots_)
    for r in range(rounds):
        origin = jnp.asarray(rng.integers(0, 2 * o, (n, batch)), jnp.int32)
        ver = jnp.asarray(rng.integers(1, max_ver, (n, batch)), jnp.int32)
        valid = jnp.asarray(rng.random((n, batch)) < 0.7)
        book = _record(book, origin, ver, valid, jnp.int32(r))
    return book


def _tbook(book):
    return versions.Book(*(T(x) for x in book))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_book_ops(seed, dense_form):
    book = _book(seed)
    tb = _tbook(book)
    assert same(jax.jit(jversions.needs_count)(book), versions.needs_count(tb))
    assert same(jax.jit(jversions._trailing_ones)(book.seen),
                versions._trailing_ones(tb.seen))
    t = jnp.asarray(np.random.default_rng(seed).integers(0, 80, book.head.shape), jnp.int32)
    assert same(jax.jit(jversions._shift_right)(book.seen, t),
                versions._shift_right(tb.seen, T(t)))
    for want, got in zip(jax.jit(jversions.advance_heads)(book), versions.advance_heads(tb)):
        assert same(want, got)
    new_head = book.head + (t % 9)
    for want, got in zip(jax.jit(jversions.raise_heads)(book, new_head),
                         versions.raise_heads(tb, T(new_head))):
        assert same(want, got)
    origin = jnp.asarray(np.random.default_rng(seed + 7).integers(-1, 12, (24, 6)), jnp.int32)
    ws, wo = jax.jit(jversions.org_slot)(book, origin)
    gs, go = versions.org_slot(tb, T(origin))
    assert same(ws, gs) and same(wo, go)


@pytest.mark.parametrize("seed", [0, 3])
def test_claim_slots_arrays(seed, dense_form):
    book = _book(seed)
    n, o, w = book.seen.shape
    rng = np.random.default_rng(seed)
    origin = jnp.asarray(rng.integers(-1, 3 * o, (n, 8)), jnp.int32)
    fresh = jnp.asarray(rng.random((n, 8)) < 0.6)
    org_last = jnp.asarray(rng.integers(0, 10, (n, o)), jnp.int32)
    claim = jax.jit(jversions.claim_slots_arrays, static_argnums=(8, 9))
    for now in (3, 20):
        want = claim(
            book.head, book.known_max, book.seen.reshape(n, o * w), book.org_id,
            org_last, origin, fresh, jnp.int32(now), 4, w)
        got = versions.claim_slots_arrays(
            T(book.head), T(book.known_max), T(book.seen.reshape(n, o * w)),
            T(book.org_id), T(org_last), T(origin), T(fresh),
            torch.tensor(now, dtype=torch.int32), 4, w)
        assert all(same(a, b) for a, b in zip(want, got))


def test_drop_stale_partials(dense_form):
    book = _book(5)
    n = book.head.shape[0]
    rng = np.random.default_rng(5)
    par = jpartials.Partials.create(n, 6, 3)
    par = par._replace(
        origin=jnp.asarray(rng.integers(-1, 8, (n, 6)), jnp.int32),
        dbv=jnp.asarray(rng.integers(0, 20, (n, 6)), jnp.int32),
        mask=jnp.asarray(rng.integers(0, 8, (n, 6)), jnp.int32),
        nseq=jnp.asarray(rng.integers(0, 4, (n, 6)), jnp.int32),
    )
    want = jax.jit(jpartials.drop_stale_partials)(par, book)
    got = partials.drop_stale_partials(partials.Partials(*(T(x) for x in par)), _tbook(book))
    assert all(same(a, b) for a, b in zip(want, got))


# --- transport ---------------------------------------------------------------

def test_transport_cards_and_links():
    n = 40
    jnet = jtransport.NetModel.create(n, drop_prob=0.3, n_regions=5)
    jnet = jnet._replace(partition=(jnp.arange(n) % 3).astype(jnp.int32))
    tnet = transport.NetModel(*(T(x) for x in jnet))
    alive = jnp.arange(n) % 7 != 0
    inc = jnp.arange(n, dtype=jnp.int32) % 4
    jcard = jtransport.link_card(jnet, alive, extra=(inc,))
    tcard = transport.link_card(tnet, T(alive), extra=(T(inc),))
    assert same(jcard, tcard)
    idx = jr.randint(jr.key(2), (n, 3), 0, n, dtype=jnp.int32)
    jpeer = jtransport.card_at(jcard, idx)
    tpeer = transport.card_at(tcard, T(idx))
    assert same(jpeer, tpeer)
    key, tkey = jr.key(8), prng.key(8)
    want = jax.jit(lambda net, key, a, b: (
        jtransport.datagram_ok_c(net, key, a, b), jtransport.bi_ok_c(net, key, a, b),
        jtransport.ring_of_c(net, a, b)))(jnet, key, jcard[:, None, :], jpeer)
    got = (transport.datagram_ok_c(tnet, tkey, tcard[:, None, :], tpeer),
           transport.bi_ok_c(tnet, tkey, tcard[:, None, :], tpeer),
           transport.ring_of_c(tnet, tcard[:, None, :], tpeer))
    assert all(same(w, g) for w, g in zip(want, got))
