"""The kernel forms of the 1M-node configuration against the JAX package:
the swim kernel's packed-entry form (``pig_members > 0``) and its int8
budget tier (``narrow_int8``), the ingest kernel's int8 queue-counter tier
(``narrow_q_int8``), and the whole round under each of them, alone and
combined. Exact equality (tolerance 0): the plain kernel versions against
the pallas kernels in interpret mode, and the port's ``scale_run_rounds``
on the CPU against the JAX package's ``scale_run_rounds_carry``
(``fused="off"``), every state leaf and info value after every round.

The CUDA forms run only on the card: ``chip_smoke.py`` holds each one
bitwise against these plain versions there."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import megakernel as jmk
from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.ops import megakernel as mk
from corrosion_tpu_torch.sim import scale_step
from test_torch_kernels import (
    N_INGEST,
    T,
    _jax_args,
    _torch_args,
    leaves_equal,
    random_messages,
    random_state,
    swim_operands,
)
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

# --- K1: packed entries and the int8 budget tier -----------------------------


def packed_operands(rng, n, m, k, timer_dtype, tx_dtype):
    """swim operands whose four channels are packed [n, k] entry lists. Ids
    range over a few multiples of m, so entries of one packet often share a
    hash class, and views hit every state."""
    ops = list(swim_operands(rng, n, m))
    ops[4] = ops[4].astype(timer_dtype)
    ops[5] = ops[5].astype(tx_dtype)
    hi = 3 * m
    ops[15] = [np.where(rng.random((n, k)) < 0.15, -1,
                        rng.integers(0, hi, (n, k))).astype(np.int32) for _ in range(4)]
    ops[16] = [rng.integers(-1, 64, (n, k)).astype(np.int32) for _ in range(4)]
    ops[17] = [np.ones((n, k), bool) for _ in range(4)]
    return tuple(ops)


def _same_outputs(want, got):
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, (a.dtype, b.dtype)
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("timer_dtype,tx_dtype", [
    (np.int16, np.int8), (np.int16, np.int16), (np.int32, np.int32)])
def test_swim_packed_plain_matches_pallas_kernel_interpret(timer_dtype, tx_dtype):
    n, m, k = 64, 8, 4
    ops = packed_operands(np.random.default_rng(11), n, m, k, timer_dtype, tx_dtype)
    consts = (m, 6, 48, 10, k)
    want = jmk.swim_tables_fused(consts, *_jax_args(ops), interpret=True)
    got = mk.swim_tables_fused(consts, *_torch_args(ops))
    _same_outputs(want, got)


def test_packed_operands_collide_within_a_packet():
    """The packed inputs above do put two live entries of one packet in one
    hash class, which is where applying the entries in order matters."""
    n, m, k = 64, 8, 4
    ops = packed_operands(np.random.default_rng(11), n, m, k, np.int16, np.int8)
    ids = ops[15][0]
    cls = np.where(ids >= 0, ids % m, -1 - np.arange(k)[None, :])
    assert (np.sort(cls, axis=1)[:, 1:] == np.sort(cls, axis=1)[:, :-1]).any()


def test_swim_aligned_int8_tx_plain_matches_pallas_kernel_interpret():
    n, m = 64, 16
    ops = list(swim_operands(np.random.default_rng(12), n, m))
    ops[5] = ops[5].astype(np.int8)
    consts = (m, 6, 48, 10, 0)
    want = jmk.swim_tables_fused(consts, *_jax_args(ops), interpret=True)
    got = mk.swim_tables_fused(consts, *_torch_args(ops))
    assert got[3].dtype == torch.int8
    _same_outputs(want, got)


# --- K2 / K3: int8 q_tx --------------------------------------------------------


def _int8_q_state(seed):
    cfg, st, tcfg, tst = random_state(seed, narrow_q_int8=True)
    q_tx = np.asarray(st.crdt.q_tx).astype(np.int8)
    st = st._replace(crdt=st.crdt._replace(q_tx=jnp.asarray(q_tx)))
    tst = tst._replace(crdt=tst.crdt._replace(q_tx=T(q_tx)))
    assert tst.crdt.q_cell.dtype == torch.int16 and tst.crdt.q_tx.dtype == torch.int8
    return cfg, st, tcfg, tst


def test_ingest_int8_q_plain_matches_pallas_kernel_interpret():
    cfg, st, tcfg, tst = _int8_q_state(20)
    live, msgs = random_messages(21, N_INGEST, 4 * cfg.pig_changes)
    want_cst, want_info = jmk.ingest_changes_fused(
        cfg, st.crdt, jnp.asarray(live), *map(jnp.asarray, msgs), interpret=True)
    got_cst, got_info = mk.ingest_changes_fused(tcfg, tst.crdt, T(live), *map(T, msgs))
    assert got_cst.q_tx.dtype == torch.int8
    leaves_equal(want_cst, got_cst)
    for k in want_info:
        assert int(want_info[k]) == int(got_info[k]), k


def test_local_write_emit_int8_q_plain_matches_pallas_kernel_interpret():
    cfg, st, tcfg, tst = _int8_q_state(22)
    rng = np.random.default_rng(23)
    n, q = N_INGEST, cfg.bcast_queue
    wm = rng.random(n) < 0.6
    cell = rng.integers(0, cfg.n_cells, n).astype(np.int32)
    val = rng.integers(0, 1 << 20, n).astype(np.int32)
    clp = rng.integers(0, 2, n).astype(np.int32)
    rand = rng.random((n, q)).astype(np.float32)
    carried = rng.integers(0, 5, n).astype(np.int32)
    want_cst, want_emit = jmk.local_write_fused(
        cfg, st.crdt, *map(jnp.asarray, (wm, cell, val, clp)),
        rand=jnp.asarray(rand), carried=jnp.asarray(carried), interpret=True)
    got_cst, got_emit = mk.local_write_fused(
        tcfg, tst.crdt, *map(T, (wm, cell, val, clp)), rand=T(rand), carried=T(carried))
    leaves_equal(want_cst, got_cst)
    for a, b in zip(want_emit, got_emit):
        assert np.array_equal(np.asarray(a), b.numpy())


# --- the whole round -------------------------------------------------------------

N, ROUNDS = 256, 12
BASE = dict(sync_interval=2, sync_sweep_every=2)
VARIANTS = {
    "pig4": dict(pig_members=4),
    "pig4-int8": dict(pig_members=4, narrow_int8=True, narrow_q_int8=True),
    "aligned-int8": dict(narrow_int8=True, narrow_q_int8=True),
    "aligned-int8tx": dict(narrow_int8=True),
    "aligned-int8q": dict(narrow_q_int8=True),
}


def _jax_inputs(cfg):
    wm = jr.uniform(jr.key(9), (ROUNDS, N)) < 0.1
    inp = jstep.make_write_inputs(cfg, jr.key(5), ROUNDS, wm)
    kill = np.zeros((ROUNDS, N), bool)
    revive = np.zeros((ROUNDS, N), bool)
    kill[3, 10:20] = True
    revive[7, 10:15] = True
    return inp._replace(kill=jnp.asarray(kill), revive=jnp.asarray(revive))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def reference(request):
    """One variant's JAX trajectory, one round per call of the scan entry
    point, and the port's converted start."""
    over = {**BASE, **VARIANTS[request.param]}
    cfg = jstep.scale_sim_config(N, fused="off", **over)
    st = jstep.ScaleSimState.create(cfg)
    net = JNet.create(N, drop_prob=0.05)
    key = jr.key(3)
    inputs = _jax_inputs(cfg)
    tcfg = scale_step.scale_sim_config(N, **over)
    start = (
        tcfg,
        convert.scale_state_from_numpy(tcfg, convert.as_numpy_tree(st), "cpu"),
        convert.net_from_numpy(convert.as_numpy_tree(net), "cpu"),
        convert.key_from_numpy(np.asarray(jr.key_data(key))),
        convert.round_input_from_numpy(scale_step.ScaleRoundInput, convert.as_numpy_tree(inputs), "cpu"),
    )
    run = jax.jit(lambda s, k, i: jstep.scale_run_rounds_carry(cfg, s, net, k, i))
    states, infos = [], []
    for r in range(ROUNDS):
        (st, key), info = run(st, key, jax.tree.map(lambda a: a[r:r + 1], inputs))
        states.append(jax.tree.leaves(convert.as_numpy_tree(st)))
        infos.append({k: int(np.asarray(v)[0]) for k, v in info.items()})
    return request.param, start, states, infos


def test_variant_every_round_bitwise_equal_to_jax(reference):
    name, (cfg, st, net, key, inputs), states, infos = reference
    for r in range(ROUNDS):
        one = scale_step.ScaleRoundInput(*(a[r:r + 1] for a in inputs))
        (st, key), info = scale_step.scale_run_rounds_carry(cfg, st, net, key, one)
        got = jax.tree.leaves(convert.state_to_numpy(st))
        assert len(got) == len(states[r]), name
        for i, (a, b) in enumerate(zip(states[r], got)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, r, i, a.dtype, b.dtype)
            assert np.array_equal(a, b), (name, r, i)
        assert {k: int(v[0]) for k, v in info.items()} == infos[r], (name, r)


def test_variant_planes_carry_their_tiers(reference):
    name, (cfg, st, net, key, inputs), _, infos = reference
    st, _ = scale_step.scale_run_rounds(cfg, st, net, key, inputs)
    tiers = VARIANTS[name]
    assert st.swim.mem_tx.dtype == (torch.int8 if tiers.get("narrow_int8") else torch.int16)
    assert st.crdt.q_tx.dtype == (torch.int8 if tiers.get("narrow_q_int8") else torch.int16)
    assert st.crdt.q_seq.dtype == st.crdt.q_tx.dtype == st.crdt.q_nseq.dtype
    assert st.crdt.q_cell.dtype == torch.int16
    # the trajectory exercises the paths: gossip moved, writes spread
    assert sum(i["fresh"] for i in infos) > 0 and sum(i["syncs"] for i in infos) > 0


def test_bounded_piggyback_changes_the_round():
    """pig_members > 0 is a different protocol (bounded packets), not an
    execution knob: its tables differ from the aligned-row round's."""
    out = {}
    for k in (0, 4):
        cfg = scale_step.scale_sim_config(64, pig_members=k, **BASE)
        st, net, key, inputs = scale_step.flagship_workload(cfg, 4, "cpu")
        st, _ = scale_step.scale_run_rounds(cfg, st, net, key, inputs)
        out[k] = st.swim
    assert not torch.equal(out[0].mem_tx, out[4].mem_tx)
