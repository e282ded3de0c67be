"""The quiet round (``quiet="on"``, ``scale_sim_step_quiet``) on the CPU:
the port against the JAX package's quiet round, and against the port's own
dense round (``quiet="off"``), on a settled trace, a seeded-write trace and
a kill/revive churn trace. Exact equality: the final state's every leaf
and every round's info values."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.sim import scale_step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N, ROUNDS = 48, 48
SHAPE = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=4)
KINDS = ("quiet", "seeded", "churn")


def _trace(cfg, kind, rounds=ROUNDS, seed=7):
    """The settled, seeded-write and churn traces of the JAX package's own
    quiet tests."""
    n = cfg.n_nodes
    key = jr.key(seed)
    w = jnp.zeros((rounds, n), bool)
    if kind != "quiet":
        w = ((jr.uniform(key, (rounds, n)) < 0.3)
             & (jnp.arange(n) < cfg.n_origins)[None, :]
             & (jnp.arange(rounds) < 10)[:, None])
    inputs = jstep.make_write_inputs(cfg, jr.fold_in(key, 1), rounds, w)
    if kind == "churn":
        kill = jnp.zeros((rounds, n), bool).at[2, n - 1].set(True)
        revive = jnp.zeros((rounds, n), bool).at[rounds // 2, n - 1].set(True)
        inputs = inputs._replace(kill=kill, revive=revive)
    return inputs


@pytest.fixture(scope="module")
def jax_quiet():
    """The JAX quiet round's final state and infos on every trace (one
    compile, reused)."""
    cfg = jstep.scale_sim_config(N, quiet="on", fused="off", **SHAPE)
    run = jax.jit(lambda st, key, inp: jstep.scale_run_rounds(
        cfg, st, JNet.create(N), key, inp))
    out = {}
    for kind in KINDS:
        inputs = _trace(cfg, kind)
        st, infos = run(jstep.ScaleSimState.create(cfg), jr.key(0), inputs)
        out[kind] = (convert.as_numpy_tree(inputs),
                     jax.tree.leaves(convert.as_numpy_tree(st)),
                     {k: np.asarray(v) for k, v in infos.items()})
    return out


def _port(inputs, quiet):
    cfg = scale_step.scale_sim_config(N, quiet=quiet, **SHAPE)
    st = scale_step.ScaleSimState.create(cfg, "cpu")
    net = scale_step.NetModel.create(N, device="cpu")
    key = convert.key_from_numpy(np.asarray(jr.key_data(jr.key(0))))
    st, infos = scale_step.scale_run_rounds(
        cfg, st, net, key, convert.round_input_from_numpy(scale_step.ScaleRoundInput, inputs, "cpu"))
    return jax.tree.leaves(convert.state_to_numpy(st)), {
        k: v.numpy() for k, v in infos.items()}


@pytest.fixture(scope="module")
def port_runs(jax_quiet):
    return {(kind, q): _port(jax_quiet[kind][0], q)
            for kind in KINDS for q in ("on", "off")}


def _leaves_equal(want, got, label):
    assert len(want) == len(got), label
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (label, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (label, i)


@pytest.mark.parametrize("kind", KINDS)
def test_quiet_round_equals_jax_quiet_round(jax_quiet, port_runs, kind):
    _, want_leaves, want_infos = jax_quiet[kind]
    got_leaves, got_infos = port_runs[(kind, "on")]
    _leaves_equal(want_leaves, got_leaves, kind)
    assert sorted(want_infos) == sorted(got_infos)
    for k, v in want_infos.items():
        assert np.array_equal(v.astype(np.int64), got_infos[k].astype(np.int64)), (kind, k)


@pytest.mark.parametrize("kind", KINDS)
def test_quiet_round_equals_dense_round(port_runs, kind):
    q_leaves, q_infos = port_runs[(kind, "on")]
    d_leaves, d_infos = port_runs[(kind, "off")]
    _leaves_equal(d_leaves, q_leaves, kind)
    assert "quiet_round" not in d_infos
    for k, v in d_infos.items():
        assert np.array_equal(v, q_infos[k]), (kind, k)


def test_quiet_round_takes_the_cheap_branch(port_runs):
    """The settled trace settles: after the cold start most rounds off the
    sync schedule are fixpoint rounds; every sync round is a backstop."""
    _, infos = port_runs[("quiet", "on")]
    qr = infos["quiet_round"]
    assert int(qr[ROUNDS // 2:].sum()) > ROUNDS // 4
    assert int(infos["quiet_backstop"].sum()) > 0
    assert int(infos["quiet_shards_skipped"].sum()) == int(qr.sum())
    assert int(qr.sum()) + int(infos["quiet_backstop"].sum()) <= ROUNDS
    # a churn trace takes the dense branch while the kill is news
    _, churn = port_runs[("churn", "on")]
    assert not churn["quiet_round"][2:6].any()


def test_quiet_round_with_the_1m_tiers_equals_jax_and_dense():
    """The quiet round composed with bounded member piggyback and both int8
    tiers (the 1M configuration's settings), on the seeded-write trace."""
    tiers = dict(pig_members=4, narrow_int8=True, narrow_q_int8=True, **SHAPE)
    cfg = jstep.scale_sim_config(N, quiet="on", fused="off", **tiers)
    inputs = _trace(cfg, "seeded")
    st, infos = jax.jit(lambda st, key, inp: jstep.scale_run_rounds(
        cfg, st, JNet.create(N), key, inp))(jstep.ScaleSimState.create(cfg), jr.key(0), inputs)
    got = {}
    for quiet in ("on", "off"):
        tcfg = scale_step.scale_sim_config(N, quiet=quiet, **tiers)
        tst, tinfos = scale_step.scale_run_rounds(
            tcfg, scale_step.ScaleSimState.create(tcfg, "cpu"),
            scale_step.NetModel.create(N, device="cpu"),
            convert.key_from_numpy(np.asarray(jr.key_data(jr.key(0)))),
            convert.round_input_from_numpy(scale_step.ScaleRoundInput, convert.as_numpy_tree(inputs), "cpu"))
        got[quiet] = (jax.tree.leaves(convert.state_to_numpy(tst)), tinfos)
    _leaves_equal(jax.tree.leaves(convert.as_numpy_tree(st)), got["on"][0], "jax")
    _leaves_equal(got["off"][0], got["on"][0], "dense")
    assert any(a.dtype == np.int8 for a in got["on"][0])
    for k, v in infos.items():
        assert np.array_equal(np.asarray(v).astype(np.int64), got["on"][1][k].numpy()), k
    assert int(got["on"][1]["quiet_round"].sum()) > 0


def test_quiet_auto_runs_the_dense_round(jax_quiet):
    inputs = jax_quiet["quiet"][0]
    cfg = scale_step.scale_sim_config(N, quiet="auto", **SHAPE)
    st = scale_step.ScaleSimState.create(cfg, "cpu")
    net = scale_step.NetModel.create(N, device="cpu")
    one = convert.round_input_from_numpy(scale_step.ScaleRoundInput, inputs, "cpu")
    one = scale_step.ScaleRoundInput(*(a[:2] for a in one))
    key = convert.key_from_numpy(np.asarray(jr.key_data(jr.key(0))))
    _, infos = scale_step.scale_run_rounds(cfg, st, net, key, one)
    assert "quiet_round" not in infos
