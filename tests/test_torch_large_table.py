"""The large table: a 1025x4 = 4,100-cell store row, past the ingest
kernel's 256 staged cells (its row-in-global-memory form on the card) and
not a multiple of 32. The port's ``scale_run_rounds_carry`` on the CPU
(plain kernel versions) against the JAX package's (its XLA path,
``fused="off"``) from identical converted state, net, key and inputs:
every state leaf and every round-info value bitwise equal after every
round, with cells past 256 written and a sync round held."""

import jax
import jax.random as jr
import numpy as np
import pytest

from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.sim import scale_step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N, ROUNDS = 256, 4
OVER = dict(n_rows=1025, n_cols=4, sync_interval=2, sync_sweep_every=2)
STAGED_CELLS = 256  # the CUDA kernel's shared-memory row


@pytest.fixture(scope="module")
def reference():
    """The JAX trajectory, one round per call of the scan entry point, with
    a quarter of the nodes writing each round (the 16 origins among them)."""
    cfg = jstep.scale_sim_config(N, fused="off", **OVER)
    st = jstep.ScaleSimState.create(cfg)
    net = JNet.create(N, drop_prob=0.05)
    key = jr.key(3)
    wm = jr.uniform(jr.key(9), (ROUNDS, N)) < 0.25
    inputs = jstep.make_write_inputs(cfg, jr.key(5), ROUNDS, wm)
    start = dict(state=convert.as_numpy_tree(st), net=convert.as_numpy_tree(net),
                 key=np.asarray(jr.key_data(key)), inputs=convert.as_numpy_tree(inputs))
    run = jax.jit(lambda s, k, i: jstep.scale_run_rounds_carry(cfg, s, net, k, i))
    states, infos = [], []
    for r in range(ROUNDS):
        (st, key), info = run(st, key, jax.tree.map(lambda a: a[r:r + 1], inputs))
        states.append(jax.tree.leaves(convert.as_numpy_tree(st)))
        infos.append({k: int(np.asarray(v)[0]) for k, v in info.items()})
    return start, states, infos


@pytest.fixture(scope="module")
def port_rounds(reference):
    """The port's rounds from the same start: (state leaves, infos, state)
    after each round."""
    start, _, _ = reference
    cfg = scale_step.scale_sim_config(N, **OVER)
    st = convert.scale_state_from_numpy(cfg, start["state"], "cpu")
    net = convert.net_from_numpy(start["net"], "cpu")
    key = convert.key_from_numpy(start["key"])
    inputs = convert.round_input_from_numpy(scale_step.ScaleRoundInput, start["inputs"], "cpu")
    out = []
    for r in range(ROUNDS):
        one = scale_step.ScaleRoundInput(*(a[r:r + 1] for a in inputs))
        (st, key), info = scale_step.scale_run_rounds_carry(cfg, st, net, key, one)
        out.append((jax.tree.leaves(convert.state_to_numpy(st)),
                    {k: int(v[0]) for k, v in info.items()}, st))
    return out


@pytest.mark.parametrize("r", range(ROUNDS))
def test_round_bitwise_equal_to_jax(reference, port_rounds, r):
    _, states, infos = reference
    got, info, _ = port_rounds[r]
    assert len(got) == len(states[r])
    for i, (a, b) in enumerate(zip(states[r], got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (r, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (r, i)
    assert info == infos[r]


def test_cells_past_the_staged_row_are_written(reference, port_rounds):
    """The store is 4,100 cells wide, cells past 256 hold writes by the end,
    writes were fresh somewhere, and the run held a sync round."""
    _, _, infos = reference
    ver = port_rounds[-1][2].crdt.store[0]
    assert ver.shape == (N, 4100)
    assert int((ver[:, STAGED_CELLS:] > 0).sum()) > 0
    assert sum(i["fresh"] for i in infos) > 0
    assert sum(i["syncs"] for i in infos) > 0
