"""The wide packet: the deep queue (256 tracked origins, 64x4 cells, 128
queue slots, a 256-version seen window) with 64 changes a packet, so that
the scale round's receive batch is 4 x 64 = 256 messages and the emitting
local write picks up to 64 queue slots, past the ingest kernel's register
batch (128 messages) and its one pick a lane (32; its long form on the
card), under a write burst: a quarter of the nodes write each round. The
port's ``scale_run_rounds_carry`` on the CPU (plain kernel versions)
against the JAX package's (its XLA path, ``fused="off"``) from identical
converted state, net, key and inputs: every state leaf and every
round-info value bitwise equal after every round, with rows that picked
more than 32 live queue slots and a sync round held."""

import jax
import jax.random as jr
import numpy as np
import pytest

from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.ops import megakernel
from corrosion_tpu_torch.sim import scale_step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N, ROUNDS = 256, 10
PACKETS = dict(n_origins=256, n_rows=64, buf_slots=256, bcast_queue=128, pig_changes=64)
OVER = dict(**PACKETS, sync_interval=2, sync_sweep_every=2)
ONE_PICK = 32  # the CUDA kernel's picks of one a lane


@pytest.fixture(scope="module")
def reference():
    """The JAX trajectory, one round per call of the scan entry point, with
    a quarter of the nodes writing each round (every node is an origin)."""
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
    """The port's rounds from the same start: (state leaves, infos) after
    each round, and each ingest call's (picks, batch width, rows with more
    than ONE_PICK live picks, read from the plain version's ``sel_ok``)."""
    start, _, _ = reference
    cfg = scale_step.scale_sim_config(N, **OVER)
    st = convert.scale_state_from_numpy(cfg, start["state"], "cpu")
    net = convert.net_from_numpy(start["net"], "cpu")
    key = convert.key_from_numpy(start["key"])
    inputs = convert.round_input_from_numpy(scale_step.ScaleRoundInput, start["inputs"], "cpu")
    plain, calls = megakernel.ingest_plain, []

    def counting(p, x):
        out = plain(p, x)
        rows = int((out.sel_ok.sum(dim=1) > ONE_PICK).sum()) if p.pig_r else 0
        calls.append((p.pig_r, x.origin.shape[1], rows))
        return out

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(megakernel, "ingest_plain", counting)
        for r in range(ROUNDS):
            one = scale_step.ScaleRoundInput(*(a[r:r + 1] for a in inputs))
            (st, key), info = scale_step.scale_run_rounds_carry(cfg, st, net, key, one)
            out.append((jax.tree.leaves(convert.state_to_numpy(st)),
                        {k: int(v[0]) for k, v in info.items()}))
    return out, calls


@pytest.mark.parametrize("r", range(ROUNDS))
def test_round_bitwise_equal_to_jax(reference, port_rounds, r):
    _, states, infos = reference
    got, info = port_rounds[0][r]
    assert len(got) == len(states[r])
    for i, (a, b) in enumerate(zip(states[r], got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (r, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (r, i)
    assert info == infos[r]


def test_rows_pick_past_32_and_sync(reference, port_rounds):
    """The receive batch is 256 messages wide, one emitting call a round,
    rows picked more than 32 live queue slots, writes were fresh somewhere,
    and the run held a sync round."""
    _, _, infos = reference
    calls = port_rounds[1]
    assert sorted((r, m) for r, m, _ in calls) == [(0, 256)] * ROUNDS + [(64, 1)] * ROUNDS
    assert sum(rows for _, _, rows in calls) > 0, calls
    assert sum(i["fresh"] for i in infos) > 0
    assert sum(i["syncs"] for i in infos) > 0
