"""The wide member table: 256 member slots a node (``m_slots=256``), past the
swim kernel's register form (128 slots; its wide form on the card), at the
flagship's other knobs, in the aligned form and packed under the 1M point's
tiers (``pig_members=16``, ``narrow_int8``, ``narrow_q_int8``). The port's
``scale_run_rounds_carry`` on the CPU (plain kernel versions) against the
JAX package's (its XLA path, ``fused="off"``) from identical converted
state, net, key and inputs, a quarter of the origins writing each round:
every state leaf and every round-info value bitwise equal after every
round, with rows holding an occupied slot at or past 128, a sync round, and
the swim function called at m = 256 once a round."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.ops import megakernel
from corrosion_tpu_torch.sim import scale_step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N, M = 256, 256
REGISTER_SLOTS = 128  # the CUDA kernel's register form; past it the wide form
SYNC = dict(sync_interval=2, sync_sweep_every=2)
# form: (overrides, rounds)
FORMS = {"aligned": (dict(m_slots=M, **SYNC), 8),
         "packed": (dict(m_slots=M, pig_members=16, narrow_int8=True, narrow_q_int8=True,
                         **SYNC), 6)}


def _past_register(mem_id) -> int:
    """Rows with an occupied member slot at or past REGISTER_SLOTS."""
    return int((np.asarray(mem_id)[:, REGISTER_SLOTS:] >= 0).any(axis=1).sum())


def _reference(over, rounds):
    """The JAX trajectory, one round per call of the scan entry point, and
    the rows past REGISTER_SLOTS after each round."""
    cfg = jstep.scale_sim_config(N, fused="off", **over)
    st = jstep.ScaleSimState.create(cfg)
    net = JNet.create(N, drop_prob=0.05)
    key = jr.key(3)
    writer = jnp.arange(N) < cfg.n_origins
    wm = (jr.uniform(jr.key(9), (rounds, N)) < 0.25) & writer[None, :]
    inputs = jstep.make_write_inputs(cfg, jr.key(5), rounds, wm)
    start = dict(state=convert.as_numpy_tree(st), net=convert.as_numpy_tree(net),
                 key=np.asarray(jr.key_data(key)), inputs=convert.as_numpy_tree(inputs))
    run = jax.jit(lambda s, k, i: jstep.scale_run_rounds_carry(cfg, s, net, k, i))
    states, infos, past = [], [], []
    for r in range(rounds):
        (st, key), info = run(st, key, jax.tree.map(lambda a: a[r:r + 1], inputs))
        states.append(jax.tree.leaves(convert.as_numpy_tree(st)))
        infos.append({k: int(np.asarray(v)[0]) for k, v in info.items()})
        past.append(_past_register(st.swim.mem_id))
    return start, states, infos, past


def _port(start, over, rounds):
    """The port's rounds from the same start: (state leaves, infos, rows
    past REGISTER_SLOTS) after each round, and each swim call's (m, pig_k),
    read through a wrapped plain version."""
    cfg = scale_step.scale_sim_config(N, **over)
    st = convert.scale_state_from_numpy(cfg, start["state"], "cpu")
    net = convert.net_from_numpy(start["net"], "cpu")
    key = convert.key_from_numpy(start["key"])
    inputs = convert.round_input_from_numpy(scale_step.ScaleRoundInput, start["inputs"], "cpu")
    plain, calls = megakernel.swim_tables_plain, []

    def counting(consts, *args):
        calls.append((consts[0], consts[4] if len(consts) > 4 else 0))
        return plain(consts, *args)

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(megakernel, "swim_tables_plain", counting)
        for r in range(rounds):
            one = scale_step.ScaleRoundInput(*(a[r:r + 1] for a in inputs))
            (st, key), info = scale_step.scale_run_rounds_carry(cfg, st, net, key, one)
            out.append((jax.tree.leaves(convert.state_to_numpy(st)),
                        {k: int(v[0]) for k, v in info.items()},
                        _past_register(st.swim.mem_id.numpy())))
    return out, calls


@pytest.fixture(scope="module")
def trajectories():
    """The JAX and the port's trajectories of a form, each run once."""
    runs = {}

    def get(form):
        if form not in runs:
            over, rounds = FORMS[form]
            start, states, infos, past = _reference(over, rounds)
            runs[form] = (states, infos, past, *_port(start, over, rounds))
        return runs[form]

    return get


@pytest.mark.parametrize("form,r", [(f, r) for f, (_, rounds) in FORMS.items()
                                    for r in range(rounds)])
def test_round_bitwise_equal_to_jax(trajectories, form, r):
    states, infos, past, port, _ = trajectories(form)
    got, info, got_past = port[r]
    assert len(got) == len(states[r])
    for i, (a, b) in enumerate(zip(states[r], got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (r, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (r, i)
    assert info == infos[r]
    assert got_past == past[r]


@pytest.mark.parametrize("form", list(FORMS))
def test_rows_past_128_slots_sync_and_wide_calls(trajectories, form):
    """Rows hold occupied slots at or past 128, the run held a sync round,
    and the swim function ran once a round at m = 256 (with 16 entries a
    packet in the packed form)."""
    _, infos, past, _, calls = trajectories(form)
    k = FORMS[form][0].get("pig_members", 0)
    assert calls == [(M, k)] * len(infos)
    assert min(past) > 0, past
    assert sum(i["syncs"] for i in infos) > 0
