"""The full-view round: the port's ``run_rounds`` on the CPU (plain kernel
versions) against the JAX package's ``run_rounds_carry`` (its XLA path,
``fused="off"``), from identical converted state, nets, key and inputs, at
``wan_config(64, n_origins=8, tx_max_cells=1)``. Every state leaf and every
round-info value must be bitwise equal after every round (tolerance 0),
over 24 rounds of ``full_mix`` with 5 % message loss and a partition window
in rounds 8-15. Then its modules one by one: ``swim_step`` under kill,
revive and partition, ``bcast_step``, the slot primitives, the scenario
generators, and the plain ingest at ``recv_slots`` width with more recorded
messages than queue slots."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import slots as jslots
from corrosion_tpu.sim import broadcast as jbroadcast
from corrosion_tpu.sim import config as jconfig
from corrosion_tpu.sim import scenario as jscenario
from corrosion_tpu.sim import step as jstep
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.ops import megakernel as mk
from corrosion_tpu_torch.ops import slots
from corrosion_tpu_torch.sim import broadcast, config, scenario, step, swim
from corrosion_tpu_torch.sim.transport import NetModel
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N, ROUNDS = 64, 24
PARTITION = range(8, 16)  # rounds that run on the partitioned net
OVER = dict(n_origins=8, tx_max_cells=1)


def jcfg(**over):
    return jconfig.wan_config(N, fused="off", **{**OVER, **over})


def tcfg(**over):
    return config.wan_config(N, **{**OVER, **over})


def _nets():
    cfg = jcfg()
    return JNet.create(N, drop_prob=0.05), jscenario.partitioned_net(cfg, 2, 0.05)


def _leaves(st):
    return jax.tree.leaves(convert.state_to_numpy(st))


def _assert_leaves_equal(want, got, where):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, i)


def _t(x):
    return convert._t(np.asarray(x), "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX trajectory, one round per call of the scan entry point (one
    compile serves both nets)."""
    cfg = jcfg()
    st = jstep.SimState.create(cfg)
    nets = _nets()
    key = jr.key(3)
    inputs = jscenario.full_mix(cfg, ROUNDS, jr.key(5))
    start = dict(state=convert.as_numpy_tree(st), key=np.asarray(jr.key_data(key)),
                 inputs=convert.as_numpy_tree(inputs),
                 nets=[convert.as_numpy_tree(net) for net in nets])
    run = jax.jit(lambda s, k, i, net: jstep.run_rounds_carry(cfg, s, net, k, i))
    states, infos, jstates = [], [], []
    for r in range(ROUNDS):
        net = nets[r in PARTITION]
        (st, key), info = run(st, key, jax.tree.map(lambda a: a[r:r + 1], inputs), net)
        jstates.append(st)
        states.append(jax.tree.leaves(convert.as_numpy_tree(st)))
        infos.append({k: int(np.asarray(v)[0]) for k, v in info.items()})
    return start, states, infos, jstates


def _port_start(start):
    st = convert.full_state_from_numpy(tcfg(), start["state"], "cpu")
    nets = [convert.net_from_numpy(n, "cpu") for n in start["nets"]]
    key = convert.key_from_numpy(start["key"])
    inputs = convert.round_input_from_numpy(step.RoundInput, start["inputs"], "cpu")
    return st, nets, key, inputs


def _segment(inputs, lo, hi):
    return step.RoundInput(*(a[lo:hi] for a in inputs))


def test_every_round_bitwise_equal_to_jax(reference):
    start, states, infos, _ = reference
    st, nets, key, inputs = _port_start(start)
    for r in range(ROUNDS):
        (st, key), info = step.run_rounds_carry(tcfg(), st, nets[r in PARTITION], key,
                                                _segment(inputs, r, r + 1))
        _assert_leaves_equal(states[r], _leaves(st), f"round {r}")
        assert {k: int(v[0]) for k, v in info.items()} == infos[r], r


def test_reference_covers_churn_loss_partition_and_sync(reference):
    start, _, infos, _ = reference
    kill = start["inputs"]["kill"]
    assert kill.any() and start["inputs"]["revive"].any()
    assert sum(i["syncs"] for i in infos) > 0 and sum(i["cells_pulled"] for i in infos) > 0
    assert sum(i["fresh"] for i in infos) > 0 and sum(i["failed_probes"] for i in infos) > 0
    # the partition halves the cluster: probes across it fail
    assert min(infos[r]["failed_probes"] for r in PARTITION) > 0


@pytest.fixture(scope="module")
def port_segments(reference):
    """The port's multi-round calls: one ``run_rounds_carry`` per net
    window, the first window itself chained in two."""
    start, _, _, _ = reference
    st, nets, key, inputs = _port_start(start)
    out = []
    for lo, hi in ((0, 3), (3, 8), (8, 16), (16, 24)):
        (st, key), info = step.run_rounds_carry(tcfg(), st, nets[lo in PARTITION], key,
                                                _segment(inputs, lo, hi))
        out.append((hi, st, info))
    return out


def test_chained_segments_equal_straight_run(reference, port_segments):
    _, states, infos, _ = reference
    for hi, st, _ in port_segments:
        _assert_leaves_equal(states[hi - 1], _leaves(st), f"segment to {hi}")
    stacked = {k: torch.cat([i[k] for _, _, i in port_segments]) for k in infos[0]}
    for k in infos[0]:
        assert [int(v) for v in stacked[k]] == [i[k] for i in infos], k
    # run_rounds over the first window in one call equals the two chained
    start, _, _, _ = reference
    st, nets, key, inputs = _port_start(start)
    st, _ = step.run_rounds(tcfg(), st, nets[0], key, _segment(inputs, 0, 8))
    _assert_leaves_equal(states[7], _leaves(st), "run_rounds to 8")


def test_sweep_rounds_match_jax():
    """With a sweep lane (``sync_sweep_every > 0``) the sweep predicate reads
    the host mirror of the round counter; chained segments keep it in step
    with JAX's traced counter."""
    over = dict(sync_interval=2, sync_sweep_every=2)
    cfg = jcfg(**over)
    st = jstep.SimState.create(cfg)
    net = JNet.create(N, drop_prob=0.05)
    inputs = jscenario.full_mix(cfg, 8, jr.key(6), write_prob=0.5)
    want, winfo = jax.jit(lambda s, i: jstep.run_rounds(cfg, s, net, jr.key(7), i))(st, inputs)
    tst = convert.full_state_from_numpy(tcfg(**over), convert.as_numpy_tree(st), "cpu")
    tnet = convert.net_from_numpy(convert.as_numpy_tree(net), "cpu")
    tin = convert.round_input_from_numpy(step.RoundInput, convert.as_numpy_tree(inputs), "cpu")
    carry = (tst, convert.key_from_numpy(jr.key_data(jr.key(7))))
    infos = []
    for lo, hi in ((0, 3), (3, 8)):
        carry, info = step.run_rounds_carry(tcfg(**over), *carry[:1], tnet, carry[1],
                                            _segment(tin, lo, hi))
        infos.append(info)
    _assert_leaves_equal(jax.tree.leaves(convert.as_numpy_tree(want)), _leaves(carry[0]), "sweep")
    for k, v in winfo.items():
        assert np.asarray(v).tolist() == torch.cat([i[k] for i in infos]).tolist(), k
    assert int(np.asarray(winfo["cells_pulled"]).sum()) > 0


def test_crdt_metrics_match_jax(reference, port_segments):
    _, _, _, jstates = reference
    want = jstep.crdt_metrics(jcfg(), jstates[-1])
    got = step.crdt_metrics(tcfg(), port_segments[-1][1])
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        v, g = np.asarray(v), got[k].numpy()
        if v.dtype == np.float32:
            assert g.dtype == np.float32 and v.tobytes() == g.tobytes(), k
        else:
            assert v.item() == g.item(), k


_jswim = jax.jit(lambda cfg, st, net, key, kill, revive: jswim.swim_step(
    cfg, st, net, key, kill=kill, revive=revive), static_argnums=0)


@pytest.mark.parametrize("case", ["kill", "revive", "partition"])
def test_swim_step_matches_jax(reference, case):
    """From the trajectory's state after round 11 (inside the partition
    window): a fifth of the cluster killed, the killed ones revived a round
    later, or the partition healed and split three ways."""
    _, _, _, jstates = reference
    jst = jstates[11].swim
    kill = np.zeros(N, bool)
    revive = np.zeros(N, bool)
    net = _nets()[1]
    if case == "kill":
        kill[::5] = True
    elif case == "revive":
        jst, _ = _jswim(jcfg(), jst, net, jr.key(20), jnp.asarray(kill.copy()).at[::5].set(True),
                        jnp.asarray(revive))
        revive[::5] = True
    else:
        net = jscenario.partitioned_net(jcfg(), 3, 0.05)
    want, winfo = _jswim(jcfg(), jst, net, jr.key(21), jnp.asarray(kill), jnp.asarray(revive))
    tst = swim.SwimState(*(_t(a) for a in jst))
    got, ginfo = swim.swim_step(tcfg(), tst, convert.net_from_numpy(
        convert.as_numpy_tree(net), "cpu"), convert.key_from_numpy(jr.key_data(jr.key(21))),
        kill=torch.from_numpy(kill), revive=torch.from_numpy(revive))
    for i, (a, b) in enumerate(zip(want, got, strict=True)):
        assert np.array_equal(np.asarray(a), b.numpy()) and np.asarray(a).dtype == b.numpy().dtype, i
    assert {k: int(v) for k, v in winfo.items()} == {k: int(v) for k, v in ginfo.items()}
    assert int(winfo["failed_probes"]) > 0
    metrics = jswim.swim_metrics(want)
    tmetrics = swim.swim_metrics(got)
    for k, v in metrics.items():
        v, g = np.asarray(v), tmetrics[k].numpy()
        assert v.item() == g.item() and (v.dtype != np.float32 or v.tobytes() == g.tobytes()), k


def test_bcast_step_matches_jax(reference):
    """One broadcast flush from the trajectory's state after round 5, with
    JAX's fanout draw over the believed-alive view."""
    _, _, _, jstates = reference
    cfg = jcfg()
    jst = jstates[5]
    n = cfg.n_nodes
    believed = (jst.swim.view >= 0) & ((jst.swim.view & 3) == 0) & ~jnp.eye(n, dtype=bool)
    from corrosion_tpu.ops.select import sample_k

    targets, t_ok = sample_k(believed & jst.swim.alive[:, None], cfg.bcast_fanout, jr.key(30))
    net = _nets()[0]
    run = jax.jit(lambda c, t, o, a, k: jbroadcast.bcast_step(cfg, c, t, o, a, net, k))
    want, winfo = run(jst.crdt, targets, t_ok, jst.swim.alive, jr.key(31))
    tst = convert.full_state_from_numpy(tcfg(), convert.as_numpy_tree(jst), "cpu")
    got, ginfo = broadcast.bcast_step(
        tcfg(), tst.crdt, _t(targets), _t(t_ok), tst.swim.alive,
        convert.net_from_numpy(convert.as_numpy_tree(net), "cpu"),
        convert.key_from_numpy(jr.key_data(jr.key(31))))
    _assert_leaves_equal(jax.tree.leaves(convert.as_numpy_tree(want)),
                         _crdt_leaves(tcfg(), got), "bcast_step")
    assert {k: int(v) for k, v in winfo.items()} == {k: int(v) for k, v in ginfo.items()}
    assert int(winfo["sent"]) > 0 and int(winfo["fresh"]) > 0


def test_mailbox_pack_past_capacity_matches_jax():
    rng = np.random.default_rng(0)
    m, rows, cap = 600, 8, 16
    recv = rng.integers(0, rows, m).astype(np.int32)
    recv[:200] = 3  # one receiver far past its capacity
    valid = rng.random(m) < 0.8
    fields = (rng.integers(-5, 99, m).astype(np.int32), rng.random(m) < 0.5)
    want_live, want = jslots.mailbox_pack(jnp.asarray(recv), jnp.asarray(valid), rows, cap,
                                          tuple(map(jnp.asarray, fields)))
    got_live, got = slots.mailbox_pack(torch.from_numpy(recv), torch.from_numpy(valid), rows,
                                       cap, tuple(map(torch.from_numpy, fields)))
    assert np.array_equal(np.asarray(want_live), got_live.numpy()) and got_live.all(1)[3]
    for a, b in zip(want, got, strict=True):
        assert np.asarray(a).dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy())


def test_alloc_slots_matches_jax():
    rng = np.random.default_rng(1)
    free = rng.random((32, 12)) < 0.4
    want_m = rng.random((32, 20)) < 0.5
    w_slot, w_placed = jslots.alloc_slots(jnp.asarray(free), jnp.asarray(want_m))
    g_slot, g_placed = slots.alloc_slots(torch.from_numpy(free), torch.from_numpy(want_m))
    assert np.array_equal(np.asarray(w_placed), g_placed.numpy())
    placed = np.asarray(w_placed)
    assert placed.sum() < want_m.sum()  # some rows run out of free slots
    assert np.array_equal(np.asarray(w_slot)[placed], g_slot.numpy()[placed])
    assert g_slot.dtype == torch.int32


def test_transport_predicates_match_jax():
    """The node-id delivery predicates, with regions, partitions, a foreign
    cluster id and dead nodes, draw for draw."""
    from corrosion_tpu.sim import transport as jtransport
    from corrosion_tpu_torch.sim import transport

    rng = np.random.default_rng(3)
    net = jtransport.NetModel.create(N, drop_prob=0.3, n_regions=5)._replace(
        partition=jnp.asarray(rng.integers(0, 2, N).astype(np.int32)),
        cluster_id=jnp.asarray((np.arange(N) == 7).astype(np.int32)))
    tnet = convert.net_from_numpy(convert.as_numpy_tree(net), "cpu")
    alive = rng.random(N) < 0.8
    src = rng.integers(0, N, (N, 6)).astype(np.int32)
    dst = rng.integers(0, N, (N, 6)).astype(np.int32)
    key = jr.key(50)
    tkey = convert.key_from_numpy(jr.key_data(key))
    ja, jsrc, jdst = map(jnp.asarray, (alive, src, dst))
    ta, tsrc, tdst = map(torch.from_numpy, (alive, src, dst))
    pairs = [
        (jtransport.ring_of(net, jsrc, jdst), transport.ring_of(tnet, tsrc, tdst)),
        (jtransport.same_region(net), transport.same_region(tnet)),
        (jtransport.datagram_ok(net, key, ja, jsrc, jdst),
         transport.datagram_ok(tnet, tkey, ta, tsrc, tdst)),
        (jtransport.uni_ok(net, key, ja, jsrc, jdst), transport.uni_ok(tnet, tkey, ta, tsrc, tdst)),
        (jtransport.bi_ok(net, key, ja, jsrc, jdst), transport.bi_ok(tnet, tkey, ta, tsrc, tdst)),
    ]
    for i, (a, b) in enumerate(pairs):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy()), i
    assert 0 < np.asarray(pairs[2][0]).mean() < 1 and np.asarray(pairs[0][0]).max() > 0


def test_bootstrap_members_matches_jax():
    st = jswim.SwimState.create(jcfg())
    tst = swim.SwimState.create(tcfg(), device="cpu")
    ids, incs = [5, 9, 70, -2, 12], [3, 0, 1, 1, 2]  # 70 and -2 lie outside [0, N)
    want = jswim.bootstrap_members(st, ids, incs)
    got = swim.bootstrap_members(tst, ids, incs)
    for a, b in zip(want, got, strict=True):
        assert np.asarray(a).dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy())
    assert swim.bootstrap_members(tst, [-1, N]) is tst


@pytest.mark.parametrize("gen", ["quiet", "churn", "single_writer", "conflict_heavy",
                                 "full_mix", "partitioned_net"])
def test_scenarios_match_jax(gen):
    cfg = jcfg()
    key = jr.key(40)
    tkey = convert.key_from_numpy(jr.key_data(key))
    if gen == "quiet":
        want, got = jscenario.quiet(cfg, 5), scenario.quiet(tcfg(), 5, "cpu")
    elif gen == "partitioned_net":
        want = jscenario.partitioned_net(cfg, 3, 0.1)
        got = scenario.partitioned_net(tcfg(), 3, 0.1, "cpu")
    elif gen == "churn":
        want = jscenario.churn(cfg, 7, key, rate=0.1)
        got = scenario.churn(tcfg(), 7, tkey, rate=0.1, device="cpu")
    else:
        want = getattr(jscenario, gen)(cfg, 7, key)
        got = getattr(scenario, gen)(tcfg(), 7, tkey, device="cpu")
    assert want._fields == got._fields
    for f, a, b in zip(want._fields, want, got):
        assert np.asarray(a).dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy()), f


def test_ingest_plain_at_recv_slots_matches_jax():
    """The plain ingest at m = recv_slots = 96 against the JAX XLA path
    (which the JAX package pins equal to its kernel), with a 16-slot queue:
    rows record more fresh messages than the queue holds, so the r-th
    recorded message takes the r-th slot by evict key and the rest drop."""
    q = 16
    cfg = jcfg(bcast_queue=q, n_rows=4, n_cols=4)
    st = jstep.SimState.create(cfg).crdt
    rng = np.random.default_rng(2)
    n, m = N, cfg.recv_slots
    now = 20
    st = st._replace(now=jnp.int32(now), q_origin=jnp.asarray(
        np.where(rng.random((n, q)) < 0.5, -1, rng.integers(0, 8, (n, q))).astype(np.int32)),
        q_tx=jnp.asarray(rng.integers(0, 4, (n, q)).astype(np.int32)))
    live = rng.random((n, m)) < 0.8
    msgs = [rng.integers(0, 8, (n, m)), rng.integers(1, 60, (n, m)),
            rng.integers(-1, 17, (n, m)), rng.integers(0, 8, (n, m)),
            # wide values: two changes never tie on (clp, ver, val, site)
            # with different versions, as in a real trajectory
            rng.integers(0, 1 << 20, (n, m)), rng.integers(0, 4, (n, m)),
            rng.integers(0, 2, (n, m)), np.zeros((n, m)), np.ones((n, m)),
            rng.integers((now - 3) << 10, (now + 4) << 10, (n, m))]
    msgs = [a.astype(np.int32) for a in msgs]
    ing = jax.jit(lambda c, *a: jbroadcast.ingest_changes(cfg, c, *a))
    want, winfo = ing(st, jnp.asarray(live), *map(jnp.asarray, msgs))
    tst = convert.full_state_from_numpy(
        tcfg(bcast_queue=q, n_rows=4, n_cols=4),
        convert.as_numpy_tree(jstep.SimState.create(cfg)._replace(crdt=st)), "cpu").crdt
    got, ginfo = broadcast.ingest_changes(tcfg(bcast_queue=q, n_rows=4, n_cols=4), tst,
                                          torch.from_numpy(live), *map(torch.from_numpy, msgs))
    _assert_leaves_equal(jax.tree.leaves(convert.as_numpy_tree(want)),
                         _crdt_leaves(tcfg(bcast_queue=q, n_rows=4, n_cols=4), got),
                         "ingest m=96")
    assert {k: int(v) for k, v in winfo.items()} == {k: int(v) for k, v in ginfo.items()}
    # rows where the recorded messages outnumber the queue's slots
    p, x = _plain_inputs(tcfg(bcast_queue=q, n_rows=4, n_cols=4), tst, live, msgs)
    rec = mk.ingest_plain(p, x).fresh.sum(dim=1)
    assert int((rec > q).sum()) > 0


def _crdt_leaves(cfg, cst):
    swim_half = step.SimState.create(cfg, device="cpu").swim
    tree = convert.state_to_numpy(step.SimState(swim_half, cst))
    return jax.tree.leaves(tree["crdt"])


def _plain_inputs(cfg, cst, live, msgs):
    n, o, w = cst.book.seen.shape
    p = mk.IngestParams(
        n_origins=o, n_cells=cfg.n_cells, q_slots=cfg.bcast_queue, seen_words=w,
        hlc_round_bits=broadcast.HLC_ROUND_BITS, hlc_max_drift=broadcast.HLC_MAX_DRIFT_ROUNDS,
        pig_r=0, budget_bytes=cfg.bcast_budget_bytes, wire_bytes=broadcast.CHANGE_WIRE_BYTES,
        keep_rounds=cfg.org_keep_rounds, enqueue_all=False)
    t = [torch.from_numpy(a) for a in msgs]
    x = mk.IngestInputs(
        torch.from_numpy(live), *t[:7], t[9], torch.full_like(t[0], cfg.bcast_max_transmissions - 1),
        tuple(cst.store), cst.book.head, cst.book.known_max, cst.book.seen.reshape(n, o * w),
        cst.book.org_id, cst.book.org_last, cst.q_origin, cst.q_dbv, cst.q_cell, cst.q_ver,
        cst.q_val, cst.q_site, cst.q_clp, cst.q_ts, cst.q_tx, cst.hlc, cst.now)
    return p, x


@pytest.mark.parametrize("over", [dict(fused="off"), dict(fused="interpret")])
def test_check_full_slice_refuses(over):
    cfg = config.wan_config(N, **{**OVER, **over})
    with pytest.raises(ValueError, match="ROADMAP"):
        config.check_full_slice(cfg)
    with pytest.raises(ValueError, match="ROADMAP"):
        step.run_rounds(cfg, None, None, prng.key(0), None)


def test_full_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: step.SimState.create(tcfg()), lambda: step.RoundInput.quiet(tcfg()),
                 lambda: scenario.full_mix(tcfg(), 2, prng.key(0)),
                 lambda: scenario.partitioned_net(tcfg())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert step.SimState.create(tcfg(), device="cpu").swim.view.device.type == "cpu"


def test_port_config_is_the_jax_config():
    for n, over in ((N, OVER), (300, {})):
        ours = dataclasses.asdict(config.wan_config(n, **over))
        theirs = dataclasses.asdict(jconfig.wan_config(n, **over))
        assert ours == theirs
    point = dataclasses.asdict(config.full_view_config())
    assert point == dataclasses.asdict(jconfig.wan_config(8192, n_origins=16, tx_max_cells=1))
    assert (point["recv_slots"], point["bcast_queue"], point["bcast_fanout"],
            point["max_transmissions"]) == (96, 64, 10, 17)
    assert config.FUSED_MODES == jconfig.FUSED_MODES
    assert config.QUIET_MODES == jconfig.QUIET_MODES


def test_full_view_modules_import_no_jax():
    code = (
        "import sys\n"
        "import corrosion_tpu_torch.sim.step, corrosion_tpu_torch.sim.scenario\n"
        "import corrosion_tpu_torch.sim.swim, corrosion_tpu_torch.convert\n"
        "import corrosion_tpu_torch.sim.broadcast, corrosion_tpu_torch.ops.partials\n"
        "import corrosion_tpu_torch.ops.versions, corrosion_tpu_torch.sim.config\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=pathlib.Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
