"""The full view's round on a mesh (``parallel/mesh.py``'s ``sharded_step``
and ``sharded_run``) on the CPU, after the JAX package's
``tests/test_parallel.py``: ``sharded_run`` over eight ``cpu`` shards, flat
and as a ``(2, 4)`` multihost mesh, at ``wan_config(32, ...)`` with 6 rounds
of ``conflict_heavy`` writes under 5 % loss, equals the port's single-device
``run_rounds`` and the JAX package's ``sharded_run`` on eight host devices
bit for bit, state leaves and round infos alike, at the default
``tx_max_cells=8`` (the plain route) and at ``tx_max_cells=1`` (the ingest
kernel's forms, here their plain versions). Also: one ``sharded_step``
equals ``sim_step`` and launches K2 and K3 once on every shard (counted
through CPU stand-ins of the CUDA route), a carry chain on a ``(2, 2)``
mesh under churn, a partition and transactions equals the straight run,
the placed ``[N, N]`` view is split by rows,
and the exchange counter's bytes a round follow the written formula."""

import jax
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu.parallel import mesh as jmesh
from corrosion_tpu.sim import config as jconfig
from corrosion_tpu.sim import scenario as jscenario
from corrosion_tpu.sim import step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.parallel import (
    exchange,
    make_mesh,
    make_multihost_mesh,
    shard_state,
    sharded_run,
    sharded_step,
)
from corrosion_tpu_torch.sim import config, scenario, step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N, ROUNDS, SHARDS = 32, 6, 8
BASE = dict(n_rows=4, n_cols=2, buf_slots=8, bcast_queue=8, recv_slots=16)
TX = (8, 1)
MESHES = ("flat", "dcn2x4")
_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _short_turn_timeout():
    """A deadlocked shard fails its wait within a minute."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exchange, "TURN_TIMEOUT_S", 60.0)
        yield


def _port_mesh(kind, k=SHARDS):
    devs = ["cpu"] * k
    return make_mesh(devs) if kind == "flat" else make_multihost_mesh(2, devs)


@pytest.fixture(scope="module")
def reference():
    """Per ``tx_max_cells``: the converted start, JAX's ``sharded_run`` on
    eight host devices and the port's single-device ``run_rounds``, once a
    module."""
    out = {}
    for tx in TX:
        jcfg = jconfig.wan_config(N, fused="off", tx_max_cells=tx, **BASE)
        st = jstep.SimState.create(jcfg)
        net = JNet.create(N, drop_prob=0.05)
        key = jr.key(7)
        inputs = jscenario.conflict_heavy(jcfg, ROUNDS, jr.key(8), write_prob=0.5)
        jm = jmesh.make_mesh(jax.devices()[:SHARDS])
        jout, jinfos = jmesh.sharded_run(
            jcfg, jm, *(jmesh.shard_state(jm, N, t) for t in (st, net)), key,
            jmesh.shard_state(jm, N, inputs))
        cfg = config.wan_config(N, tx_max_cells=tx, **BASE)
        start = (convert.full_state_from_numpy(cfg, convert.as_numpy_tree(st), "cpu"),
                 convert.net_from_numpy(convert.as_numpy_tree(net), "cpu"),
                 convert.key_from_numpy(np.asarray(jr.key_data(key))),
                 convert.round_input_from_numpy(step.RoundInput,
                                                convert.as_numpy_tree(inputs), "cpu"))
        ref, ref_infos = step.run_rounds(cfg, *start)
        out[tx] = dict(cfg=cfg, start=start, ref=_leaves(ref), ref_infos=ref_infos,
                       jax=jax.tree.leaves(convert.as_numpy_tree(jout)),
                       jax_infos={k: np.asarray(v) for k, v in jinfos.items()})
    return out


def _leaves(st):
    return jax.tree.leaves(convert.state_to_numpy(st))


def _assert_leaves(want, got, where):
    assert len(want) == len(got), where
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, i)


def _sharded(reference, tx, kind):
    """The port's ``sharded_run`` of a case, with its exchange log, once a
    module."""
    if (tx, kind) not in _RUNS:
        r = reference[tx]
        log: list = []
        out, infos = sharded_run(r["cfg"], _port_mesh(kind), *r["start"], exchanges=log)
        _RUNS[tx, kind] = (out, infos, log)
    return _RUNS[tx, kind]


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("tx", TX)
def test_sharded_run_equals_single_device_and_jax(reference, tx, mesh_kind):
    r = reference[tx]
    out, infos, _ = _sharded(reference, tx, mesh_kind)
    assert len(out.parts) == SHARDS
    whole = _leaves(out.assemble("cpu"))
    _assert_leaves(r["ref"], whole, "single device")
    _assert_leaves(r["jax"], whole, "JAX sharded_run")
    assert sorted(infos) == sorted(r["ref_infos"]) == sorted(r["jax_infos"])
    for k in infos:
        assert torch.equal(infos[k], r["ref_infos"][k]), k
        assert np.array_equal(infos[k].numpy(), r["jax_infos"][k]), k
    # the run delivered and synced across the shards
    assert int(infos["fresh"].sum()) > 0 and int(infos["syncs"].sum()) > 0


def test_sharded_step_equals_sim_step_and_launches_on_every_shard(reference,
                                                                  monkeypatch):
    """One round at ``tx_max_cells=1``: K3 (the local write, m = 1) and K2
    (the ``recv_slots``-wide receive batch) launch once on each shard."""
    from corrosion_tpu_torch.ops import megakernel as mk

    r = reference[1]
    st, net, key, inputs = r["start"]
    inp = step.RoundInput(*(a[0] for a in inputs))
    want, want_info = step.sim_step(r["cfg"], st, net, key, inp)

    def ingest(p, x):
        out = mk.ingest_plain(p, x)
        m = x.origin.shape[1]
        mk._count_launch("ingest", "32/32" + (f"/m{m}" if m > 1 else ""))
        return out

    monkeypatch.setattr(mk, "_route", lambda t: "cuda")
    monkeypatch.setattr(mk, "_ingest_cuda", ingest)
    mk.reset_launches()
    out, info = sharded_step(r["cfg"], _port_mesh("flat"), st, net, key, inp)
    assert {k: v for k, v in mk.LAUNCHES.items() if v} == {"ingest": 2 * SHARDS}
    assert mk.FORM_LAUNCHES == {("ingest", "32/32"): SHARDS,
                                ("ingest", f"32/32/m{r['cfg'].recv_slots}"): SHARDS}
    _assert_leaves(_leaves(want), _leaves(out.assemble("cpu")), "sharded_step")
    assert sorted(info) == sorted(want_info)
    for k in info:
        assert torch.equal(info[k], want_info[k]), k


def _churn_rig():
    """``full_mix`` with 5 % churn a round, a transaction a round at each
    writing origin and a net split in two under 5 % loss: probes fail, so
    suspicion notices and refutations cross the shards."""
    cfg = config.wan_config(N, **BASE)
    rounds, k = ROUNDS, cfg.tx_max_cells
    inputs = scenario.full_mix(cfg, rounds, prng.key(5), churn_rate=0.05,
                               write_prob=0.5, device="cpu")
    k_w, k_len, k_cell, k_val = prng.split(prng.key(13), 4)
    writer = torch.arange(N) < cfg.n_origins
    inputs = inputs._replace(
        tx_mask=(prng.uniform(k_w, (rounds, N), "cpu") < 0.5) & writer,
        tx_len=prng.randint(k_len, (rounds, N), 1, k + 1, "cpu"),
        tx_cell=prng.randint(k_cell, (rounds, N, k), 0, cfg.n_cells, "cpu"),
        tx_val=prng.randint(k_val, (rounds, N, k), 0, 1 << 20, "cpu"))
    return (cfg, step.SimState.create(cfg, device="cpu"),
            scenario.partitioned_net(cfg, 2, 0.05, device="cpu"), prng.key(7), inputs)


def test_carry_chain_equals_the_straight_run():
    """3 + 3 rounds on a ``(2, 2)`` multihost mesh of four shards under
    churn, a partition and transactions, the second segment fed the
    first's placed state and the key the straight run carries."""
    cfg, st, net, key, inputs = _churn_rig()
    ref, ref_infos = step.run_rounds(cfg, st, net, key, inputs)
    for name in ("failed_probes", "refutes", "tx_completed", "fresh"):
        assert int(ref_infos[name].sum()) > 0, name
    mesh = _port_mesh("dcn2x4", k=4)
    carry, k, infos = st, key, []
    for lo, hi in ((0, 3), (3, ROUNDS)):
        carry, info = sharded_run(cfg, mesh, carry, net, k,
                                  step.RoundInput(*(a[lo:hi] for a in inputs)))
        infos.append(info)
        for _ in range(lo, hi):
            k, _sub = prng.split(k)
    assert carry.mesh is mesh
    _assert_leaves(_leaves(ref), _leaves(carry.assemble("cpu")), "carry chain")
    for name, v in ref_infos.items():
        assert torch.equal(torch.cat([i[name] for i in infos]), v), name


def test_state_is_actually_sharded():
    cfg = config.wan_config(N, n_rows=4, n_cols=2)
    st = shard_state(_port_mesh("flat"), N, step.SimState.create(cfg, device="cpu"))
    assert len(st.parts) == SHARDS
    # the [N, N] view plane is split over the node axis, by rows
    assert [tuple(p.swim.view.shape) for p in st.parts] == [(N // SHARDS, N)] * SHARDS
    assert st.dims[2] == 0


def _expected_bytes(cfg, k: int = SHARDS) -> dict:
    """What each exchange site moves in one round, summed over the shards:
    an all-gather of ``w`` bytes a row, an owner reduction of ``[N]``
    int32 or an all-to-all of ``[N, ...]`` planes moves ``(k - 1) * N``
    rows; the info sum ``k - 1`` int64 vectors to each of ``k`` shards."""
    i32, i64 = 4, 8
    u, o, c, q = cfg.piggyback, cfg.n_origins, cfg.n_cells, cfg.recv_slots
    rows = lambda w: (k - 1) * N * w  # noqa: E731
    return {
        "swim.card": rows(4 * i32),  # alive, partition, cluster, region
        "swim.notice": rows(3 * i32),  # (row, column, key) a node
        "swim.announce": rows(3 * i32),
        "swim.answer": rows(i32),
        "swim.rows": rows((3 * u + 1) * i32),  # selection, payload, ok, self key
        "swim.gossip": rows(4 * (u + 1) * 3 * i32),  # 4 packets of u + 1 entries
        "swim.sends": rows(i32),
        "step.card": rows(4 * i32),
        "bcast.mail": rows(q * (1 + 10 * i32)),  # live + 10 int32 fields a slot
        "sync.card": rows(5 * i32), "sync.load": rows(i32),
        "sync.loads": rows(i32), "sync.head": rows(o * i32),
        "sync.org_id": rows(o * i32), "sync.store": rows(5 * c * i32),
        "sync.hlc": rows(i32),
        "info": (k - 1) * k * 13 * i64,
    }


@pytest.mark.parametrize("tx", TX)
def test_exchange_bytes_follow_the_written_formula(reference, tx):
    _, _, log = _sharded(reference, tx, "flat")
    assert log == [_expected_bytes(reference[tx]["cfg"])] * ROUNDS
