"""The port's node-axis sharding (``parallel/``) on the CPU: the scale round
run over a mesh of eight ``cpu`` shards, flat and as a ``(2, 4)`` multihost
mesh, is bitwise equal to the port's single-device round and to the JAX
package's ``sharded_scale_run`` on eight host devices (the same converted
config, key and inputs, over 6 rounds with a sync round and a sync-and-sweep
round), state leaves and round infos alike. Also: a chained carry equals
the straight run, a bad host split is refused with JAX's message, a
row-range draw is bitwise the slice of the whole draw, the exchange
counter's bytes are what the gathered planes' shapes say, a shard that
raises ends the run with its error instead of a hang, and sixteen shard
threads under a short switch interval lose no count."""

import sys
import threading
import time

import jax
import jax.random as jr
import numpy as np
import pytest
import torch

from corrosion_tpu.parallel import mesh as jmesh
from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.parallel import (
    make_mesh,
    make_multihost_mesh,
    sharded_scale_run,
    sharded_scale_run_carry,
)
from corrosion_tpu_torch.parallel import exchange
from corrosion_tpu_torch.parallel.exchange import shard_bounds
from corrosion_tpu_torch.sim import scale_step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

N, ROUNDS, SHARDS = 64, 6, 8
#: a sync round at now 3 and a sync-and-sweep round at now 6
BASE = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=3,
            sync_sweep_every=2)
CASES = {
    "flagship": {},
    "million_forms": dict(pig_members=4, narrow_int8=True, narrow_q_int8=True),
    "quiet": dict(quiet="on"),
    "tx4": dict(tx_max_cells=4),
}
MESHES = ("flat", "dcn2x4")
_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _short_turn_timeout():
    """A deadlocked shard fails its wait within a minute."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exchange, "TURN_TIMEOUT_S", 60.0)
        yield


def _port_mesh(kind):
    devs = ["cpu"] * SHARDS
    return make_mesh(devs) if kind == "flat" else make_multihost_mesh(2, devs)


def _jax_run(case):
    """JAX's sharded scan over 8 host devices, once per case a module."""
    if case not in _JAX:
        cfg = jstep.scale_sim_config(N, fused="off", **BASE, **CASES[case])
        st = jstep.ScaleSimState.create(cfg)
        net = JNet.create(N, drop_prob=0.05)
        wm = jr.uniform(jr.key(9), (ROUNDS, N)) < 0.4
        inputs = jstep.make_write_inputs(cfg, jr.key(8), ROUNDS, wm)
        key = jr.key(7)
        start = dict(state=convert.as_numpy_tree(st), net=convert.as_numpy_tree(net),
                     key=np.asarray(jr.key_data(key)),
                     inputs=convert.as_numpy_tree(inputs))
        mesh = jmesh.make_mesh(jax.devices()[:SHARDS])
        out, infos = jmesh.sharded_scale_run(
            cfg, mesh, *(jmesh.shard_state(mesh, N, t) for t in (st, net)), key,
            jmesh.shard_state(mesh, N, inputs))
        _JAX[case] = (start, jax.tree.leaves(convert.as_numpy_tree(out)),
                      {k: np.asarray(v) for k, v in infos.items()})
    return _JAX[case]


def _port_start(case, start):
    cfg = scale_step.scale_sim_config(N, **BASE, **CASES[case])
    return (cfg, convert.scale_state_from_numpy(cfg, start["state"], "cpu"),
            convert.net_from_numpy(start["net"], "cpu"),
            convert.key_from_numpy(start["key"]),
            convert.round_input_from_numpy(scale_step.ScaleRoundInput,
                                           start["inputs"], "cpu"))


def _leaves(st):
    return jax.tree.leaves(convert.state_to_numpy(st))


def _assert_leaves(want, got, where):
    assert len(want) == len(got), where
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, i)


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_round_equals_single_device_and_jax(case, mesh_kind):
    start, jax_leaves, jax_infos = _jax_run(case)
    cfg, st, net, key, inputs = _port_start(case, start)
    ref, ref_infos = scale_step.scale_run_rounds(cfg, st, net, key, inputs)
    out, infos = sharded_scale_run(cfg, _port_mesh(mesh_kind), st, net, key, inputs)
    assert len(out.parts) == SHARDS
    assert [int(p.swim.alive.shape[0]) for p in out.parts] == [N // SHARDS] * SHARDS
    whole = out.assemble("cpu")
    _assert_leaves(_leaves(ref), _leaves(whole), "single device")
    _assert_leaves(jax_leaves, _leaves(whole), "JAX sharded_scale_run")
    assert sorted(infos) == sorted(ref_infos) == sorted(jax_infos)
    for k in ref_infos:
        assert torch.equal(infos[k], ref_infos[k]), k
        assert np.array_equal(infos[k].numpy(), jax_infos[k]), k
    # the run took its sync and its sync-and-sweep round
    assert int(infos["syncs"][2]) > 0 and int(infos["syncs"][5]) > 0


def test_carry_chain_equals_the_straight_run():
    start = _jax_run("flagship")[0]
    cfg, st, net, key, inputs = _port_start("flagship", start)
    (ref, ref_key), _ = scale_step.scale_run_rounds_carry(cfg, st, net, key, inputs)
    mesh = _port_mesh("dcn2x4")
    carry, k = st, key
    for lo, hi in ((0, 3), (3, ROUNDS)):
        seg = scale_step.ScaleRoundInput(*(a[lo:hi] for a in inputs))
        (carry, k), _ = sharded_scale_run_carry(cfg, mesh, carry, net, k, seg)
    _assert_leaves(_leaves(ref), _leaves(carry.assemble("cpu")), "carry chain")
    assert torch.equal(ref_key, k)


@pytest.mark.parametrize("hosts", [3, 0, -2])
def test_multihost_mesh_rejects_a_bad_split_with_jax_message(hosts):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_multihost_mesh(hosts, jax.devices()[:SHARDS])
    with pytest.raises(ValueError, match="do not split") as err:
        make_multihost_mesh(hosts, ["cpu"] * SHARDS)
    assert str(err.value) == str(jerr.value)


def test_uneven_node_split_is_refused():
    with pytest.raises(ValueError, match="divisible by 8"):
        shard_bounds(60, 8)


@pytest.mark.parametrize("draw", ["bits", "uniform", "randint"])
@pytest.mark.parametrize("shape", [(64,), (64, 5), (24, 3, 2)])
def test_row_range_draw_is_the_slice_of_the_whole_draw(draw, shape):
    key = prng.key(11)
    args = {"bits": lambda s, r: prng.bits(key, s, "cpu", row0=r),
            "uniform": lambda s, r: prng.uniform(key, s, "cpu", row0=r),
            "randint": lambda s, r: prng.randint(key, s, 0, 1000, "cpu", row0=r)}[draw]
    whole = args(shape, 0)
    k = 8
    b = shape[0] // k
    for lo in range(0, shape[0], b):
        part = args((b,) + shape[1:], lo)
        assert torch.equal(part, whole[lo:lo + b]), lo


def _expected_bytes(cfg, sync: bool, k: int = SHARDS) -> dict:
    """What each exchange site moves in one round, from the gathered
    planes' shapes: an all-gather or owner reduction of ``[N, w]`` planes
    moves ``(k - 1) * N`` rows summed over the shards, a scalar ``k - 1``
    values to each of ``k`` shards."""
    i32, i64 = 4, 8
    m, o, c, r = cfg.m_slots, cfg.n_origins, cfg.n_cells, cfg.pig_changes
    rows = lambda w: (k - 1) * N * w  # noqa: E731
    out = {
        "swim.card": rows(5 * i32), "swim.suspect": rows(i32),
        "swim.prober": rows(i32), "swim.announcer": rows(i32),
        "swim.elect": rows(2 * i32), "swim.acks": rows(i32),
        "swim.replies": rows(i32), "swim.mem_id": rows(m * i32),
        "swim.mem_view": rows(m * i32), "swim.sendable": rows(m),
        "bcast.payload": rows(11 * r * i32),
        "info": (k - 1) * k * 16 * i64,
    }
    if sync:
        out.update({
            "sync.ring_card": rows(4 * i32), "sync.regions": (k - 1) * k * i32,
            "sync.card": rows(5 * i32), "sync.load": rows(i32),
            "sync.loads": rows(i32), "sync.head": rows(o * i32),
            "sync.org_id": rows(o * i32), "sync.store": rows(5 * c * i32),
            "sync.hlc": rows(i32),
        })
    return out


def test_exchange_bytes_follow_the_gathered_planes():
    start = _jax_run("flagship")[0]
    cfg, st, net, key, inputs = _port_start("flagship", start)
    log: list = []
    sharded_scale_run(cfg, _port_mesh("flat"), st, net, key, inputs, exchanges=log)
    assert len(log) == ROUNDS
    assert log[0] == _expected_bytes(cfg, sync=False)
    assert log[2] == _expected_bytes(cfg, sync=True)  # now 3: sync
    assert log[5] == _expected_bytes(cfg, sync=True)  # now 6: sync and sweep


def test_a_shard_that_raises_ends_the_run_without_a_hang(monkeypatch):
    start = _jax_run("flagship")[0]
    cfg, st, net, key, inputs = _port_start("flagship", start)
    real = scale_step._narrow_carry

    def boom(cfg, st):
        if threading.current_thread().name == "corro-shard-3":
            raise RuntimeError("boom in shard 3")
        return real(cfg, st)

    monkeypatch.setattr(scale_step, "_narrow_carry", boom)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="boom in shard 3"):
        sharded_scale_run(cfg, _port_mesh("flat"), st, net, key, inputs)
    assert time.monotonic() - t0 < 60
    assert not [t for t in threading.enumerate() if t.name.startswith("corro-shard")]


def test_more_shards_than_cores_at_a_short_switch_interval_lose_no_count(monkeypatch):
    """Sixteen shard threads, the interpreter switching every microsecond:
    the state is still the single-device one, and every shard's kernel
    launches (counted through CPU stand-ins of the CUDA route) and exchange
    bytes are all there, which a lost update of a shared counter breaks."""
    from corrosion_tpu_torch.ops import megakernel as mk

    def swim(consts, *args):
        out = mk.swim_tables_plain(consts, *args)
        mk._count_launch("swim_tables", "cpu")
        return out

    def ingest(p, x):
        out = mk.ingest_plain(p, x)
        mk._count_launch("ingest_emit" if p.pig_r else "ingest", "cpu")
        return out

    start = _jax_run("flagship")[0]
    cfg, st, net, key, inputs = _port_start("flagship", start)
    inputs = scale_step.ScaleRoundInput(*(a[:3] for a in inputs))
    ref, _ = scale_step.scale_run_rounds(cfg, st, net, key, inputs)
    monkeypatch.setattr(mk, "_route", lambda t: "cuda")
    monkeypatch.setattr(mk, "_swim_cuda", swim)
    monkeypatch.setattr(mk, "_ingest_cuda", ingest)
    mk.reset_launches()
    log: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out, _ = sharded_scale_run(cfg, make_mesh(["cpu"] * 16), st, net, key, inputs,
                                   exchanges=log)
    finally:
        sys.setswitchinterval(old)
    assert mk.LAUNCHES == {name: 16 * 3 for name in mk.LAUNCHES}
    assert log == [_expected_bytes(cfg, sync=r == 2, k=16) for r in range(3)]
    _assert_leaves(_leaves(ref), _leaves(out.assemble("cpu")), "16 shards")
