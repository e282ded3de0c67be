"""The whole slice: the port's ``scale_run_rounds`` on the CPU (plain
kernel versions) against the JAX package's ``scale_run_rounds_carry`` (its
XLA path, ``fused="off"``), from identical converted state, net, key and
inputs. Every state leaf must be bitwise equal after every round, and every
round-info value equal, over rounds that include sync and sweep rounds,
writes, kills, revives and 5 % message loss."""

import ast
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

from corrosion_tpu.sim import scale_step as jstep
from corrosion_tpu.sim.transport import NetModel as JNet
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.sim import scale_step
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, ROUNDS = 256, 12
OVER = dict(sync_interval=2, sync_sweep_every=2)


def _jax_inputs(cfg):
    wm = jr.uniform(jr.key(9), (ROUNDS, N)) < 0.1
    inp = jstep.make_write_inputs(cfg, jr.key(5), ROUNDS, wm)
    kill = np.zeros((ROUNDS, N), bool)
    revive = np.zeros((ROUNDS, N), bool)
    kill[3, 10:20] = True
    revive[7, 10:15] = True
    return inp._replace(kill=jnp.asarray(kill), revive=jnp.asarray(revive))


@pytest.fixture(scope="module")
def reference():
    """The JAX trajectory, one round per call of the scan entry point."""
    cfg = jstep.scale_sim_config(N, fused="off", **OVER)
    st = jstep.ScaleSimState.create(cfg)
    net = JNet.create(N, drop_prob=0.05)
    key = jr.key(3)
    inputs = _jax_inputs(cfg)
    start = dict(state=convert.as_numpy_tree(st), net=convert.as_numpy_tree(net),
                 key=np.asarray(jr.key_data(key)), inputs=convert.as_numpy_tree(inputs))
    run = jax.jit(lambda s, k, i: jstep.scale_run_rounds_carry(cfg, s, net, k, i))
    states, infos = [], []
    for r in range(ROUNDS):
        (st, key), info = run(st, key, jax.tree.map(lambda a: a[r:r + 1], inputs))
        states.append(jax.tree.leaves(convert.as_numpy_tree(st)))
        infos.append({k: int(np.asarray(v)[0]) for k, v in info.items()})
    start["final"] = st
    return start, states, infos


def _port_start(start):
    cfg = scale_step.scale_sim_config(N, **OVER)
    st = convert.scale_state_from_numpy(cfg, start["state"], "cpu")
    net = convert.net_from_numpy(start["net"], "cpu")
    key = convert.key_from_numpy(start["key"])
    inputs = convert.round_input_from_numpy(scale_step.ScaleRoundInput, start["inputs"], "cpu")
    return cfg, st, net, key, inputs


def _port_leaves(st):
    return jax.tree.leaves(convert.state_to_numpy(st))


def _assert_leaves_equal(want, got, where):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, i)


def test_every_round_bitwise_equal_to_jax(reference):
    start, states, infos = reference
    cfg, st, net, key, inputs = _port_start(start)
    for r in range(ROUNDS):
        one = scale_step.ScaleRoundInput(*(a[r:r + 1] for a in inputs))
        (st, key), info = scale_step.scale_run_rounds_carry(cfg, st, net, key, one)
        _assert_leaves_equal(states[r], _port_leaves(st), f"round {r}")
        assert {k: int(v[0]) for k, v in info.items()} == infos[r], r


def test_reference_covers_sync_sweep_churn_and_writes(reference):
    _, _, infos = reference
    assert sum(i["syncs"] for i in infos) > 0
    assert sum(i["fresh"] for i in infos) > 0
    assert sum(i["cells_pulled"] for i in infos) > 0
    # cohort rounds every 2nd, sweep every 4th round counter
    assert [i["syncs"] > 0 for i in infos][:4] == [False, True, False, True]


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's straight ``scale_run_rounds`` over all the rounds."""
    start, _, _ = reference
    cfg, st, net, key, inputs = _port_start(start)
    return scale_step.scale_run_rounds(cfg, st, net, key, inputs)


def test_run_rounds_equals_chained_rounds(reference, port_run):
    _, states, infos = reference
    st, stacked = port_run
    _assert_leaves_equal(states[-1], _port_leaves(st), "final")
    for k in infos[0]:
        assert [int(v) for v in stacked[k]] == [i[k] for i in infos], k


def test_scale_crdt_metrics_match_jax(reference, port_run):
    start, _, _ = reference
    jcfg = jstep.scale_sim_config(N, fused="off", **OVER)
    want = jstep.scale_crdt_metrics(jcfg, start["final"])
    got = scale_step.scale_crdt_metrics(scale_step.scale_sim_config(N, **OVER), port_run[0])
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        v, g = np.asarray(v), got[k].numpy()
        if v.dtype == np.float32:
            assert g.dtype == np.float32 and v.tobytes() == g.tobytes(), k
        else:
            assert v.item() == g.item(), k


@pytest.mark.parametrize("when", ["start", "final"])
def test_swim_front_and_disturbed_match_jax(reference, when):
    """The SWIM front half and the quiet round's disturbance predicate, from
    the fresh state and from the state after the trajectory."""
    from corrosion_tpu.sim import scale as jscale
    from corrosion_tpu_torch.sim import scale as tscale

    start, _, _ = reference
    jcfg = jstep.scale_sim_config(N, fused="off", **OVER)
    jst = start["final"] if when == "final" else jstep.ScaleSimState.create(jcfg)
    jnet = JNet.create(N, drop_prob=0.05)
    jkey = jr.key(11)
    want = jscale._swim_front(jcfg, jst.swim, jnet, jkey)

    cfg = scale_step.scale_sim_config(N, **OVER)
    st = convert.scale_state_from_numpy(cfg, convert.as_numpy_tree(jst), "cpu")
    net = convert.net_from_numpy(convert.as_numpy_tree(jnet), "cpu")
    got = tscale._swim_front(cfg, st.swim, net,
                             convert.key_from_numpy(jr.key_data(jkey)))

    # the predicate as drawn, without failed probes, and with no traffic
    def quieted(front, zeros_like, level):
        if level >= 1:
            front = front._replace(failed=zeros_like(front.failed))
        if level >= 2:
            front = front._replace(channels=tuple(
                (src, zeros_like(v)) for src, v in front.channels))
        return front

    dist = [(bool(jscale.swim_front_disturbed(jcfg, quieted(want, jnp.zeros_like, lv))),
             bool(tscale.swim_front_disturbed(cfg, quieted(got, torch.zeros_like, lv))))
            for lv in range(3)]
    assert all(a == b for a, b in dist) and dist[2] == (False, False), dist

    assert np.array_equal(np.asarray(jr.key_data(want.k_upd)).astype(np.int64),
                          got.k_upd.numpy())
    assert want._fields == got._fields

    def leaves(front):
        return jax.tree.leaves([convert.as_numpy_tree(v) for f, v in
                                zip(front._fields, front) if f != "k_upd"])

    _assert_leaves_equal(leaves(want), leaves(got), f"front from {when}")


def test_make_write_inputs_matches_jax():
    cfg = jstep.scale_sim_config(N)
    wm = jr.uniform(jr.key(1), (4, N)) < 0.25
    want = convert.as_numpy_tree(jstep.make_write_inputs(cfg, jr.key(2), 4, wm))
    got = scale_step.make_write_inputs(scale_step.scale_sim_config(N), prng.key(2), 4,
                                       torch.from_numpy(np.array(wm)), "cpu")
    for k, v in want.items():
        assert np.array_equal(v, getattr(got, k).numpy()), k


def test_flagship_workload_is_bench_workload():
    """``flagship_workload`` draws what bench.py's default run draws: the
    origin nodes write at p=0.25 under key 1, 1 % loss, round key 0."""
    cfg = jstep.scale_sim_config(N)
    k1, k2, _ = jr.split(jr.key(1), 3)
    wm = (jr.uniform(k1, (4, N)) < 0.25) & (jnp.arange(N) < cfg.n_origins)[None, :]
    want = convert.as_numpy_tree(jstep.make_write_inputs(cfg, k2, 4, wm))
    want_net = convert.as_numpy_tree(JNet.create(N, drop_prob=0.01))
    tcfg = scale_step.scale_sim_config(N)
    st, net, key, got = scale_step.flagship_workload(tcfg, 4, "cpu")
    for k, v in want.items():
        assert np.array_equal(v, getattr(got, k).numpy()), k
    assert 0 < int(got.write_mask.sum()) and not got.write_mask[:, cfg.n_origins:].any()
    for k, v in want_net.items():
        assert np.array_equal(v, getattr(net, k).numpy()), k
    assert torch.equal(key, convert.key_from_numpy(jr.key_data(jr.key(0))))
    _assert_leaves_equal(_port_leaves(scale_step.ScaleSimState.create(tcfg, "cpu")),
                         _port_leaves(st), "start")


def test_wide_planes_equal_narrow_planes():
    """narrow_dtypes only narrows storage: the wide-plane round gives the
    same values (the JAX package pins the same for its own round)."""
    out = {}
    for narrow in (True, False):
        cfg = scale_step.scale_sim_config(64, narrow_dtypes=narrow, **OVER)
        st = scale_step.ScaleSimState.create(cfg, "cpu")
        net = scale_step.NetModel.create(64, drop_prob=0.05, device="cpu")
        k_w, k_in = prng.split(prng.key(4))
        inputs = scale_step.make_write_inputs(
            cfg, k_in, 6, prng.uniform(k_w, (6, 64), "cpu") < 0.2, "cpu")
        st, infos = scale_step.scale_run_rounds(cfg, st, net, prng.key(6), inputs)
        out[narrow] = (st, infos)
    (a, ia), (b, ib) = out[True], out[False]
    assert a.swim.mem_timer.dtype == torch.int16 and b.swim.mem_timer.dtype == torch.int32
    for x, y in zip(_port_leaves(a), _port_leaves(b)):
        assert np.array_equal(x.astype(np.int64), y.astype(np.int64))
    assert all(torch.equal(ia[k], ib[k]) for k in ia)


@pytest.mark.parametrize("over", [dict(fused="off"), dict(fused="interpret")])
def test_unported_configs_raise_naming_roadmap(over):
    cfg = scale_step.scale_sim_config(64, **over)
    with pytest.raises(ValueError, match="ROADMAP"):
        scale_step.scale_run_rounds(cfg, None, None, prng.key(0), None)


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = scale_step.scale_sim_config(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        scale_step.ScaleSimState.create(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        scale_step.NetModel.create(64)
    assert scale_step.ScaleSimState.create(cfg, "cpu").swim.alive.device.type == "cpu"


def test_port_config_is_the_jax_config():
    ours = scale_step.scale_sim_config(N, **OVER)
    theirs = jstep.scale_sim_config(N, **OVER)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import corrosion_tpu_torch.convert, corrosion_tpu_torch.sim.scale_step\n"
        "import corrosion_tpu_torch.sim.sync, corrosion_tpu_torch.ops.megakernel\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "corrosion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "corrosion_tpu"), (
                    path, name)
