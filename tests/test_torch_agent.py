"""The PyTorch port's agent (``corrosion_tpu_torch/agent/``) against the JAX
package's: never-started agents driven by hand through the same writes,
faults and partitions hold every state leaf equal, round by round, with
tolerance 0; their Databases answer the same SQL with the same rows; and a
started port agent converges like ``tests/test_agent.py``'s."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from corrosion_tpu.agent import Agent as JAgent
from corrosion_tpu.config import Config as JConfig
from corrosion_tpu.db import Database as JDatabase
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.agent import Agent
from corrosion_tpu_torch.config import Config
from corrosion_tpu_torch.db import Database
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
N = 32
ROUNDS = 40
SCHEMA = """
CREATE TABLE svc (
    name TEXT PRIMARY KEY,
    addr TEXT,
    port INTEGER
);
"""


def small_config(cls, mode="scale", tx_max_cells=None):
    """``tests/test_agent.py``'s config (N=32, m 16, 4 origins, 4x2 cells,
    sync interval 4) for ``cls`` (either package's ``Config``);
    ``tx_max_cells`` overrides the scale round's transaction width."""
    cfg = cls()
    cfg.sim.mode = mode
    cfg.sim.n_nodes = N
    cfg.sim.m_slots = 16
    cfg.sim.n_origins = 4
    cfg.sim.n_rows = 4
    cfg.sim.n_cols = 2
    cfg.perf.sync_interval = 4
    cfg.gossip.drop_prob = 0.01
    if tx_max_cells is not None:
        base = type(cfg).to_scale_config
        cfg.to_scale_config = lambda: dataclasses.replace(
            base(cfg), tx_max_cells=tx_max_cells).validate()
    return cfg


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_same_state(jagent, agent, what):
    want = dict(leaves(convert.as_numpy_tree(jagent.device_state())))
    got = dict(leaves(convert.as_numpy_tree(agent.device_state())))
    assert want.keys() == got.keys(), what
    for name, a in want.items():
        b = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, name, np.argwhere(a != b)[:5])


def stage_events(agent, r):
    """The scripted writes and faults staged before round ``r``."""
    if r == 1:
        agent.write(0, 3, 777, wait=False)
    elif r == 2:
        agent.write_many(1, [(1, 5), (2, 6), (5, 7)], wait=False)
    elif r == 3:
        agent.write(2, 0, 11, wait=False)
        agent.write(2, 0, 12, wait=False)
    elif r == 5:
        agent.kill_node(7)
    elif r == 9:
        agent.write_many(3, [(6, 1), (7, 2)], wait=False)
    elif r == 12:
        agent.revive_node(7)
    elif r == 15:
        agent.set_partition(np.arange(N) % 2)
    elif r == 18:
        agent.write(0, 4, 99, wait=False)
    elif r == 25:
        agent.heal_partition()


@pytest.mark.parametrize("mode, tx", [("scale", None), ("full", None), ("scale", 4)],
                         ids=["scale", "full-tx8", "scale-tx4"])
def test_unstarted_agents_match_jax_round_by_round(mode, tx):
    jagent = JAgent(small_config(JConfig, mode, tx))
    agent = Agent(small_config(Config, mode, tx), device="cpu")
    assert dataclasses.asdict(agent.cfg) == dataclasses.asdict(jagent.cfg)
    if mode == "full":
        assert agent.cfg.tx_max_cells == 8
    for r in range(ROUNDS):
        for a in (jagent, agent):
            stage_events(a, r)
            a._one_round()
        assert_same_state(jagent, agent, f"{mode} tx={tx} round {r}")
    assert agent.round_no == jagent.round_no == ROUNDS
    assert agent.read_cell(N - 1, 3) == jagent.read_cell(N - 1, 3)
    assert agent.sync_state(9) == jagent.sync_state(9)
    assert agent.members() == jagent.members()
    assert agent.converged() == jagent.converged()


def test_databases_answer_the_same_queries():
    """The same SQL through both packages' Databases, over never-started
    agents driven round by round: equal states and equal query rows at
    every node asked."""
    def db_config(cls):
        cfg = small_config(cls)
        cfg.sim.n_rows, cfg.sim.n_cols = 8, 4  # a row holds svc's 3 columns
        return cfg

    jagent = JAgent(db_config(JConfig))
    agent = Agent(db_config(Config), device="cpu")
    jdb, db = JDatabase(jagent), Database(agent)
    writes = {
        0: [(0, [("INSERT INTO svc (name, addr, port) VALUES (?, ?, ?)",
                  ["web", "10.0.0.1", 80])])],
        2: [(1, ["INSERT INTO svc (name, addr, port) VALUES ('api', '10.0.0.2', 443)"])],
        4: [(0, [("UPDATE svc SET port = ? WHERE name = ?", [8080, "web"])]),
            (3, ["INSERT INTO svc (name, addr, port) VALUES ('db', '10.0.0.3', 5432)"])],
        9: [(1, ["DELETE FROM svc WHERE name = 'api'"])],
    }
    for d in (jdb, db):
        d.apply_schema_sql(SCHEMA)
    for r in range(30):
        for d in (jdb, db):
            for node, stmts in writes.get(r, []):
                d.execute(node, stmts, wait=False)
            d.agent._one_round()
        assert_same_state(jagent, agent, f"db round {r}")
    queries = [
        ("SELECT name, addr, port FROM svc ORDER BY name", None),
        ("SELECT COUNT(*) FROM svc", None),
        ("SELECT name FROM svc WHERE port > ?", [100]),
    ]
    for node in (0, 5, N - 1):
        for sql, params in queries:
            want = rows_of(jdb, node, sql, params)
            got = rows_of(db, node, sql, params)
            assert got == want, (node, sql)
    assert rows_of(db, N - 1, queries[0][0])[1] == [["db", "10.0.0.3", 5432],
                                                     ["web", "10.0.0.1", 8080]]
    assert db.state_dict() == jdb.state_dict()


def rows_of(db, node, sql, params=None):
    cols, rows = db.query(node, sql, params)
    return list(cols), [list(r) for r in rows]


@pytest.mark.parametrize("mode", ["scale", "full"])
def test_round_leaves_its_input_state_unchanged(mode):
    """The round is functional: the state it was given (and so any reader
    holding it) is bit for bit what it was."""
    agent = Agent(small_config(Config, mode), device="cpu")
    for r in range(6):
        stage_events(agent, r)
        agent._one_round()
    agent.write_many(1, [(1, 8), (2, 9)], wait=False)
    agent.kill_node(4)
    before = agent._state
    copy = convert.as_numpy_tree(agent.device_state())
    agent._one_round()
    assert agent._state is not before
    after = dict(leaves(convert.as_numpy_tree(agent.device_state())))
    kept = dict(leaves(convert.state_to_numpy(before)))
    for name, a in leaves(copy):
        assert np.array_equal(kept[name], a), name
    assert any(not np.array_equal(after[k], kept[k]) for k in kept)


# --- a started agent ----------------------------------------------------------


@pytest.fixture(scope="module")
def started():
    with Agent(small_config(Config), device="cpu") as a:
        assert a.wait_rounds(30, timeout=120)
        yield a


def _wait_for(agent, pred, rounds):
    for _ in range(rounds):
        if pred():
            return True
        assert agent.wait_rounds(1, timeout=30)
    return pred()


def test_started_agent_gossips_a_write(started):
    out = started.write(node=0, cell=3, value=777, timeout=30)
    assert out["rows_affected"] == 1
    assert _wait_for(started, lambda: started.read_cell(N - 1, 3)["value"] == 777, 400)
    cell = started.read_cell(N - 1, 3)
    assert cell["site"] == 0 and cell["col_version"] >= 1
    health = started.health()
    assert health["status"] == "ok" and health["device"] == "cpu"


def test_started_agent_survives_kill_and_revive(started):
    started.kill_node(5)
    assert started.wait_rounds(3, timeout=30)
    assert not started.snapshot()["alive"][5]
    started.write(node=1, cell=2, value=4242, timeout=30)
    started.revive_node(5)
    assert _wait_for(started, lambda: bool(started.snapshot()["alive"][5]), 10)
    assert _wait_for(started, lambda: started.read_cell(5, 2)["value"] == 4242, 600)
    assert _wait_for(started, started.converged, 600)
    members = started.members()
    assert len(members) == N and members[5]["state"] == "Alive"


def test_concurrent_writers_lose_no_write():
    """More writer threads than cores against a started agent, with a short
    switch interval: every write returns, and each origin's own head
    counts exactly the versions its writers made."""
    import threading

    agent = Agent(small_config(Config), device="cpu").start()
    per_thread, threads_per_node = 6, 4
    errors = []

    def writer(node, t):
        try:
            for i in range(per_thread):
                agent.write(node, (t * per_thread + i) % agent.n_cells, 1000 * t + i,
                            timeout=60)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(node, t))
                   for node in range(4) for t in range(threads_per_node)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors, errors
        head = agent.snapshot()["head"]
        for node in range(4):
            assert head[node, node] == per_thread * threads_per_node, (node, head[node])
    finally:
        agent.shutdown()


def test_started_agent_validates_writes(started):
    with pytest.raises(ValueError, match="not a writer"):
        started.write(node=N - 1, cell=0, value=1)
    with pytest.raises(ValueError, match="out of range"):
        started.write(node=0, cell=10_000, value=1)


# --- no fallback, and what is not ported --------------------------------------


def test_agent_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        Agent(small_config(Config))


@pytest.mark.parametrize("fused", ["off", "interpret"])
@pytest.mark.parametrize("mode", ["scale", "full"])
def test_agent_refuses_paths_the_port_lacks(mode, fused):
    cfg = small_config(Config, mode)
    cfg.perf.fused = fused
    with pytest.raises(ValueError, match="no XLA or interpret path"):
        Agent(cfg, device="cpu")


def test_crashed_round_loop_trips_shutdown(monkeypatch):
    """A round that raises ends the loop, trips the tripwire and wakes a
    queued writer with an error instead of a false success."""
    agent = Agent(small_config(Config), device="cpu")

    def broken():
        raise RuntimeError("injected round fault")

    monkeypatch.setattr(agent, "_one_round", broken)
    agent.start()
    assert agent.tripwire.wait(30)
    agent.shutdown()
    assert agent.health()["status"] == "down"
    with pytest.raises(RuntimeError, match="shut down"):
        agent.write(0, 1, 2, timeout=5)


def test_auto_recover_boots_from_the_newest_checkpoint_and_rolls_back(tmp_path,
                                                                      monkeypatch):
    """``start(auto_recover=True)`` restores the newest valid checkpoint
    under ``db.path`` (skipping a corrupt newer one) and resumes its round;
    a round that fails mid-run rolls the state back to it and the loop
    goes on."""
    from corrosion_tpu_torch import checkpoint as ckpt

    cfg = small_config(Config)
    cfg.db.path = str(tmp_path)
    donor = Agent(cfg, device="cpu")
    for r in range(6):
        stage_events(donor, r)
        donor._one_round()
    ckpt.save_checkpoint(donor, path=str(tmp_path / "auto-a"))
    bad = ckpt.save_checkpoint(donor, path=str(tmp_path / "auto-b"))
    with open(os.path.join(bad, "shard-00000.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\0" * 16)
    want = convert.as_numpy_tree(donor.device_state())

    agent = Agent(cfg, device="cpu")
    real = agent._one_round
    calls = []

    def one_round():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected round fault")
        return real()

    monkeypatch.setattr(agent, "_one_round", one_round)
    seen = []
    monkeypatch.setattr(agent, "restore_state", _recording(agent.restore_state, seen))
    agent.start(auto_recover=True)
    try:
        assert agent.wait_rounds(4, timeout=60)
        assert len(seen) == 2 and agent.generation == 2
        for got in seen:
            for (name, a), (_, b) in zip(leaves(want), leaves(convert.as_numpy_tree(got))):
                assert np.array_equal(a, b), name
        assert agent.round_no >= 6 + 4 and not agent.tripwire.tripped
    finally:
        agent.shutdown()


def _recording(fn, seen):
    def wrapped(state, *a, **k):
        seen.append(state)
        return fn(state, *a, **k)

    return wrapped


def test_agent_soak_names_its_roadmap_item():
    """The soak and its sharded form are ported: a mesh whose shard count
    does not divide the node axis is refused as JAX's sharding refuses it,
    before any round runs."""
    from corrosion_tpu_torch.parallel import make_mesh

    agent = Agent(small_config(Config), device="cpu")
    with pytest.raises(ValueError, match="divisible by 3"):
        agent.soak(8, mesh=make_mesh(["cpu"] * 3))
    assert agent.round_no == 0


def test_supervised_agent_binds_its_tripwire():
    from corrosion_tpu_torch.resilience import Supervisor

    sup = Supervisor(deadline_seconds=60.0)
    agent = Agent(small_config(Config), device="cpu").start(supervisor=sup)
    try:
        assert agent.wait_rounds(2, timeout=60)
        assert agent.health()["supervisor"]["state"] in ("idle", "running")
        assert sup._abort() is False
    finally:
        agent.shutdown()
    assert sup._abort() is True


def test_host_plane_imports_no_jax():
    code = (
        "import sys\n"
        "import corrosion_tpu_torch.agent, corrosion_tpu_torch.cli\n"
        "import corrosion_tpu_torch.api, corrosion_tpu_torch.admin\n"
        "import corrosion_tpu_torch.maintenance, corrosion_tpu_torch.client\n"
        "import corrosion_tpu_torch.db, corrosion_tpu_torch.pubsub\n"
        "import corrosion_tpu_torch.obs.memory, corrosion_tpu_torch.config\n"
        "import corrosion_tpu_torch.checkpoint, corrosion_tpu_torch.utils.lifecycle\n"
        "import corrosion_tpu_torch.utils.metrics, corrosion_tpu_torch.utils.tracing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'corrosion_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
