"""The PyTorch port's host plane: the HTTP API and its client, the admin
socket, the maintenance loop, checkpoints and node backups that carry the
host database across both packages, the config file, the retry policy, and
``python -m corrosion_tpu_torch agent`` as a process on the CPU."""

import json
import os
import random
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from corrosion_tpu import checkpoint as jckpt
from corrosion_tpu.agent import Agent as JAgent
from corrosion_tpu.config import Config as JConfig
from corrosion_tpu.config import load_config as jload_config
from corrosion_tpu.db import Database as JDatabase
from corrosion_tpu.utils import backoff as jbackoff
from corrosion_tpu_torch import checkpoint as ckpt
from corrosion_tpu_torch import cli, convert
from corrosion_tpu_torch.admin import AdminClient, AdminServer
from corrosion_tpu_torch.agent import Agent
from corrosion_tpu_torch.api import ApiServer
from corrosion_tpu_torch.client import CorrosionApiClient
from corrosion_tpu_torch.config import Config, default_toml, load_config
from corrosion_tpu_torch.db import Database
from corrosion_tpu_torch.maintenance import MaintenanceLoop
from corrosion_tpu_torch.utils.backoff import Backoff, retry_call
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
SCHEMA = "CREATE TABLE kv (k TEXT PRIMARY KEY, v INTEGER);"
N = 16


def rig_config(cls=Config):
    """``tests/test_admin_cli.py``'s config for either package."""
    cfg = cls()
    cfg.sim.mode = "scale"
    cfg.sim.n_nodes = N
    cfg.sim.m_slots = 8
    cfg.sim.n_origins = 4
    cfg.sim.n_rows = 8
    cfg.sim.n_cols = 4
    cfg.perf.sync_interval = 4
    cfg.gossip.drop_prob = 0.0
    return cfg


def assert_same_state(a, b, what):
    """Every leaf of two ``device_state()`` trees (either package) equal."""
    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, tree

    want = dict(leaves(convert.as_numpy_tree(a)))
    got = dict(leaves(convert.as_numpy_tree(b)))
    assert want.keys() == got.keys(), what
    for name, x in want.items():
        assert x.dtype == got[name].dtype, (what, name)
        assert np.array_equal(x, got[name]), (what, name)


def rows_of(db, node, sql="SELECT k, v FROM kv ORDER BY k"):
    cols, rows = db.query(node, sql)
    return [list(r) for r in rows]


# --- a started agent behind the HTTP API and the admin socket -------------------


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    uds = str(tmp_path_factory.mktemp("adm") / "admin.sock")
    with Agent(rig_config(), device="cpu") as agent:
        assert agent.wait_rounds(10, timeout=120)
        db = Database(agent)
        db.apply_schema_sql(SCHEMA)
        with ApiServer(db, port=0) as api, AdminServer(agent, uds, db=db):
            yield agent, db, CorrosionApiClient(api.addr, api.port), uds


def test_http_execute_query_health_memory_metrics(rig):
    agent, _, client, _ = rig
    out = client.execute([("INSERT INTO kv (k, v) VALUES (?, ?)", ["a", 1]),
                          "INSERT INTO kv (k, v) VALUES ('b', 2)"], node=0)
    assert [r["rows_affected"] for r in out] == [1, 1]
    cols, rows = client.query("SELECT k, v FROM kv ORDER BY k", node=0)
    assert cols == ["k", "v"] and rows == [["a", 1], ["b", 2]]
    # cells replicate one by one: wait for the whole rows at the far node
    for _ in range(200):
        if client.query("SELECT k, v FROM kv ORDER BY k", node=N - 1)[1] == rows:
            break
        assert agent.wait_rounds(1, timeout=30)
    assert client.query("SELECT v FROM kv WHERE k = ?", ["b"], node=N - 1)[1] == [[2]]
    health = client._request_json("GET", "/v1/health")
    assert health["status"] == "ok" and health["device"] == "cpu"
    assert health["round"] >= 10 and health["n_nodes"] == N
    mem = client._request_json("GET", "/v1/obs/memory")
    assert mem["total_bytes"] == sum(t["nbytes"] for t in mem["tables"].values())
    assert mem["tables"]["swim.mem_id"]["class"] == "O(N*M)"
    assert mem["tables"]["crdt.store[1]"]["nbytes"] == N * 8 * 4 * 4
    text = client.metrics()
    assert "corro.mem.state.bytes" in text or "corro_mem_state_bytes" in text
    assert len(client.members()) == N


def test_subscription_streams_a_change(rig):
    """``/v1/subscriptions``: the snapshot, then a change pushed by the
    agent's round listener after a write."""
    import threading

    agent, _, client, _ = rig
    client.execute([("INSERT INTO kv (k, v) VALUES (?, ?)", ["s", 10])], node=0)
    stream = client.subscribe("SELECT k, v FROM kv WHERE k = 's'")
    events = iter(stream)
    assert next(events) == {"columns": ["k", "v"]}
    for ev in events:
        if "eoq" in ev:
            break
    got, done = {}, threading.Event()

    def reader():
        for ev in events:
            if "change" in ev:
                got["change"] = ev["change"]
                done.set()
                return

    threading.Thread(target=reader, daemon=True).start()
    client.execute([("UPDATE kv SET v = ? WHERE k = ?", [11, "s"])], node=0)
    assert agent.wait_rounds(3, timeout=60)
    assert done.wait(30), "no change event"
    kind, key, row, _change_id = got["change"]
    assert key == "s" and row == ["s", 11] and kind in ("insert", "update")
    stream.close()


def test_admin_kill_revive_checkpoint_backup(rig, tmp_path):
    agent, db, _, uds = rig
    with AdminClient(uds) as admin:
        assert admin.call("ping") == "pong"
        assert admin.call("kill", node=3) is True
        assert agent.wait_rounds(2, timeout=30)
        assert not agent.snapshot()["alive"][3]
        assert admin.call("revive", node=3) is True
        assert agent.wait_rounds(2, timeout=30)
        assert agent.snapshot()["alive"][3]
        path = admin.call("checkpoint", path=str(tmp_path / "ck"))
        summary = ckpt.verify_checkpoint(path)
        assert summary["mode"] == "scale" and summary["format"] == 3
        with open(os.path.join(path, "manifest.json")) as f:
            assert json.load(f)["db"] == db.state_dict()
        assert jckpt.verify_checkpoint(path)["n_leaves"] == summary["n_leaves"]
        bpath = admin.call("backup", path=str(tmp_path / "b.npz"), node=0)
        assert os.path.exists(bpath) and os.path.exists(bpath + ".db.json")
        assert admin.call("restore", path=path)["round"] == summary["round"]
        assert admin.call("sync", node=0)["actor_id"] == 0


def test_maintenance_checkpoint_cadence(rig, tmp_path):
    agent, db, _, _ = rig
    maint = MaintenanceLoop(agent, db=db, checkpoint_path=str(tmp_path),
                            checkpoint_rounds=1)
    assert agent.wait_rounds(2, timeout=30)
    first = maint.tick()
    assert first and first.endswith("auto-a")
    assert agent.wait_rounds(2, timeout=30)
    second = maint.tick()
    assert second and second.endswith("auto-b")
    assert MaintenanceLoop.latest_auto_checkpoint(str(tmp_path)) == second
    slow = MaintenanceLoop(agent, db=db, checkpoint_path=str(tmp_path / "slow"),
                           checkpoint_rounds=10_000_000)
    slow._last_ckpt_round = agent.round_no
    assert slow.tick() is None


# --- checkpoints and backups across the packages -------------------------------


@pytest.fixture(scope="module")
def twins():
    """A JAX agent and a port agent (never started) with their Databases,
    driven by hand through the same SQL for 12 rounds."""
    jagent, agent = JAgent(rig_config(JConfig)), Agent(rig_config(), device="cpu")
    jdb, db = JDatabase(jagent), Database(agent)
    for d in (jdb, db):
        d.apply_schema_sql(SCHEMA)
    for r in range(12):
        for d in (jdb, db):
            if r in (0, 3, 6):
                d.execute(r % 4, [("INSERT INTO kv (k, v) VALUES (?, ?)",
                                   [f"k{r}", r * 10])], wait=False)
            d.agent._one_round()
    assert_same_state(jagent.device_state(), agent.device_state(), "twins")
    assert rows_of(jdb, 0) == rows_of(db, 0)
    return jagent, jdb, agent, db


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_with_db_crosses_packages(twins, tmp_path, writer):
    jagent, jdb, agent, db = twins
    path = str(tmp_path / "ck")
    if writer == "jax":
        jckpt.save_checkpoint(jagent, db=jdb, path=path)
        fresh = Agent(rig_config(), device="cpu")
        fresh_db = Database(fresh)
        man = ckpt.restore_checkpoint(fresh, path, db=fresh_db)
    else:
        ckpt.save_checkpoint(agent, db=db, path=path)
        fresh = JAgent(rig_config(JConfig))
        fresh_db = JDatabase(fresh)
        man = jckpt.restore_checkpoint(fresh, path, db=fresh_db)
    assert man["round"] == 12 and man["db"] is not None
    assert_same_state(jagent.device_state(), fresh.device_state(), writer)
    for node in (0, N - 1):
        assert rows_of(fresh_db, node) == rows_of(jdb, node)
    assert fresh_db.state_dict() == jdb.state_dict()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_backup_crosses_packages(twins, tmp_path, writer):
    """A node backup written by either package restores onto node 5 of a
    fresh agent of each package with the same state and rows."""
    jagent, jdb, agent, db = twins
    path = str(tmp_path / "b.npz")
    if writer == "jax":
        jckpt.backup_node(jagent, 1, db=jdb, path=path)
    else:
        ckpt.backup_node(agent, 1, db=db, path=path)
    jfresh, fresh = JAgent(rig_config(JConfig)), Agent(rig_config(), device="cpu")
    jfresh_db, fresh_db = JDatabase(jfresh), Database(fresh)
    assert jckpt.restore_backup(jfresh, path, node=5, db=jfresh_db) == 5
    assert ckpt.restore_backup(fresh, path, node=5, db=fresh_db) == 5
    assert_same_state(jfresh.device_state(), fresh.device_state(), writer)
    assert rows_of(fresh_db, 5) == rows_of(jfresh_db, 5) == rows_of(jdb, 1)
    snap = fresh.snapshot()
    assert (snap["store"][2][5] == 5).sum() == (jagent.snapshot()["store"][2][1] == 1).sum()


def test_default_config_loads_in_both_packages(tmp_path):
    path = tmp_path / "cfg.toml"
    path.write_text(default_toml())
    ours, theirs = load_config(str(path)), jload_config(str(path))
    import dataclasses

    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.sim_config()) == dataclasses.asdict(theirs.sim_config())


# --- the retry policy -----------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(min_wait=0.05, max_wait=0.5),
                                dict(min_wait=0.5, max_wait=2.0)])
def test_backoff_draws_the_jax_delays(kw):
    # the port's jitter draws from the module's ``random``; JAX's from the
    # ``rng`` it is given: one seed, one sequence
    random.seed(7)
    ours = list(Backoff(max_retries=8, **kw))
    theirs = list(jbackoff.Backoff(max_retries=8, rng=random.Random(7), **kw))
    assert ours == theirs and len(ours) == 8


def test_retry_call_honours_retry_after_and_abort():
    class Busy(ConnectionError):
        retry_after = 0.25

    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise Busy("503")
        return "done"

    out = retry_call(flaky, backoff=Backoff(0.01, max_wait=0.1, max_retries=5),
                     retry_on=(ConnectionError,), sleep=slept.append)
    assert out == "done" and slept == [0.1, 0.1]  # the hint, capped at max_wait
    calls.clear()
    with pytest.raises(Busy):
        retry_call(flaky, backoff=Backoff(0.01, max_retries=5), retry_on=(ConnectionError,),
                   sleep=slept.append, abort=lambda: True)
    assert len(calls) == 1


# --- the agent as a process -----------------------------------------------------


def test_cli_agent_refuses_the_pg_listener(tmp_path):
    """``pg.enabled = true`` is no longer refused: the agent process serves
    PG wire beside HTTP, names it in its ready line, answers a query over it
    and stops on SIGTERM with exit 0."""
    from corrosion_tpu_torch.obs.load import _PgClient

    schema = tmp_path / "schema.sql"
    schema.write_text(SCHEMA)
    cfg = tmp_path / "cfg.toml"
    cfg.write_text(
        f'[db]\npath = "{tmp_path / "state"}"\nschema_paths = ["{schema}"]\n'
        f'[api]\nport = 0\n[admin]\nuds_path = "{tmp_path / "admin.sock"}"\n'
        f'[pg]\nenabled = true\nport = 0\n'
        f'[sim]\nn_nodes = {N}\nm_slots = 8\nn_origins = 4\nn_rows = 8\nn_cols = 4\n')
    proc = subprocess.Popen(
        [sys.executable, "-m", "corrosion_tpu_torch", "agent", "-c", str(cfg),
         "--device", "cpu", "--pace", "0.01"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        while not line.startswith("agent up"):
            line = proc.stdout.readline()
            assert line, "the agent exited before it came up"
        m = re.search(r"http://([\d.]+):(\d+) .* pg ([\d.]+):(\d+) nodes=", line)
        assert m, line
        client = CorrosionApiClient(m.group(1), int(m.group(2)))
        client.execute([("INSERT INTO kv (k, v) VALUES (?, ?)", ["p", 3])])
        pg = _PgClient(m.group(3), int(m.group(4)))
        assert pg.query("SELECT k, v FROM kv") == [["p", "3"]]
        pg.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_agent_process_serves_and_stops_on_sigterm(tmp_path):
    schema = tmp_path / "schema.sql"
    schema.write_text(SCHEMA)
    uds = tmp_path / "admin.sock"
    cfg = tmp_path / "cfg.toml"
    cfg.write_text(
        f'[db]\npath = "{tmp_path / "state"}"\nschema_paths = ["{schema}"]\n'
        f'[api]\nport = 0\n[admin]\nuds_path = "{uds}"\n'
        f'[sim]\nn_nodes = {N}\nm_slots = 8\nn_origins = 4\nn_rows = 8\nn_cols = 4\n'
        f'[gossip]\ndrop_prob = 0.0\n'
    )
    proc = subprocess.Popen(
        [sys.executable, "-m", "corrosion_tpu_torch", "agent", "-c", str(cfg),
         "--device", "cpu", "--pace", "0.01"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        line = ""
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line.startswith("agent up") or not line:
                break
        m = re.search(r"http://([\d.]+):(\d+) .*device=cpu", line)
        assert m, line
        port = m.group(2)
        base = ["--api-addr", m.group(1), "--api-port", port, "--admin-path", str(uds)]
        assert cli.main(base + ["exec", "INSERT INTO kv (k, v) VALUES (?, ?)",
                                "--param", "x", "--param", "7"]) == 0
        client = CorrosionApiClient(m.group(1), int(port))
        assert client.query("SELECT k, v FROM kv", node=0)[1] == [["x", 7]]
        assert cli.main(base + ["query", "SELECT v FROM kv", "--node", "0"]) == 0
        ck = str(tmp_path / "ck")
        assert cli.main(base + ["checkpoint", ck]) == 0
        assert cli.main(["verify-checkpoint", ck]) == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
