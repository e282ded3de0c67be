"""The port's corrosan (``corrosion_tpu_torch/analysis/sanitizer``) against
the JAX package's, on the CPU.

1. **fixture verdicts** — each of the nine seeded race/leak fixtures
   gives JAX's ``(name, expect, found, ok)``, the agent-backed pubsub pair
   on the port's ``Agent(device="cpu")``;
2. **witnessed ⊆ static** — the sanitized battery of
   ``tests/test_corrosan.py`` on the port's threaded stack (agent round
   loop with a ``Supervisor``, subscriptions, updates feed, HTTP API,
   persist worker) is clean, witnesses
   ``SubsManager._mu -> Matcher._mu``, and every named witnessed edge is
   in the port's static graph or its allowlist. Without the supervisor's
   lock the battery reports two ``Supervisor.state`` races (the round
   thread's write against ``/v1/health``'s read);
3. **plumbing** — locks get their static names, the allowlists cannot go
   stale and each entry has its JAX counterpart, spawns carry the
   ``corro-`` prefix, the ``san`` report has its schema, every finding
   kind is in ``docs/corrosan.md``, ``CORROSAN=1 load`` runs sanitized,
   and the pytest plugin arms alone and stands down beside JAX's."""

import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

from corrosion_tpu.analysis.sanitizer import KINDS as J_KINDS
from corrosion_tpu.analysis.sanitizer import run_fixture as j_run_fixture
from corrosion_tpu.analysis.sanitizer import allowlist as j_allowlist
from corrosion_tpu.analysis.sanitizer.attrs import TRACKED_CLASSES as J_TRACKED
from corrosion_tpu_torch import cli
from corrosion_tpu_torch.analysis.sanitizer import (
    FIXTURES,
    KINDS,
    run_fixture,
    sanitized,
    static_lock_graph,
)
from corrosion_tpu_torch.analysis.sanitizer import allowlist
from corrosion_tpu_torch.analysis.sanitizer.attrs import TRACKED_CLASSES
from corrosion_tpu_torch.config import Config
from one_thread import one_torch_thread  # noqa: F401  (module fixture: one torch thread)

ROOT = Path(__file__).resolve().parent.parent


def small_config():
    cfg = Config()
    cfg.sim.n_nodes = 16
    cfg.sim.m_slots = 8
    cfg.sim.n_origins = 4
    cfg.sim.n_rows = 8
    cfg.sim.n_cols = 2
    cfg.gossip.drop_prob = 0.0
    return cfg


def _jax_name(name: str) -> str:
    return name.replace("corrosion_tpu_torch.", "corrosion_tpu.")


# --- 1. fixture verdicts ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_verdict_equals_jax(name):
    mine = run_fixture(name, device="cpu")
    want = j_run_fixture(name)
    assert (mine.name, mine.expect, mine.found, mine.ok) == (
        want.name, want.expect, want.found, want.ok), mine.details
    assert mine.ok, mine.details


# --- 2. witnessed ⊆ static -------------------------------------------------

def test_sanitized_battery_clean_and_witness_subset_of_static(tmp_path):
    with sanitized() as san:
        from corrosion_tpu_torch.agent import Agent
        from corrosion_tpu_torch.api import ApiServer
        from corrosion_tpu_torch.db import Database
        from corrosion_tpu_torch.pubsub import SubsManager, UpdatesManager
        from corrosion_tpu_torch.resilience import Supervisor

        sup = Supervisor(deadline_seconds=300.0)
        agent = Agent(small_config(), device="cpu").start(supervisor=sup)
        try:
            db = Database(agent)
            db.apply_schema_sql(
                "CREATE TABLE t (pk INTEGER PRIMARY KEY, v INTEGER);")
            mgr = SubsManager(db, persist_dir=str(tmp_path / "subs"))
            matcher, _ = mgr.subscribe(0, "SELECT pk, v FROM t")
            matcher.attach()
            upd = UpdatesManager(db)
            feed_q = upd.attach("t")
            api = ApiServer(db, subs=mgr, updates=upd).start()
            for i in range(4):
                db.execute(0, [(f"INSERT INTO t (pk, v) VALUES ({i}, {i * 7})",)])
            assert agent.wait_rounds(3, timeout=300)
            with urllib.request.urlopen(
                    f"http://{api.addr}:{api.port}/v1/health", timeout=30) as resp:
                health = json.load(resp)
            assert health["round"] >= 0
            assert health["supervisor"]["state"] in ("idle", "running")
            mgr.unsubscribe(matcher.id)
            assert agent.wait_rounds(2, timeout=300)
            upd.detach("t", feed_q)
            api.stop()
            mgr.close()
        finally:
            agent.shutdown()

    findings = san.gate()
    assert not findings, "sanitized battery is not clean:\n" + "\n".join(
        f.render() for f in findings)
    named = san.witness.named_edges()
    assert ("corrosion_tpu_torch.pubsub.SubsManager._mu",
            "corrosion_tpu_torch.pubsub.Matcher._mu") in named, named
    extra = named - static_lock_graph().edge_names() - set(allowlist.ALLOWED_LOCK_EDGES)
    assert not extra, f"witnessed lock edges outside static graph + allowlist: {extra}"
    assert san.leaks.spawned_count() > 10


# --- 3. plumbing -----------------------------------------------------------

def test_runtime_locks_get_static_names():
    with sanitized():
        from corrosion_tpu_torch.resilience.supervisor import Supervisor
        from corrosion_tpu_torch.utils.locks import LockRegistry

        sup = Supervisor()
        registry = LockRegistry()
        tracked = registry.lock("probe")
        anon = threading.Lock()
    assert sup._mu.san_node.name == "corrosion_tpu_torch.resilience.supervisor.Supervisor._mu"
    assert registry._mu.san_node.name == "corrosion_tpu_torch.utils.locks.LockRegistry._mu"
    assert tracked._lock.san_node.name == "corrosion_tpu_torch.utils.locks.TrackedLock._lock"
    assert getattr(anon, "san_node", None) is None


def test_allowlists_cannot_go_stale_and_mirror_jax():
    """Every allow-listed lock node exists in the static graph, every entry
    has a reason, and each table (with the tracked classes) is JAX's,
    named after the port's modules: no entry without its counterpart."""
    nodes = {n.name for n in static_lock_graph().creation_sites}
    for (frm, to), reason in allowlist.ALLOWED_LOCK_EDGES.items():
        assert frm in nodes and to in nodes and reason.strip()
    for table in (allowlist.ALLOWED_ATTR_RACES, allowlist.ALLOWED_LEAK_PREFIXES):
        for key, reason in table.items():
            assert str(reason).strip(), f"{key} has no reason"
    assert {(_jax_name(a), _jax_name(b)) for a, b in allowlist.ALLOWED_LOCK_EDGES} \
        == set(j_allowlist.ALLOWED_LOCK_EDGES)
    assert set(allowlist.ALLOWED_ATTR_RACES) == set(j_allowlist.ALLOWED_ATTR_RACES)
    assert set(allowlist.ALLOWED_LEAK_PREFIXES) == set(j_allowlist.ALLOWED_LEAK_PREFIXES)
    assert {_jax_name(m): c for m, c in TRACKED_CLASSES.items()} == J_TRACKED


def test_spawns_carry_corro_prefix():
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.api import ApiServer
    from corrosion_tpu_torch.db import Database

    agent = Agent(small_config(), device="cpu").start()
    try:
        api = ApiServer(Database(agent)).start()
        try:
            names = {t.name for t in threading.enumerate()}
            assert {"corro-agent-round-loop", "corro-api-http"} <= names
        finally:
            api.stop()
    finally:
        agent.shutdown()


def test_san_cli_report_schema(tmp_path, capsys):
    from corrosion_tpu_torch.analysis.sanitizer.report import load_section

    out = str(tmp_path / "san.json")
    assert cli.main(["san", "race-unlocked", "race-locked", "--output-json", out,
                     "--format", "json", "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    with open(out) as f:
        doc = json.load(f)
    assert doc["tool"] == "corrosan" and doc["version"] == 1
    section = doc["sections"]["fixtures"]
    assert section == printed == load_section(out, "fixtures")
    assert load_section(out, "pytest") is None
    assert section["ok"] is True
    assert {r["name"] for r in section["results"]} == {"race-unlocked", "race-locked"}
    for r in section["results"]:
        assert set(r) >= {"name", "expect", "found", "ok", "details"}
    assert cli.main(["san", "--list-fixtures"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == len(FIXTURES)


def test_finding_kinds_documented():
    doc = (ROOT / "docs" / "corrosan.md").read_text()
    assert set(KINDS) == set(J_KINDS)
    assert [kind for kind in KINDS if kind not in doc] == []
    for fixture_name in ("pubsub-resurrect-reverted", "race-unlocked"):
        assert fixture_name in doc


def test_corrosan_load_runs_sanitized(tmp_path, capsys, monkeypatch):
    """``CORROSAN=1 load`` at the CLI's own rig (N=16) and a small traffic:
    the run rides one sanitized window, reports it, and is clean."""
    monkeypatch.setenv("CORROSAN", "1")
    out = tmp_path / "serve.json"
    assert cli.main(["load", "--device", "cpu", "--writers", "2", "--subscribers", "1",
                     "--pg-readers", "1", "--write-ops", "3", "--pg-ops", "3",
                     "--keys", "4", "--output-json", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["corrosan"] is True and rec["ok"], rec.get("problems")
    assert not rec.get("problems")


LEAKY_TEST = '''
import threading


def test_leaks_a_thread():
    assert threading.Lock.__module__ == "corrosion_tpu_torch.analysis.sanitizer.runtime"
    threading.Thread(target=threading.Event().wait, name="seeded-leak",
                     daemon=True).start()
'''

BESIDE_JAX_TEST = '''
import threading


def test_one_sanitizer_is_installed():
    assert threading.Lock.__module__ == "corrosion_tpu.analysis.sanitizer.runtime"
'''


def test_pytest_plugin_arms_alone_and_stands_down_beside_jax(tmp_path):
    """Under ``CORROSAN=1`` the port's plugin alone instruments the session,
    writes the report's ``pytest`` section and fails the session on a
    seeded thread leak; loaded beside JAX's plugin it registers no second
    ``--corrosan`` and installs no second sanitizer. The throwaway test
    files sit outside ``tests/``, so no conftest loads."""
    (tmp_path / "leaky").mkdir()
    (tmp_path / "leaky" / "test_leaky.py").write_text(LEAKY_TEST)
    (tmp_path / "both").mkdir()
    (tmp_path / "both" / "test_both.py").write_text(BESIDE_JAX_TEST)
    env = dict(os.environ, CORROSAN="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    port_plugin = ["-p", "corrosion_tpu_torch.analysis.sanitizer.plugin"]
    runs = {}
    for name, plugins in (("leaky", port_plugin),
                          ("both", ["-p", "corrosion_tpu.analysis.sanitizer.plugin"]
                           + port_plugin)):
        runs[name] = subprocess.Popen(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-p", "no:xdist", "-p", "no:randomly", *plugins, str(tmp_path / name)],
            cwd=tmp_path / name, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(env, CORROSAN_REPORT=str(tmp_path / f"{name}.json")))
    out = {name: proc.communicate(timeout=240)[0] for name, proc in runs.items()}
    assert runs["leaky"].returncode == 1, out["leaky"]
    assert "1 passed" in out["leaky"] and "thread-leak: seeded-leak" in out["leaky"]
    section = json.loads((tmp_path / "leaky.json").read_text())["sections"]["pytest"]
    assert section["clean"] is False and section["kind_counts"] == {"thread-leak": 1}
    assert section["threads_spawned"] == 1 and section["pytest_exitstatus"] == 0
    assert runs["both"].returncode == 0, out["both"]
    assert "1 passed" in out["both"] and out["both"].count("corrosan: ") == 1
