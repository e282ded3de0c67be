"""The port's template engine and Consul bridge held to the JAX package's.

``render_template`` runs the same templates over the same rows (each
package's ``Database`` over a never-started agent, driven round by round
through the same writes) and must render the same text and record the same
queries. ``ConsulSync`` polls one stub Consul agent for both packages; the
``consul_services`` / ``consul_checks`` rows, their hashes and the
changed counts must be equal, poll by poll. Then the port's ``template
--once`` and ``consul sync --once`` subcommands run against a rig from
``corrosion_tpu_torch.testing.launch_test_agent`` on the CPU.
"""

import http.server
import json
import threading

import pytest

from corrosion_tpu import consul as jconsul
from corrosion_tpu.agent import Agent as JAgent
from corrosion_tpu.db import Database as JDatabase
from corrosion_tpu.testing import cluster_config as jcluster_config
from corrosion_tpu.tpl import render_template as j_render_template
from corrosion_tpu_torch import cli, consul
from corrosion_tpu_torch.agent import Agent
from corrosion_tpu_torch.db import Database
from corrosion_tpu_torch.testing import cluster_config, launch_test_agent
from corrosion_tpu_torch.tpl import render_template

SCHEMA = "CREATE TABLE svc (name TEXT PRIMARY KEY, addr TEXT, port INTEGER);"
ROWS = (("web", "10.0.0.1", 80), ("api", "10.0.0.2", 81),
        ("cache", "10.0.0.3", 82), ("db", None, 5432))

TEMPLATES = (
    # the JAX package's test template: rows, a loop, hostname()
    """
rows = sql("SELECT name, addr, port FROM svc")
for r in sorted(rows, key=lambda r: r["name"]):
    write(f"upstream {r['name']} {{ server {r['addr']}:{r['port']}; }}\\n")
write("# host: " + hostname() + "\\n")
""",
    # ORDER BY / LIMIT and an aggregate
    """
for r in sql("SELECT name, port FROM svc ORDER BY port DESC LIMIT 2"):
    write(f"{r['name']}:{r['port']}\\n")
n = sql("SELECT COUNT(*) AS n FROM svc")[0]["n"]
write(f"# {n} services\\n")
""",
    # JSON and CSV rendering, parameters, NULLs
    """
write(sql_json("SELECT name, addr FROM svc WHERE port > ? ORDER BY name", [80]))
write("\\n")
write(sql_csv("SELECT name, addr, port FROM svc ORDER BY name"))
write(json.dumps(sql("SELECT name FROM svc WHERE addr IS NULL")))
""",
)


def _drain(agent) -> None:
    """Rounds by hand until every queued write chunk entered a round."""
    while agent._write_queues:
        agent._one_round()
    agent._one_round()


def _pair():
    """A never-started agent and its Database for each package, the same
    schema and rows."""
    out = {}
    for name, agent in (("jax", JAgent(jcluster_config())),
                        ("port", Agent(cluster_config(), device="cpu"))):
        db = (JDatabase if name == "jax" else Database)(agent)
        db.apply_schema_sql(SCHEMA)
        db.execute(0, [("INSERT INTO svc (name, addr, port) VALUES (?, ?, ?)",
                        list(r)) for r in ROWS], wait=False)
        _drain(agent)
        out[name] = (agent, db)
    return out


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("which", range(len(TEMPLATES)))
def test_render_template_equals_jax(pair, which):
    src = TEMPLATES[which]
    (_, jdb), (_, db) = pair["jax"], pair["port"]
    want = j_render_template(src, lambda q, p: jdb.query(0, q, p))
    got = render_template(src, lambda q, p: db.query(0, q, p))
    assert got == want
    assert want[0] and want[1]


class StubConsul(http.server.BaseHTTPRequestHandler):
    """A Consul agent's two endpoints, answering what the test sets."""

    services: dict = {}
    checks: dict = {}

    def do_GET(self):
        body = {"/v1/agent/services": self.services,
                "/v1/agent/checks": self.checks}.get(self.path)
        if body is None:
            self.send_response(404)
            self.end_headers()
            return
        raw = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def log_message(self, *a):
        pass


@pytest.fixture()
def stub_consul():
    StubConsul.services = {"web-1": {"Service": "web", "Port": 80,
                                     "Tags": ["a", "b"]},
                           "api-1": {"Service": "api", "Port": 81}}
    StubConsul.checks = {"web-1-check": {"Status": "passing"},
                         "api-1-check": {"Status": "warning", "Output": "slow"}}
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), StubConsul)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="corro-test-stub-consul")
    t.start()
    yield f"127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def _consul_rows(db):
    return [[list(r) for r in db.query(
        0, f"SELECT id, data, hash FROM {t} ORDER BY id")[1]]
        for t in ("consul_services", "consul_checks")]


def test_consul_sync_rows_equal_jax(stub_consul):
    rigs = {}
    for name, agent, mod, db_cls in (
            ("jax", JAgent(jcluster_config()), jconsul, JDatabase),
            ("port", Agent(cluster_config(), device="cpu"), consul, Database)):
        db = db_cls(agent)
        db.apply_schema_sql(mod.CONSUL_SCHEMA)
        sync = mod.ConsulSync(
            mod.ConsulClient(stub_consul),
            execute=lambda stmts, node, db=db: db.execute(node, stmts,
                                                          wait=False))
        rigs[name] = (agent, db, sync)

    def poll():
        out = {}
        for name, (agent, db, sync) in rigs.items():
            changed = sync.sync_once()
            _drain(agent)
            out[name] = (changed, _consul_rows(db))
        assert out["port"] == out["jax"]
        return out["jax"]

    changed, (services, checks) = poll()
    assert changed == (2, 2) and len(services) == 2 and len(checks) == 2
    assert poll()[0] == (0, 0)  # unchanged: no writes
    del StubConsul.services["api-1"]
    StubConsul.checks["web-1-check"] = {"Status": "critical"}
    changed, (services, checks) = poll()
    assert changed == (1, 1) and [r[0] for r in services] == ["web-1"]
    assert json.loads(checks[1][1]) == {"Status": "critical"}
    obj = {"b": [1, 2], "a": {"z": None}}
    assert consul._hash(obj) == jconsul._hash(obj)


def test_template_and_consul_cli_on_the_port(tmp_path, stub_consul, capsys):
    src, dst = tmp_path / "t.py", tmp_path / "out.conf"
    src.write_text(TEMPLATES[0])
    with launch_test_agent(schema=SCHEMA, warm_rounds=3, http=True,
                           device="cpu") as rig:
        rig.client.execute([("INSERT INTO svc (name, addr, port) "
                             "VALUES (?, ?, ?)", list(r)) for r in ROWS])
        base = ["--api-port", str(rig.api.port)]
        assert cli.main(base + ["template", f"{src}:{dst}", "--once"]) == 0
        want, _ = render_template(TEMPLATES[0],
                                  lambda q, p: rig.db.query(0, q, p))
        assert dst.read_text() == want and "upstream web" in want
        assert cli.main(base + ["consul", "sync", "--consul-addr",
                                stub_consul, "--once"]) == 0
        printed = capsys.readouterr().out.strip().splitlines()
        assert printed[0] == f"rendered {dst}"
        assert json.loads(printed[-1]) == {"services": 2, "checks": 2}
        cols, rows = rig.client.query("SELECT id FROM consul_services ORDER BY id")
        assert rows == [["api-1"], ["web-1"]]


def test_launch_test_agent_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        with launch_test_agent():
            pass
