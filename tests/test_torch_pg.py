"""The port's PostgreSQL wire server held byte for byte to the JAX package's.

One scripted session (startup with an SSLRequest, simple and multi-statement
queries, the extended protocol with named and unnamed statements and
portals, binary parameters and results, transactions that commit, roll back
and abort, the catalog introspection queries, node selection by database
name, and every error class ``_sqlstate_for`` and the handler send) goes to
a ``PgServer`` over each package's agent (JAX on the CPU, the port with
``device="cpu"``), both started over the same schema. The two response
streams must be equal byte for byte; nothing is masked (``BackendKeyData``
is ``0, 0`` in both). Reads at another node's replica wait, outside the
wire, until both agents hold the row there.
"""

import socket
import struct
import time

import pytest

from corrosion_tpu.agent import Agent as JAgent
from corrosion_tpu.api.admission import AdmissionController as JAdmission
from corrosion_tpu.config import ServeConfig as JServeConfig
from corrosion_tpu.db import Database as JDatabase
from corrosion_tpu.pg import PgServer as JPgServer
from corrosion_tpu.pg import _sqlstate_for as j_sqlstate_for
from corrosion_tpu.testing import cluster_config as jcluster_config
from corrosion_tpu_torch.agent import Agent
from corrosion_tpu_torch.api.admission import AdmissionController
from corrosion_tpu_torch.config import ServeConfig
from corrosion_tpu_torch.db import Database
from corrosion_tpu_torch.pg import PgServer, _sqlstate_for
from corrosion_tpu_torch.testing import cluster_config

SCHEMA = """
CREATE TABLE users (id INTEGER PRIMARY KEY, name TEXT, score INTEGER,
                    ratio REAL);
CREATE TABLE teams (id INTEGER PRIMARY KEY, label TEXT);
"""
N_ROWS = 24  # the session fills the grid to its last row on purpose
READER = 5   # the replica the "node5" database name selects


def _msg(kind: bytes, payload: bytes = b"") -> bytes:
    return kind + struct.pack("!I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def startup(database: str = "corrosion") -> bytes:
    payload = struct.pack("!I", 196608)
    for k, v in (("user", "test"), ("database", database)):
        payload += _cstr(k) + _cstr(v)
    payload += b"\x00"
    return struct.pack("!I", len(payload) + 4) + payload


SSL_REQUEST = struct.pack("!II", 8, 80877103)


def Q(sql: str) -> bytes:
    return _msg(b"Q", _cstr(sql))


def P(name: str, sql: str, oids=()) -> bytes:
    return _msg(b"P", _cstr(name) + _cstr(sql) + struct.pack(
        "!H", len(oids)) + b"".join(struct.pack("!I", o) for o in oids))


def B(portal: str, stmt: str, params=(), param_fmts=(), result_fmts=()) -> bytes:
    out = _cstr(portal) + _cstr(stmt)
    out += struct.pack("!H", len(param_fmts))
    out += b"".join(struct.pack("!H", f) for f in param_fmts)
    out += struct.pack("!H", len(params))
    for p in params:
        if p is None:
            out += struct.pack("!i", -1)
        else:
            raw = p if isinstance(p, bytes) else str(p).encode()
            out += struct.pack("!I", len(raw)) + raw
    out += struct.pack("!H", len(result_fmts))
    out += b"".join(struct.pack("!H", f) for f in result_fmts)
    return _msg(b"B", out)


def D(kind: bytes, name: str) -> bytes:
    return _msg(b"D", kind + _cstr(name))


def E(portal: str = "") -> bytes:
    return _msg(b"E", _cstr(portal) + struct.pack("!I", 0))


def C(kind: bytes, name: str) -> bytes:
    return _msg(b"C", kind + _cstr(name))


S = _msg(b"S")
X = _msg(b"X")


def extended(sql: str, params=(), param_fmts=(), result_fmts=()) -> bytes:
    return (P("", sql) + B("", "", params, param_fmts, result_fmts)
            + D(b"P", "") + E() + S)


class Wire:
    """A raw connection that returns the server's bytes verbatim."""

    def __init__(self, addr, port):
        self.sock = socket.create_connection((addr, port), timeout=60)

    def _read_exact(self, n: int) -> bytes:
        data = b""
        while len(data) < n:
            chunk = self.sock.recv(n - len(data))
            if not chunk:
                return data
            data += chunk
        return data

    def exchange(self, data: bytes, until_close: bool = False) -> bytes:
        """Send ``data``; read whole messages up to ReadyForQuery (or to
        the server closing the connection)."""
        self.sock.sendall(data)
        got = b""
        while True:
            head = self._read_exact(5)
            got += head
            if len(head) < 5:
                return got
            (length,) = struct.unpack("!I", head[1:])
            got += self._read_exact(length - 4)
            if head[:1] == b"Z" and not until_close:
                return got

    def ssl_refusal(self) -> bytes:
        self.sock.sendall(SSL_REQUEST)
        return self._read_exact(1)

    def close(self) -> bytes:
        """Terminate; -> what the server sent before closing (nothing)."""
        self.sock.sendall(X)
        rest = self._read_exact(1)
        self.sock.close()
        return rest


#: (connection, bytes) in order. The strings walk every wire path the
#: handler has; the tags name what each step covers.
SESSION = (
    # simple query
    ("a", Q("SELECT 1")),
    ("a", Q("SELECT version()")),
    ("a", Q("")),
    ("a", Q("INSERT INTO users (id, name, score, ratio) "
            "VALUES (1, 'ada', 10, 0.5)")),
    ("a", Q("INSERT INTO teams (id, label) VALUES (1, 'core')")),
    ("a", Q("SELECT id, name, score, ratio FROM users")),
    ("a", Q("SET search_path TO public")),
    # multi-statement, a literal with ';' and '::'
    ("a", Q("INSERT INTO users (id, name, score) VALUES (3, 'eve', 7); "
            "SELECT name FROM users WHERE id = 3")),
    ("a", Q("INSERT INTO users (id, name, score) VALUES (7, 'a;b::c', 1)")),
    ("a", Q("SELECT name FROM users WHERE id = 7")),
    # extended protocol: unnamed statement and portal
    ("a", extended("INSERT INTO users (id, name, score) VALUES ($1, $2, $3)",
                   [2, "bob", 5])),
    ("a", extended("SELECT name FROM users WHERE id = $1", [2])),
    ("a", extended("UPDATE users SET score = $1 WHERE id = $2", [50, 2])),
    ("a", extended("SELECT name FROM users WHERE id = $1::int", [7])),
    ("a", extended("INSERT INTO users (id, name, score) "
                   "VALUES ($1, 'costs $5', $2)", [9, 3])),
    ("a", extended("SELECT name FROM users WHERE score = $2 AND id = $1",
                   [2, 50])),
    # named statement and portal, Describe of both, Close of both
    ("a", P("s1", "SELECT id, name, score FROM users WHERE id = $1", [20])
     + D(b"S", "s1") + S),
    ("a", B("p1", "s1", [1]) + D(b"P", "p1") + E("p1") + E("p1")
     + C(b"P", "p1") + C(b"S", "s1") + S),
    ("a", B("p2", "s1", [1]) + S),
    # binary parameters (int8) and binary results (int8, float8, text)
    ("a", extended("SELECT id, name, score, ratio FROM users WHERE id = $1",
                   [struct.pack("!q", 1)], param_fmts=[1], result_fmts=[1])),
    ("a", extended("SELECT id, name FROM users WHERE id = $1", [1],
                   result_fmts=[0, 1])),
    # transactions: commit, rollback, abort
    ("a", Q("BEGIN")),
    ("a", Q("INSERT INTO users (id, name, score) VALUES (20, 'tx', 1)")),
    ("a", Q("SELECT id FROM users WHERE id = 20")),
    ("a", Q("UPDATE users SET score = 2 WHERE id = 20")),
    ("a", Q("COMMIT")),
    ("a", Q("SELECT score FROM users WHERE id = 20")),
    ("a", Q("BEGIN; INSERT INTO users (id, name, score) VALUES (21, 'gone', 0)")),
    ("a", Q("ROLLBACK")),
    ("a", Q("SELECT id FROM users WHERE id = 21")),
    ("a", Q("START TRANSACTION")),
    ("a", Q("INSERT INTO nope (id) VALUES (1)")),
    ("a", Q("INSERT INTO users (id, name, score) VALUES (22, 'x', 0)")),
    ("a", extended("SELECT 1")),
    ("a", Q("COMMIT")),
    ("a", Q("BEGIN")),
    ("a", Q("SAVEPOINT s1")),
    ("a", Q("ROLLBACK TO SAVEPOINT s1")),
    ("a", Q("COMMIT")),
    # catalog introspection (psql's shapes)
    ("a", Q("SELECT * FROM pg_catalog.pg_tables")),
    ("a", Q("SELECT relname FROM pg_catalog.pg_class "
            "WHERE relnamespace = 2200 ORDER BY relname")),
    ("a", Q("SELECT oid, relname, relkind FROM pg_class WHERE relname = 'users'")),
    ("a", Q("SELECT attname, atttypid FROM pg_catalog.pg_attribute "
            "WHERE attrelid = 16384 ORDER BY attnum")),
    ("a", Q("SELECT attname FROM pg_attribute "
            "WHERE attrelid = 'users'::regclass ORDER BY attnum")),
    ("a", Q("SELECT nspname FROM pg_namespace ORDER BY oid")),
    ("a", Q("SELECT typname FROM pg_type WHERE oid = 25")),
    ("a", Q("SELECT datname FROM pg_database")),
    ("a", Q("SELECT table_name FROM information_schema.tables "
            "WHERE table_schema = 'public'")),
    ("a", Q("SELECT column_name, data_type FROM information_schema.columns "
            "WHERE table_name = 'users' ORDER BY ordinal_position")),
    ("a", Q("INSERT INTO users (id, name, score) VALUES (77, 'pg_type', 1)")),
    ("a", Q("SELECT id FROM users WHERE name = 'pg_type'")),
    # the dialect: LIKE, subqueries, GROUP BY / HAVING, OR / NOT, joins
    ("a", Q("SELECT name, score * 10 AS s10 FROM users "
            "WHERE score = (SELECT MAX(score) FROM users) ORDER BY name")),
    ("a", Q("SELECT COUNT(*) AS n FROM users WHERE name LIKE '%a%' "
            "GROUP BY score % 2 HAVING COUNT(*) >= 1 ORDER BY n")),
    ("a", extended("SELECT name FROM users WHERE NOT (score < $1) "
                   "AND id IN (1, 2, 3) ORDER BY name", [6])),
    ("a", Q("SELECT users.name, teams.label FROM users "
            "JOIN teams ON users.id = teams.id")),
    # every error class: 42P01, 42703, 42702, 23502, 22P02, 0A000 (above
    # too), 42601, XX000 (unknown message, unknown portal or statement)
    ("a", Q("SELECT * FROM no_such_table")),
    ("a", Q("SELECT nope_col FROM users")),
    ("a", Q("SELECT id FROM users JOIN teams ON users.id = teams.id")),
    ("a", Q("INSERT INTO users (id, name, score) VALUES (NULL, 'x', 1)")),
    ("a", Q("SELECT name FROM users WHERE name = 'x")),
    ("a", Q("FROBNICATE 1")),
    ("a", _msg(b"F", b"\x00")),
    ("a", B("", "missing", []) + S),
    ("a", E("missing") + S),
    ("a", D(b"S", "missing") + D(b"P", "missing") + S),
    # node selection by database name (after replication, see below)
    ("b", None),
    ("b", Q("SELECT name, score FROM users WHERE id = 1")),
    ("b", extended("SELECT name FROM users WHERE id = $1", [2])),
    # 54000: fill the grid past its last row
    ("a", Q("; ".join(
        f"INSERT INTO teams (id, label) VALUES ({100 + i}, 't{i}')"
        for i in range(N_ROWS)))),
)


def _rig(agent_cls, db_cls, pg_cls, admission_cls, serve_cls, config, **kw):
    agent = agent_cls(config(n_rows=N_ROWS), **kw).start()
    assert agent.wait_rounds(4, timeout=180)
    db = db_cls(agent)
    db.apply_schema_sql(SCHEMA)
    pg = pg_cls(db, port=0).start()
    # a one-connection guard: the second connection is shed with 53300
    tight = admission_cls(serve_cls(max_inflight=1, max_queue=0, max_streams=1,
                                    retry_after_cap=1.0),
                          registry=agent.metrics)
    guarded = pg_cls(db, port=0, admission=tight).start()
    return agent, db, pg, guarded


@pytest.fixture(scope="module")
def rigs():
    jax_rig = _rig(JAgent, JDatabase, JPgServer, JAdmission, JServeConfig,
                   jcluster_config)
    port_rig = _rig(Agent, Database, PgServer, AdmissionController,
                    ServeConfig, cluster_config, device="cpu")
    yield {"jax": jax_rig, "port": port_rig}
    for agent, _db, pg, guarded in (jax_rig, port_rig):
        pg.stop()
        guarded.stop()
        agent.shutdown()


def _replicated(db, node: int) -> bool:
    got = [db.read_row(node, "users", pk) for pk in (1, 2)]
    return (got[0] is not None and got[0]["name"] == "ada"
            and got[0]["score"] == 10 and got[1] is not None
            and got[1]["name"] == "bob")


def _run_session(rig) -> list:
    agent, db, pg, _ = rig
    a = Wire(pg.addr, pg.port)
    out = [("ssl", a.ssl_refusal()), ("startup", a.exchange(startup()))]
    conns = {"a": a}
    for i, (name, data) in enumerate(SESSION):
        if data is None:
            deadline = time.monotonic() + 120
            while not _replicated(db, READER):
                assert time.monotonic() < deadline, "no replication to node 5"
                agent.wait_rounds(2, timeout=60)
            conns[name] = Wire(pg.addr, pg.port)
            out.append((i, conns[name].exchange(startup(f"node{READER}"))))
            continue
        out.append((i, conns[name].exchange(data)))
    for name, conn in conns.items():
        out.append((f"close {name}", conn.close()))
    return out


def _shed_session(rig) -> list:
    """The guarded listener: the first connection is admitted, the second
    shed with 53300 before the handshake (the server then closes it)."""
    guarded = rig[3]
    first = Wire(guarded.addr, guarded.port)
    second = Wire(guarded.addr, guarded.port)
    out = [first.exchange(startup()),
           second.exchange(startup(), until_close=True),
           first.exchange(Q("SELECT 1")), first.close()]
    second.sock.close()
    return out


def test_pg_session_bytes_equal_jax(rigs):
    want, got = (_run_session(rigs[k]) for k in ("jax", "port"))
    assert len(want) == len(got)
    for (step, w), (_, g) in zip(want, got):
        assert g == w, (step, SESSION[step][1] if isinstance(step, int) else step,
                         g, w)
    # the session reached the paths it is meant to: every SQLSTATE the
    # handler sends, the three transaction states, binary rows
    stream = b"".join(w for _, w in want)
    for code in ("42P01", "42703", "42702", "23502", "22P02", "0A000",
                 "54000", "42601", "XX000", "25P02"):
        assert b"C" + code.encode() + b"\x00" in stream, code
    for status in (b"I", b"T", b"E"):
        assert b"Z\x00\x00\x00\x05" + status in stream
    assert struct.pack("!q", 1) in stream and struct.pack("!d", 0.5) in stream


def test_pg_admission_shed_bytes_equal_jax(rigs):
    want, got = (_shed_session(rigs[k]) for k in ("jax", "port"))
    assert got == want
    assert b"C53300\x00" in want[1]


@pytest.mark.parametrize("msg", [
    "no such table: users", "no such column: t.nope", "unknown column 'x'",
    "ambiguous column 'id' (qualify it)", "NOT NULL violation: users.name",
    "pk users.id cannot be NULL", "unsupported literal: 'x",
    "savepoints are not supported",
    "subscriptions do not support WITH (CTEs)",
    "grid row capacity exhausted (8); raise [sim].n_rows",
    "value heap exceeded int32 id space",
    "recursive CTE 'c' exceeded 1000000 rows without a LIMIT",
    "unsupported WHERE/HAVING clause: '???'",
])
def test_sqlstate_for_equals_jax(msg):
    assert _sqlstate_for(Exception(msg)) == j_sqlstate_for(Exception(msg))
