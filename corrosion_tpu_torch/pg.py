"""PostgreSQL wire-protocol (v3) server (port of ``corrosion_tpu/pg.py``,
byte for byte the same responses).

Mirrors ``crates/corro-pg`` (``corro-pg/src/lib.rs``, ~4k LoC): optional
``api.pg`` listeners speak the PostgreSQL frontend/backend protocol —
startup (incl. SSLRequest refusal), simple query, and the extended
protocol (Parse/Bind/Describe/Execute/Sync/Close with prepared
statements + portals) — translating PG SQL onto the local store, so any
PG client can read and write the cluster. Writes ride the same statement
path as the HTTP API (the reference routes them through
``insert_local_changes``/``broadcast_changes``); reads observe one
node's replica.

Values travel in text format by default; portals bound with binary
result-format codes get PG binary encodings for the supported OIDs
(int8/float8/bytea/text — the declared column oid drives the wire
bytes). ``BEGIN``/``COMMIT``/``ROLLBACK`` are REAL buffered
transactions: statements between BEGIN and COMMIT plan
eagerly against a shared overlay (exact row counts, read-your-writes
for later statements in the block) and stage into ONE round-loop
transaction at COMMIT; an error aborts the block (SQLSTATE 25P02 until
COMMIT/ROLLBACK, COMMIT of an aborted block reports ROLLBACK), and
ReadyForQuery carries the true I/T/E status. Reads inside an open block
observe the pre-transaction replica (the eventually-consistent read
model). ``pg_catalog`` / ``information_schema`` introspection is
answered from the live schema for the common shapes
(``pg_class``/``pg_attribute``/``pg_type``/``pg_namespace``/
``pg_database``, ``information_schema.{tables,columns}`` — the
reference fakes these with vtabs, ``src/vtab/pg_*.rs``); unrecognized
catalog queries degrade to empty result sets.
"""

from __future__ import annotations

import re
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from corrosion_tpu_torch.db.database import SqlError
from corrosion_tpu_torch.db.schema import SchemaError
from corrosion_tpu_torch.utils.lifecycle import DrainingConnMixin
from corrosion_tpu_torch.utils.tracing import logger

PROTO_V3 = 196608
SSL_REQUEST = 80877103
CANCEL_REQUEST = 80877102

# minimal OID map (values always travel in text format)
OID_INT2 = 21
OID_INT4 = 23
OID_INT8 = 20
OID_INTS = (OID_INT2, OID_INT4, OID_INT8)
OID_FLOAT8 = 701
OID_TEXT = 25
OID_BYTEA = 17

# SQLSTATE codes (corro-pg ships a full table, sql_state.rs; this maps
# the error classes this engine actually raises)
SQLSTATE_SYNTAX = "42601"
SQLSTATE_UNDEFINED_TABLE = "42P01"
SQLSTATE_UNDEFINED_COLUMN = "42703"
SQLSTATE_AMBIGUOUS_COLUMN = "42702"
SQLSTATE_NOT_NULL = "23502"
SQLSTATE_INVALID_TEXT = "22P02"
SQLSTATE_FEATURE_UNSUPPORTED = "0A000"
SQLSTATE_PROGRAM_LIMIT = "54000"
SQLSTATE_INTERNAL = "XX000"
SQLSTATE_IN_FAILED_TX = "25P02"
SQLSTATE_TOO_MANY_CONNECTIONS = "53300"  # corroguard admission shed


def _sqlstate_for(exc: Exception) -> str:
    """Map an engine error to the PG SQLSTATE a real server would send
    (``corro-pg/src/sql_state.rs`` ships the full table; this covers
    the classes this engine raises)."""
    msg = str(exc).lower()
    if "no such table" in msg:
        return SQLSTATE_UNDEFINED_TABLE
    if "no such column" in msg or "unknown column" in msg:
        return SQLSTATE_UNDEFINED_COLUMN
    if "ambiguous column" in msg:
        return SQLSTATE_AMBIGUOUS_COLUMN
    if "not null violation" in msg or "cannot be null" in msg:
        return SQLSTATE_NOT_NULL
    if "unsupported literal" in msg:
        return SQLSTATE_INVALID_TEXT
    if "not supported" in msg or "do not support" in msg:
        return SQLSTATE_FEATURE_UNSUPPORTED
    if ("capacity exhausted" in msg or "exceeded int32 id space" in msg
            or ("recursive cte" in msg and "exceeded" in msg)):
        return SQLSTATE_PROGRAM_LIMIT
    return SQLSTATE_SYNTAX


def _col_oid(sql_type: str) -> int:
    return {
        "INTEGER": OID_INT8,
        "REAL": OID_FLOAT8,
        "BLOB": OID_BYTEA,
    }.get(sql_type, OID_TEXT)


# --- pg_catalog virtual tables (vtab analogs, src/vtab/pg_*.rs) ---------
# stable synthetic OIDs: namespaces ship PG's well-known values; relation
# oids are 16384 + table index in schema declaration order
_NS_CATALOG, _NS_PUBLIC = 11, 2200
_FIRST_REL_OID = 16384
_PG_TYPES = [
    # (oid, typname, typlen)
    (16, "bool", 1), (17, "bytea", -1), (20, "int8", 8), (21, "int2", 2),
    (23, "int4", 4), (25, "text", -1), (701, "float8", 8),
    (1043, "varchar", -1),
]


def _catalog_rows(db, table: str) -> List[Dict[str, Any]]:
    """Rows of one catalog vtab, generated from the live schema."""
    tables = list(db.schema.tables.values())
    rel_oid = {t.name: _FIRST_REL_OID + i for i, t in enumerate(tables)}
    if table == "pg_namespace":
        return [
            {"oid": _NS_CATALOG, "nspname": "pg_catalog"},
            {"oid": _NS_PUBLIC, "nspname": "public"},
        ]
    if table == "pg_database":
        return [{"oid": 1, "datname": "corrosion"}]
    if table == "pg_type":
        return [
            {"oid": o, "typname": n, "typlen": ln,
             "typnamespace": _NS_CATALOG, "typtype": "b"}
            for o, n, ln in _PG_TYPES
        ]
    if table == "pg_class":
        return [
            {"oid": rel_oid[t.name], "relname": t.name,
             "relnamespace": _NS_PUBLIC, "relkind": "r",
             "relowner": 10, "reltuples": -1}
            for t in tables
        ]
    if table == "pg_attribute":
        rows = []
        for t in tables:
            for i, c in enumerate(t.columns):
                rows.append({
                    "attrelid": rel_oid[t.name], "attname": c.name,
                    "atttypid": _col_oid(c.sql_type), "attnum": i + 1,
                    "attnotnull": c.not_null or c.primary_key,
                    "attisdropped": False,
                })
        return rows
    if table == "pg_range":
        return []
    if table == "tables":  # information_schema.tables
        return [
            {"table_catalog": "corrosion", "table_schema": "public",
             "table_name": t.name, "table_type": "BASE TABLE"}
            for t in tables
        ]
    if table == "columns":  # information_schema.columns
        rows = []
        for t in tables:
            for i, c in enumerate(t.columns):
                rows.append({
                    "table_schema": "public", "table_name": t.name,
                    "column_name": c.name, "ordinal_position": i + 1,
                    "data_type": c.sql_type.lower(),
                    "is_nullable": "NO" if (c.not_null or c.primary_key)
                    else "YES",
                })
        return rows
    return []


_CATALOG_TABLES = (
    "pg_class", "pg_attribute", "pg_type", "pg_namespace", "pg_database",
    "pg_range", "tables", "columns",
)
# a query is a catalog query only when its FROM target is a catalog
# table — a user query merely *mentioning* pg_class in a literal must
# still run against the real store
_CATALOG_FROM_RE = re.compile(
    r"\bFROM\s+(?:PG_CATALOG\.\w+|INFORMATION_SCHEMA\.\w+|"
    r"PG_(?:CLASS|ATTRIBUTE|TYPE|NAMESPACE|DATABASE|RANGE|TABLES)\b)",
    re.IGNORECASE,
)
_CATALOG_RE = re.compile(
    r"^SELECT\s+(?P<cols>.*?)\s+FROM\s+"
    r"(?:pg_catalog\.|information_schema\.)?(?P<table>\w+)"
    r"(?:\s+(?:AS\s+)?(?P<alias>(?!WHERE|ORDER|LIMIT)\w+))?"
    r"(?:\s+WHERE\s+(?P<where>.*?))?"
    r"(?:\s+ORDER\s+BY\s+(?P<order>.*?))?"
    r"(?:\s+LIMIT\s+(?P<limit>\d+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)


def _catalog_literal(tok: str, db, params, pos: List[int]) -> Any:
    """A catalog WHERE literal: int, 'str', ``$N``/``?`` param (``pos``
    is the running positional-``?`` counter), or ``'name'::regclass``
    (resolved to the relation oid)."""
    tok = tok.strip()
    m = re.match(r"^'([^']*)'\s*::\s*regclass$", tok,
                               re.IGNORECASE)
    if m:
        name = m.group(1).split(".")[-1]
        for row in _catalog_rows(db, "pg_class"):
            if row["relname"] == name:
                return row["oid"]
        return -1
    plist = list(params or [])
    nm = re.match(r"^\$(\d+)$", tok)
    if nm:
        i = int(nm.group(1)) - 1
        return plist[i] if 0 <= i < len(plist) else None
    if tok == "?":
        i = pos[0]
        pos[0] += 1
        return plist[i] if i < len(plist) else None
    if tok.startswith("'") and tok.endswith("'"):
        return tok[1:-1].replace("''", "'")
    try:
        return int(tok)
    except ValueError:
        return tok


def _answer_catalog(db, sql: str, params) -> Optional[Tuple[List[str], List[List[Any]]]]:
    """Try to answer a catalog introspection query from the live schema.
    Returns (cols, rows) or None when the shape is unrecognized (caller
    degrades to an empty result set)."""
    m = _CATALOG_RE.match(sql.strip())
    if m is None or m.group("table").lower() not in _CATALOG_TABLES:
        return None
    table = m.group("table").lower()
    alias = (m.group("alias") or table).lower()
    rows = _catalog_rows(db, table)
    known = set(rows[0]) if rows else set()

    def strip_alias(ident):
        ident = ident.strip().strip('"')
        if "." in ident:
            q, _, c = ident.partition(".")
            if q.lower() not in (alias, table):
                return None
            ident = c.strip('"')
        return ident.lower()

    # WHERE: conjunction of col = literal / col IN (lit, ...)
    if m.group("where"):
        pos = [0]  # running positional-? parameter counter
        for clause in re.split(r"\s+AND\s+", m.group("where"),
                                flags=re.IGNORECASE):
            cm = re.match(r"^([\w\".]+)\s*=\s*(.+)$", clause.strip(),
                           re.DOTALL)
            im = re.match(r"^([\w\".]+)\s+IN\s*\((.+)\)$", clause.strip(),
                           re.IGNORECASE | re.DOTALL)
            if im:
                col = strip_alias(im.group(1))
                if col is None or (rows and col not in known):
                    return None
                vals = {_catalog_literal(t, db, params, pos)
                        for t in im.group(2).split(",")}
                rows = [r for r in rows if r.get(col) in vals]
            elif cm:
                col = strip_alias(cm.group(1))
                if col is None or (rows and col not in known):
                    return None
                val = _catalog_literal(cm.group(2), db, params, pos)
                rows = [r for r in rows
                        if r.get(col) == val or str(r.get(col)) == str(val)]
            else:
                return None

    # projection
    raw = m.group("cols").strip()
    if raw == "*":
        names = sorted(known) if rows else []
    else:
        names = []
        for part in raw.split(","):
            am = re.match(r"^(.*?)\s+AS\s+[\"']?([\w ]+)[\"']?\s*$",
                           part.strip(), re.IGNORECASE | re.DOTALL)
            ident = am.group(1) if am else part
            col = strip_alias(ident)
            if col is None or col == "count(*)":
                return None
            names.append(col)
        for n in names:
            if rows and n not in known:
                return None

    # ORDER BY col [DESC] (output columns only)
    if m.group("order"):
        for part in reversed(m.group("order").split(",")):
            toks = part.split()
            desc = len(toks) > 1 and toks[-1].upper() == "DESC"
            col = strip_alias(toks[0])
            if col is None or (rows and col not in known):
                return None
            # ints compare numerically, strings lexically (type-tagged so
            # attnum 10 sorts after 2, not between 1 and 2)
            rows = sorted(
                rows,
                key=lambda r: (r.get(col) is not None,
                               isinstance(r.get(col), str), r.get(col)),
                reverse=desc,
            )
    if m.group("limit"):
        rows = rows[: int(m.group("limit"))]
    return names, [[r.get(n) for n in names] for r in rows]


def _text_value(v: Any) -> Optional[bytes]:
    if v is None:
        return None
    if isinstance(v, bool):
        return b"t" if v else b"f"
    if isinstance(v, bytes):
        return b"\\x" + v.hex().encode()
    return str(v).encode()


def _binary_value(v: Any, oid: int) -> Optional[bytes]:
    """PG binary result encoding for the supported OIDs
    (``corro-pg`` answers binary-format portals the same way). The
    declared column oid drives the coercion so the wire bytes always
    match the RowDescription the client planned against."""
    if v is None:
        return None
    if oid == OID_FLOAT8:
        try:
            return struct.pack("!d", float(v))
        except (TypeError, ValueError):
            # flexible typing: a non-numeric value in a REAL column —
            # fall back to its utf8 text (length-prefixed, so a strict
            # client sees len != 8 rather than garbage)
            return str(v).encode()
    if oid in OID_INTS:
        try:
            return struct.pack("!q", int(v))
        except (TypeError, ValueError):
            return str(v).encode()
    if oid == OID_BYTEA:
        return v if isinstance(v, bytes) else str(v).encode()
    if isinstance(v, bool):  # bool as text-ish byte for OID_TEXT
        return b"\x01" if v else b"\x00"
    # text binary format is the utf8 bytes themselves
    if isinstance(v, bytes):
        return v
    return str(v).encode()


def _fmt_for(i: int, fmts: Optional[List[int]]) -> int:
    """Bind result-format codes: [] = all text, [f] = all f, else per
    column (PG protocol)."""
    if not fmts:
        return 0
    if len(fmts) == 1:
        return fmts[0]
    return fmts[i] if i < len(fmts) else 0


def _iter_sql_segments(sql: str):
    """Yield ``(is_literal, segment)`` pairs, where literal segments are
    single-quoted strings (``''`` escapes stay inside one literal). The
    single quote-scanner every literal-aware transform builds on."""
    i, n = 0, len(sql)
    while i < n:
        if sql[i] == "'":
            j = i + 1
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        j += 2
                        continue
                    break
                j += 1
            yield True, sql[i:min(j + 1, n)]
            i = j + 1
        else:
            j = sql.find("'", i)
            if j == -1:
                j = n
            yield False, sql[i:j]
            i = j


def _split_sql_outside_quotes(sql: str, sep: str) -> List[str]:
    """Split on ``sep`` only outside single-quoted literals."""
    parts, cur = [], []
    for is_lit, seg in _iter_sql_segments(sql):
        if is_lit:
            cur.append(seg)
            continue
        while True:
            k = seg.find(sep)
            if k == -1:
                cur.append(seg)
                break
            cur.append(seg[:k])
            parts.append("".join(cur))
            cur = []
            seg = seg[k + 1:]
    parts.append("".join(cur))
    return parts


def _translate_sql(sql: str) -> str:
    """Light PG -> local dialect cleanup: strip ``::type`` casts outside
    string literals (the reference runs a full sqlparser -> SQLite
    translation)."""
    import re

    return "".join(
        seg if is_lit else re.sub(r"::\w+", "", seg)
        for is_lit, seg in _iter_sql_segments(sql)
    ).strip()


def _sql_kind(sql: str) -> str:
    """Bounded-cardinality statement class for the per-kind query
    latency histogram: ``select`` / ``write`` / ``tx`` /
    ``catalog`` / ``meta`` / ``empty``. Classification mirrors the
    ``_run_sql`` dispatch order so every wire statement lands in exactly
    the class whose code path served it."""
    s = _translate_sql(sql)
    upper = s.upper().rstrip(";").strip()
    if not upper:
        return "empty"
    verb = upper.split()[0]
    if (verb in ("BEGIN", "COMMIT", "END", "ROLLBACK", "SAVEPOINT",
                 "RELEASE")
            or upper.startswith("START TRANSACTION")):
        return "tx"
    if verb in ("SET", "RESET", "DISCARD", "SHOW"):
        return "meta"
    if _CATALOG_FROM_RE.search(upper):
        return "catalog"
    if verb == "SELECT":
        return "select"
    return "write"


def _substitute_placeholders(sql: str) -> "Tuple[str, List[int]]":
    """Rewrite ``$N`` -> ``?`` *outside single-quoted literals* (a dollar
    sign inside a string like ``'costs $5'`` is data, not a parameter).
    Returns ``(text, param_map)`` where occurrence i of ``?`` consumes
    client-param index ``param_map[i]``."""
    import re

    param_map: List[int] = []

    def repl(m):
        param_map.append(int(m.group(1)) - 1)
        return "?"

    text = "".join(
        seg if is_lit else re.sub(r"\$(\d+)", repl, seg)
        for is_lit, seg in _iter_sql_segments(sql)
    )
    return text, param_map


class _Msg:
    """Backend message writer."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = bytearray()

    def add(self, kind: bytes, payload: bytes = b"") -> "_Msg":
        self._buf += kind + struct.pack("!I", len(payload) + 4) + payload
        return self

    def flush(self) -> None:
        if self._buf:
            self.sock.sendall(bytes(self._buf))
            self._buf.clear()


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


class _PreparedStatement:
    def __init__(self, sql: str, param_oids: List[int],
                 param_map: Optional[List[int]] = None):
        self.sql = sql
        self.param_oids = param_oids
        # textual order of $N placeholders: occurrence i consumes
        # client-param index param_map[i] (handles $2 ... $1 and reuse)
        self.param_map = param_map or []

    def reorder(self, params: List[Any]) -> List[Any]:
        if not self.param_map:
            return params
        return [params[i] if i < len(params) else None
                for i in self.param_map]


class _Portal:
    def __init__(self, stmt: _PreparedStatement, params: List[Any],
                 result_fmts: Optional[List[int]] = None):
        self.stmt = stmt
        self.params = params
        # Bind's result-format codes: [] all-text, [1] all-binary, or
        # per-column
        self.result_fmts = result_fmts or []
        # True once Describe(portal) emitted a RowDescription; Execute
        # then must NOT send a second one (protocol), but when Describe
        # answered NoData (synthetic results: SHOW, constant SELECT,
        # pg_catalog) Execute still owes the client a description
        self.described = False


class PgServer:
    """PG v3 listener bound to one Database."""

    def __init__(self, db, addr: str = "127.0.0.1", port: int = 0,
                 default_node: int = 0, admission=None):
        from corrosion_tpu_torch.api.admission import AdmissionController

        self.db = db
        self.default_node = default_node
        # corroguard (docs/overload.md): pass the ApiServer's controller
        # to shed PG connections against the same per-class budgets as
        # the HTTP plane; the default standalone controller is disabled
        # (ServeConfig.max_inflight == 0)
        self.admission = admission or AdmissionController(
            None, registry=db.agent.metrics)
        handler = _make_handler(self)

        class _DrainingTCPServer(DrainingConnMixin,
                                 socketserver.ThreadingTCPServer):
            _conn_name = "corro-pg-conn"

        self.server = _DrainingTCPServer(
            (addr, port), handler, bind_and_activate=False
        )
        self.server.allow_reuse_address = True
        self.server.server_bind()
        self.server.server_activate()
        self.addr, self.port = self.server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PgServer":
        from corrosion_tpu_torch.utils.lifecycle import spawn_counted

        self._thread = spawn_counted(
            self.server.serve_forever, name="corro-pg-wire"
        )
        return self

    def stop(self) -> None:
        self.server.shutdown()
        # grace=0: a PG handler parked in recv only exits when its
        # socket dies — a well-behaved client already sent Terminate
        self.server.drain_connections(grace=0.0)
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def _make_handler(server: PgServer):
    class Handler(socketserver.BaseRequestHandler):
        def setup(self):
            self.sock: socket.socket = self.request
            self.out = _Msg(self.sock)
            self.stmts: Dict[str, _PreparedStatement] = {}
            self.portals: Dict[str, _Portal] = {}
            self.node = server.default_node
            self.tx = None  # open StagedTx between BEGIN and COMMIT
            self.tx_failed = False  # aborted: reject until COMMIT/ROLLBACK

        # --- low-level reads ---------------------------------------------
        def _read_exact(self, n: int) -> bytes:
            data = b""
            while len(data) < n:
                chunk = self.sock.recv(n - len(data))
                if not chunk:
                    raise ConnectionResetError
                data += chunk
            return data

        def _read_startup(self) -> Optional[dict]:
            (length,) = struct.unpack("!I", self._read_exact(4))
            payload = self._read_exact(length - 4)
            (code,) = struct.unpack("!I", payload[:4])
            if code == SSL_REQUEST:
                self.sock.sendall(b"N")  # no TLS on the simulator listener
                return self._read_startup()
            if code == CANCEL_REQUEST:
                return None
            if code != PROTO_V3:
                raise ValueError(f"unsupported protocol {code}")
            params = {}
            parts = payload[4:].split(b"\x00")
            for k, v in zip(parts[::2], parts[1::2]):
                if k:
                    params[k.decode()] = v.decode()
            return params

        def _read_message(self) -> Tuple[bytes, bytes]:
            kind = self._read_exact(1)
            (length,) = struct.unpack("!I", self._read_exact(4))
            return kind, self._read_exact(length - 4)

        # --- backend responses -------------------------------------------
        def _send_ready(self):
            # ReadyForQuery carries the real transaction status: I idle,
            # T in transaction, E failed transaction (pg protocol)
            status = (b"E" if self.tx_failed
                      else b"T" if self.tx is not None else b"I")
            self.out.add(b"Z", status).flush()

        def _send_error(self, message: str, code: str = SQLSTATE_INTERNAL):
            fields = (b"S" + _cstr("ERROR") + b"C" + _cstr(code)
                      + b"M" + _cstr(message) + b"\x00")
            self.out.add(b"E", fields)

        def _col_oids(self, cols: List[str],
                      table_name: Optional[str] = None) -> List[int]:
            """Deterministic per-column OIDs (schema-driven, else TEXT) —
            shared by RowDescription and the binary row encoder so the
            wire bytes always match the declared description."""
            table = None
            if table_name is not None:
                try:
                    table = server.db.schema.table(table_name)
                except SchemaError:
                    table = None
            oids = []
            for name in cols:
                oid = OID_TEXT
                if table is not None:
                    try:
                        oid = _col_oid(table.column(name).sql_type)
                    except SchemaError:
                        pass
                oids.append(oid)
            return oids

        def _row_description(self, cols: List[str],
                             table_name: Optional[str] = None,
                             fmts: Optional[List[int]] = None):
            payload = struct.pack("!H", len(cols))
            oids = self._col_oids(cols, table_name)
            for i, name in enumerate(cols):
                payload += _cstr(name)
                payload += struct.pack("!IhIhih", 0, 0, oids[i], -1, -1,
                                       _fmt_for(i, fmts))
            self.out.add(b"T", payload)

        def _data_row(self, row: List[Any],
                      fmts: Optional[List[int]] = None,
                      oids: Optional[List[int]] = None):
            payload = struct.pack("!H", len(row))
            for i, v in enumerate(row):
                if _fmt_for(i, fmts) == 1:
                    tv = _binary_value(
                        v, oids[i] if oids and i < len(oids) else OID_TEXT
                    )
                else:
                    tv = _text_value(v)
                if tv is None:
                    payload += struct.pack("!i", -1)
                else:
                    payload += struct.pack("!I", len(tv)) + tv
            self.out.add(b"D", payload)

        def _command_complete(self, tag: str):
            self.out.add(b"C", _cstr(tag))

        # --- statement execution -----------------------------------------
        def _table_of(self, sql: str) -> Optional[str]:
            import re

            m = re.search(r"\b(?:FROM|INTO|UPDATE)\s+([\w\"]+)", sql,
                          re.IGNORECASE)
            return m.group(1).strip('"') if m else None

        def _run_sql(self, sql: str, params: Any = None,
                     send_desc: bool = True,
                     fmts: Optional[List[int]] = None) -> None:
            """Timed envelope around :meth:`_dispatch_sql` — both wire
            entry points (simple query and extended Execute) land here,
            so the per-kind latency histogram counts every issued
            statement exactly once, errors included."""
            t0 = time.perf_counter()
            try:
                self._dispatch_sql(sql, params, send_desc, fmts)
            finally:
                server.db.agent.metrics.histogram(
                    "corro.pg.query.seconds",
                    time.perf_counter() - t0, {"kind": _sql_kind(sql)})

        def _dispatch_sql(self, sql: str, params: Any = None,
                          send_desc: bool = True,
                          fmts: Optional[List[int]] = None) -> None:
            """``send_desc``: simple query includes RowDescription;
            extended Execute must NOT (the client learned the shape from
            Describe — a second 'T' is a protocol violation). ``fmts``:
            the portal's Bind result-format codes (binary results)."""
            orig_sql = sql  # pre-translation (keeps ::regclass casts)
            sql = _translate_sql(sql)
            if not sql or sql.rstrip(";") == "":
                self.out.add(b"I", b"")  # EmptyQueryResponse
                return
            upper = sql.upper().rstrip(";")
            verb = upper.split()[0] if upper.split() else ""
            # transaction control (real BEGIN/COMMIT: the
            # reference's PG server runs genuine txs, corro-pg/src/lib.rs)
            if verb == "BEGIN" or upper.startswith("START TRANSACTION"):
                if self.tx is None:
                    self.tx = server.db.begin(self.node)
                self._command_complete("BEGIN")
                return
            if verb in ("COMMIT", "END"):
                tx, failed = self.tx, self.tx_failed
                self.tx, self.tx_failed = None, False
                if failed or tx is None:
                    if tx is not None:
                        tx.rollback()
                    # committing an aborted tx rolls back (pg semantics)
                    self._command_complete(
                        "ROLLBACK" if failed else "COMMIT")
                    return
                tx.commit()
                self._command_complete("COMMIT")
                return
            if verb in ("SAVEPOINT", "RELEASE") or (
                verb == "ROLLBACK"
                and re.match(r"ROLLBACK\s+TO\b", upper)
            ):
                # savepoints are not supported; erroring (0A000) keeps
                # the block's state honest — a silent full ROLLBACK for
                # 'ROLLBACK TO SAVEPOINT' would drop buffered statements
                # while the client believes the tx is still open
                self._send_error("savepoints are not supported",
                                 SQLSTATE_FEATURE_UNSUPPORTED)
                if self.tx is not None:
                    self.tx_failed = True
                return
            if verb == "ROLLBACK":
                if self.tx is not None:
                    self.tx.rollback()
                self.tx, self.tx_failed = None, False
                self._command_complete("ROLLBACK")
                return
            if self.tx_failed:
                self._send_error(
                    "current transaction is aborted, commands ignored "
                    "until end of transaction block", SQLSTATE_IN_FAILED_TX)
                return
            if upper.startswith(("SET ", "RESET ", "DISCARD ")):
                self._command_complete("SET")
                return
            if upper.startswith("SHOW "):
                name = sql.split(None, 1)[1].rstrip(";")
                if send_desc:
                    self._row_description([name.lower()], fmts=fmts)
                self._data_row([""], fmts)
                self._command_complete("SHOW")
                return
            if _CATALOG_FROM_RE.search(upper):
                # introspection served from the live schema (vtab analog);
                # unrecognized shapes degrade to an empty result set
                answer = _answer_catalog(server.db, orig_sql, params)
                if answer is None:
                    if send_desc:
                        self._row_description(["?column?"], fmts=fmts)
                    self._command_complete("SELECT 0")
                    return
                cols, rows = answer
                if send_desc:
                    self._row_description(cols, fmts=fmts)
                for row in rows:
                    self._data_row(row, fmts)
                self._command_complete(f"SELECT {len(rows)}")
                return
            if upper.startswith("SELECT"):
                self._run_select(sql, params, send_desc, fmts)
                return
            n = self._run_write(sql, params)
            tag = f"INSERT 0 {n}" if verb == "INSERT" else f"{verb} {n}"
            self._command_complete(tag)

        def _run_select(self, sql: str, params: Any,
                        send_desc: bool = True,
                        fmts: Optional[List[int]] = None) -> None:
            import re

            # constant selects like SELECT 1 / SELECT version()
            m = re.match(r"SELECT\s+([^\s,]+)\s*;?$", sql, re.IGNORECASE)
            if m and "FROM" not in sql.upper():
                expr = m.group(1).rstrip(";")
                if expr.lower() in ("version()", "current_schema()"):
                    val = ("corrosion-tpu (PostgreSQL 14.0 compatible)"
                           if "version" in expr.lower() else "public")
                else:
                    try:
                        val = int(expr)
                    except ValueError:
                        val = expr.strip("'")
                if send_desc:
                    self._row_description(["?column?"], fmts=fmts)
                self._data_row([val], fmts)
                self._command_complete("SELECT 1")
                return
            cols, rows = server.db.query(self.node, sql, params)
            table = self._table_of(sql)
            if send_desc:
                self._row_description(cols, table, fmts)
            oids = self._col_oids(cols, table) if fmts else None
            n = 0
            for row in rows:
                self._data_row(row, fmts, oids)
                n += 1
            self._command_complete(f"SELECT {n}")

        def _run_write(self, sql: str, params: Any) -> int:
            if self.tx is not None:
                # buffered inside the open BEGIN block; visible to the
                # cluster only at COMMIT
                return self.tx.execute(sql, params)["rows_affected"]
            results = server.db.execute(self.node, [(sql, params)])
            return results[0]["rows_affected"]

        # --- protocol phases ---------------------------------------------
        def handle(self):
            admitted = False
            try:
                params = self._read_startup()
                if params is None:
                    return
                if "node" in params.get("database", ""):
                    # database name "node<K>" selects the observer replica
                    try:
                        self.node = int(
                            params["database"].replace("node", ""))
                    except ValueError:
                        pass
                # corroguard admission on the accept path (docs/
                # overload.md): a connection slot is a "pg"-class ticket
                # held for the whole wire session; a shed connection gets
                # the canonical 53300 before the auth handshake
                if not server.admission.admit("pg"):
                    ra = server.admission.retry_after("pg")
                    self._send_error(
                        f"server overloaded; retry after {ra}s",
                        SQLSTATE_TOO_MANY_CONNECTIONS)
                    self.out.flush()
                    return
                admitted = True
                self.out.add(b"R", struct.pack("!I", 0))  # AuthenticationOk
                for k, v in (("server_version", "14.0"),
                             ("server_encoding", "UTF8"),
                             ("client_encoding", "UTF8"),
                             ("DateStyle", "ISO, MDY")):
                    self.out.add(b"S", _cstr(k) + _cstr(v))
                self.out.add(b"K", struct.pack("!II", 0, 0))
                self._send_ready()
                self._loop()
            except (ConnectionResetError, BrokenPipeError):
                pass
            except Exception:  # noqa: BLE001
                logger.exception("pg connection failed")
            finally:
                if admitted:
                    server.admission.release("pg")

        def _loop(self):
            while True:
                kind, payload = self._read_message()
                if kind == b"X":  # Terminate
                    return
                if kind == b"Q":
                    self._on_simple_query(payload)
                elif kind == b"P":
                    self._on_parse(payload)
                elif kind == b"B":
                    self._on_bind(payload)
                elif kind == b"D":
                    self._on_describe(payload)
                elif kind == b"E":
                    self._on_execute(payload)
                elif kind == b"C":
                    self._on_close(payload)
                elif kind == b"S":  # Sync
                    self._send_ready()
                elif kind == b"H":  # Flush
                    self.out.flush()
                else:
                    self._send_error(f"unsupported message {kind!r}")
                    self._send_ready()

        def _on_simple_query(self, payload: bytes):
            sql = payload.rstrip(b"\x00").decode()
            try:
                parts = [s for s in _split_sql_outside_quotes(sql, ";")
                         if s.strip()]
                for part in parts or [""]:
                    self._run_sql(part)
            except (SqlError, SchemaError) as e:
                if self.tx is not None:
                    self.tx_failed = True  # abort the open BEGIN block
                self._send_error(str(e), _sqlstate_for(e))
            except Exception as e:  # noqa: BLE001
                if self.tx is not None:
                    self.tx_failed = True
                logger.exception("pg simple query failed")
                self._send_error(str(e))
            self._send_ready()

        def _on_parse(self, payload: bytes):
            name, rest = payload.split(b"\x00", 1)
            sql, rest = rest.split(b"\x00", 1)
            (n_oids,) = struct.unpack("!H", rest[:2])
            oids = list(struct.unpack(f"!{n_oids}I", rest[2:2 + 4 * n_oids]))
            # $N placeholders -> positional ?, keeping the N order so
            # $2 ... $1 and repeated placeholders bind correctly; quoted
            # literals are skipped so 'costs $5' stays data
            text, param_map = _substitute_placeholders(sql.decode())
            self.stmts[name.decode()] = _PreparedStatement(
                text, oids, param_map)
            self.out.add(b"1", b"")  # ParseComplete

        def _on_bind(self, payload: bytes):
            portal, rest = payload.split(b"\x00", 1)
            stmt_name, rest = rest.split(b"\x00", 1)
            off = 0
            (n_fmt,) = struct.unpack("!H", rest[off:off + 2])
            off += 2
            fmts = list(struct.unpack(f"!{n_fmt}H", rest[off:off + 2 * n_fmt]))
            off += 2 * n_fmt
            (n_params,) = struct.unpack("!H", rest[off:off + 2])
            off += 2
            params: List[Any] = []
            stmt = self.stmts.get(stmt_name.decode())
            for i in range(n_params):
                (plen,) = struct.unpack("!i", rest[off:off + 4])
                off += 4
                if plen == -1:
                    params.append(None)
                    continue
                raw = rest[off:off + plen]
                off += plen
                fmt = fmts[i] if i < len(fmts) else (fmts[0] if fmts else 0)
                params.append(self._decode_param(raw, fmt, stmt, i))
            if stmt is None:
                self._send_error(f"no such prepared statement "
                                 f"{stmt_name.decode()!r}", SQLSTATE_SYNTAX)
                return
            # result-format codes (binary results, corro-pg parity)
            result_fmts: List[int] = []
            if off + 2 <= len(rest):
                (n_rfmt,) = struct.unpack("!H", rest[off:off + 2])
                off += 2
                if off + 2 * n_rfmt <= len(rest):
                    result_fmts = list(
                        struct.unpack(f"!{n_rfmt}H",
                                      rest[off:off + 2 * n_rfmt])
                    )
            self.portals[portal.decode()] = _Portal(
                stmt, stmt.reorder(params), result_fmts)
            self.out.add(b"2", b"")  # BindComplete

        def _decode_param(self, raw: bytes, fmt: int,
                          stmt: Optional[_PreparedStatement], i: int) -> Any:
            oid = (stmt.param_oids[i]
                   if stmt and i < len(stmt.param_oids) else 0)
            if fmt == 1:  # binary
                if oid == OID_FLOAT8:
                    return struct.unpack("!d", raw)[0]
                if oid in OID_INTS or (oid == 0 and len(raw) in (2, 4, 8)):
                    return int.from_bytes(raw, "big", signed=True)
                return raw
            text = raw.decode()
            if oid in OID_INTS:
                return int(text)
            if oid == OID_FLOAT8:
                return float(text)
            if oid in (0, OID_TEXT):
                # untyped text: try numeric, else string (SQLite affinity)
                try:
                    return int(text)
                except ValueError:
                    try:
                        return float(text)
                    except ValueError:
                        return text
            return text

        def _on_describe(self, payload: bytes):
            kind, name = payload[:1], payload[1:].rstrip(b"\x00").decode()
            if kind == b"S":
                stmt = self.stmts.get(name)
                if stmt is None:
                    self._send_error(f"no such statement {name!r}")
                    return
                self.out.add(b"t", struct.pack("!H", len(stmt.param_oids))
                             + b"".join(struct.pack("!I", o or OID_TEXT)
                                        for o in stmt.param_oids))
                sql = stmt.sql
            else:
                portal = self.portals.get(name)
                if portal is None:
                    self._send_error(f"no such portal {name!r}")
                    return
                sql = portal.stmt.sql
            described = False
            pfmts = (self.portals[name].result_fmts
                     if kind == b"P" and name in self.portals else None)
            if sql.upper().lstrip().startswith("SELECT"):
                try:
                    # schema-only plan: no table scan on the Describe phase
                    cols = server.db.query_columns(_translate_sql(sql))
                    self._row_description(cols, self._table_of(sql), pfmts)
                    described = True
                except Exception:  # noqa: BLE001 — constant SELECTs etc.
                    self.out.add(b"n", b"")  # NoData
            else:
                self.out.add(b"n", b"")
            if kind == b"P":
                portal.described = described

        def _on_execute(self, payload: bytes):
            name = payload.split(b"\x00", 1)[0].decode()
            portal = self.portals.get(name)
            if portal is None:
                self._send_error(f"no such portal {name!r}")
                return
            try:
                # Describe already told the client the row shape iff it
                # produced a RowDescription; synthetic results (NoData
                # from Describe) still need theirs here
                self._run_sql(portal.stmt.sql, portal.params or None,
                              send_desc=not portal.described,
                              fmts=portal.result_fmts)
            except (SqlError, SchemaError) as e:
                if self.tx is not None:
                    self.tx_failed = True  # abort the open BEGIN block
                self._send_error(str(e), _sqlstate_for(e))
            except Exception as e:  # noqa: BLE001
                if self.tx is not None:
                    self.tx_failed = True
                logger.exception("pg execute failed")
                self._send_error(str(e))

        def _on_close(self, payload: bytes):
            kind, name = payload[:1], payload[1:].rstrip(b"\x00").decode()
            if kind == b"S":
                self.stmts.pop(name, None)
            else:
                self.portals.pop(name, None)
            self.out.add(b"3", b"")  # CloseComplete

    return Handler
