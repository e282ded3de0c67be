"""Database: SQL statement execution over the TPU-resident LWW store.

The write path mirrors ``execute_statement`` /
``make_broadcastable_changes`` (``crates/corro-agent/src/api/public/
mod.rs:53-174``): statements in one transaction are translated into cell
writes on the writer node's replica and staged into the round loop
together, after which dissemination is asynchronous. The read path
mirrors ``/v1/queries``: reads observe one node's local replica only.

Supported dialect (the write/read surface the reference's API exercises):
``INSERT [OR IGNORE] INTO t (cols) VALUES (...)`` (upsert semantics, as
cr-sqlite rewrites inserts), ``UPDATE t SET c=? WHERE pk=?``,
``DELETE FROM t WHERE pk=?`` (causal-length tombstone), and
``SELECT`` with projection aliases, aggregates (COUNT/SUM/MIN/MAX/AVG/
TOTAL), ``[LEFT] JOIN ... ON a.x = b.y`` equi-joins, boolean ``WHERE``/
``HAVING`` (AND/OR/NOT with parens, SQLite three-valued logic,
``IS [NOT] NULL``, ``[NOT] LIKE/GLOB/IN``, scalar subqueries, the
``corro_json_contains`` function from ``sqlite-functions``),
non-recursive ``WITH`` CTEs, ``GROUP BY``, ``ORDER BY ... [ASC|DESC]``,
and ``LIMIT n [OFFSET m]``.
"""

from __future__ import annotations

import random as _random
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.db.schema import (
    CL_COL,
    RowMap,
    Schema,
    SchemaError,
    diff_schemas,
    parse_schema_sql,
)
from corrosion_tpu_torch.db.values import NULL_ID, ValueHeap, corro_json_contains


class SqlError(ValueError):
    pass


_INSERT_RE = re.compile(
    r"INSERT\s+(?:OR\s+(?P<or>IGNORE|REPLACE)\s+)?INTO\s+(?P<table>[\w\"]+)\s*"
    r"\((?P<cols>[^)]*)\)\s*VALUES\s*\((?P<vals>.*)\)\s*"
    r"(?P<conflict>ON\s+CONFLICT.*)?$",
    re.IGNORECASE | re.DOTALL,
)
_INSERT_SELECT_RE = re.compile(
    r"INSERT\s+(?:OR\s+(?P<or>IGNORE|REPLACE)\s+)?INTO\s+(?P<table>[\w\"]+)\s*"
    r"\((?P<cols>[^)]*)\)\s*(?P<select>(?:WITH|SELECT)\s.*)$",
    re.IGNORECASE | re.DOTALL,
)
_UPDATE_RE = re.compile(
    r"UPDATE\s+(?P<table>[\w\"]+)\s+SET\s+(?P<sets>.*?)\s+WHERE\s+(?P<where>.*)$",
    re.IGNORECASE | re.DOTALL,
)
_DELETE_RE = re.compile(
    r"DELETE\s+FROM\s+(?P<table>[\w\"]+)\s+WHERE\s+(?P<where>.*)$",
    re.IGNORECASE | re.DOTALL,
)
_SELECT_RE = re.compile(r"SELECT\b", re.IGNORECASE)
# top-level clause keywords of the supported SELECT grammar:
# SELECT cols FROM t [alias] [[LEFT] JOIN t2 [alias] ON a.c = b.c]*
#   [WHERE conj] [GROUP BY cols] [ORDER BY col [ASC|DESC], ...]
#   [LIMIT n [OFFSET m]]
_KW_RE = re.compile(
    r"\b(FROM|LEFT\s+OUTER\s+JOIN|LEFT\s+JOIN|INNER\s+JOIN|JOIN|ON|WHERE|"
    r"GROUP\s+BY|HAVING|ORDER\s+BY|LIMIT|OFFSET)\b",
    re.IGNORECASE,
)
_AGG_RE = re.compile(
    r"^(?P<fn>COUNT|SUM|MIN|MAX|AVG|TOTAL)\s*\(\s*(?P<arg>\*|[\w\".]+)\s*\)"
    r"(?:\s+AS\s+(?P<alias>[\w\"]+))?$",
    re.IGNORECASE | re.DOTALL,
)
_COL_AS_RE = re.compile(
    r"^(?P<col>[\w\".]+)(?:\s+AS\s+(?P<alias>[\w\"]+))?$",
    re.IGNORECASE | re.DOTALL,
)
_COND_RE = re.compile(
    r"^(?P<col>[\w\".]+)\s*(?P<op>=|!=|<>|<=|>=|<|>)\s*(?P<val>.+)$", re.DOTALL
)
# HAVING comparisons allow an aggregate call on the left: COUNT(*) > 5
_HAVING_COND_RE = re.compile(
    r"^(?P<col>.+?)\s*(?P<op>=|!=|<>|<=|>=|<|>)\s*(?P<val>.+)$", re.DOTALL
)
_LIKE_RE = re.compile(
    r"^(?P<col>[\w\".]+)\s+(?P<neg>NOT\s+)?(?P<fn>LIKE|GLOB)\s+(?P<val>.+)$",
    re.IGNORECASE | re.DOTALL,
)
_IN_RE = re.compile(
    r"^(?P<col>[\w\".]+)\s+(?P<neg>NOT\s+)?IN\s*\((?P<body>.*)\)$",
    re.IGNORECASE | re.DOTALL,
)
_FUNC_RE = re.compile(
    r"^corro_json_contains\s*\(\s*(?P<a>[^,]+)\s*,\s*(?P<b>.+)\s*\)$",
    re.IGNORECASE | re.DOTALL,
)
_ISNULL_RE = re.compile(
    r"^(?P<col>[\w\".]+)\s+IS\s+(?P<neg>NOT\s+)?NULL$",
    re.IGNORECASE | re.DOTALL,
)
_WITH_RE = re.compile(r"^\s*WITH\s+(?:RECURSIVE\s+)?", re.IGNORECASE)
_CTE_HEAD_RE = re.compile(
    r"^\s*([\w\"]+)\s*(?:\(([^)]*)\))?\s+AS\s*\(", re.IGNORECASE
)
_UNION_ALL_RE = re.compile(r"\bUNION\s+ALL\b", re.IGNORECASE)


class _CteColumn:
    """Duck-typed column of a CTE's result (``Table.columns`` shape)."""

    __slots__ = ("name", "primary_key")

    def __init__(self, name: str):
        self.name = name
        self.primary_key = False


class _CteTable:
    """Duck-typed ``Table`` for a WITH common-table-expression: the
    parser resolves columns against the sub-select's projection names,
    and execution materializes the sub-select per node
    (``corro-pg``'s surface is full SQLite, which includes
    non-recursive CTEs; ``crates/corro-pg/src/lib.rs``)."""

    def __init__(self, name: str, col_names: List[str], ast):
        self.name = name
        self.columns = [_CteColumn(c) for c in col_names]
        self.ast = ast

    def column(self, name: str):
        for c in self.columns:
            if c.name == name:
                return c
        raise SqlError(f"no such column: {self.name}.{name}")

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)


class _DualTable(_CteTable):
    """One-row, zero-column pseudo table backing FROM-less SELECTs
    (``SELECT random()``, ``SELECT 1`` — the base select of the
    reference's recursive bulk-insert generator)."""

    def __init__(self):
        super().__init__("__dual__", [], ast=None)


class _RecursiveCte(_CteTable):
    """``WITH RECURSIVE name(cols) AS (base UNION ALL step)`` — the
    reference's stress tests use exactly this as a bulk row generator
    (``INSERT INTO testsbool (id) WITH RECURSIVE cte(id) AS (SELECT
    random() UNION ALL SELECT random() FROM cte LIMIT n) ...``,
    ``agent/tests.rs:622``, and the reference's ``.antithesis/``
    scripts). Evaluated iteratively: the step select sees the rows
    produced by the PREVIOUS iteration; generation stops at the body's
    LIMIT (total rows, like SQLite's compound limit) or a safety cap."""

    MAX_ROWS = 1_000_000  # runaway-recursion backstop without a LIMIT

    def __init__(self, name: str, col_names: List[str], base_ast,
                 step_ast, limit: Optional[int], self_marker,
                 self_referential: bool = True,
                 offset: Optional[int] = None):
        super().__init__(name, col_names, ast=None)
        self.base_ast = base_ast
        self.step_ast = step_ast
        self.limit = limit
        self.offset = offset
        # the step's self-reference is a plain _CteTable whose ast IS
        # this marker; execution pre-seeds the memo slot with the
        # previous iteration's rows, so the self-ref never recurses
        self.self_marker = self_marker
        # a UNION ALL whose step never reads the CTE is a plain
        # compound: base + one step pass, no iteration
        self.self_referential = self_referential


import functools
import string

# SQLite's LIKE folds case for ASCII letters ONLY ('ä' LIKE 'Ä' is 0);
# both operands are mapped through this table instead of re.IGNORECASE
_ASCII_LOWER = str.maketrans(string.ascii_uppercase, string.ascii_lowercase)


@functools.lru_cache(maxsize=512)
def _like_to_regex(pattern: str, glob: bool) -> "re.Pattern":
    """SQLite ``LIKE`` (%/_; caller pre-folds ASCII case) / ``GLOB``
    (*/?/[...], case-sensitive) pattern -> anchored regex."""
    out, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if not glob and ch == "%":
            out.append(".*")
        elif not glob and ch == "_":
            out.append(".")
        elif glob and ch == "*":
            out.append(".*")
        elif glob and ch == "?":
            out.append(".")
        elif glob and ch == "[":
            j = pattern.find("]", i + 1)
            if j < 0:
                out.append(re.escape(ch))
            else:
                body = pattern[i + 1 : j]
                if body.startswith("^"):
                    body = "^" + re.sub(r"([\\\]])", r"\\\1", body[1:])
                else:
                    body = re.sub(r"([\\\]])", r"\\\1", body)
                out.append("[" + body + "]")
                i = j
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$")


# --- scalar expression engine (projection expressions) -------------------
# The reference runs full SQLite underneath, so projections like
# ``price * 2``, ``COALESCE(a, b)``, ``upper(name) || '!'`` just work;
# this mirrors the commonly-exercised scalar surface with SQLite's NULL
# semantics (NULL propagates; x/0 -> NULL; int/int truncates).

_EXPR_TOKEN_RE = re.compile(
    r"\s*(\|\||<>|<=|>=|!=|[+\-*/%(),=<>]|'(?:[^']|'')*'|[\w\".:$?]+)"
)

_NUM_PREFIX_RE = re.compile(r"^\s*[+-]?(\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+)")


def _num(v):
    """SQLite numeric coercion for arithmetic: text uses its numeric
    prefix (``'3x' + 1`` is 4), non-numeric text and blobs are 0."""
    if v is None or isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        m = _NUM_PREFIX_RE.match(v)
        if not m:
            return 0
        tok = m.group(0)
        try:
            return int(tok)
        except ValueError:
            return float(tok)
    return 0


def _sqlite_round(x: float, digits: int) -> float:
    """SQLite rounds halves away from zero (Python rounds half-even)."""
    import math

    s = 10.0 ** digits
    return math.copysign(math.floor(abs(x) * s + 0.5), x) / s


class _ExprParser:
    """Tiny recursive-descent parser -> ``rec -> value`` closure."""

    FUNCS = {
        "COALESCE": lambda args: next((a for a in args if a is not None),
                                      None),
        "IFNULL": lambda args: args[0] if args[0] is not None else args[1],
        "LENGTH": lambda args: (None if args[0] is None
                                else len(str(args[0]))),
        "UPPER": lambda args: (None if args[0] is None
                               else str(args[0]).upper()),
        "LOWER": lambda args: (None if args[0] is None
                               else str(args[0]).lower()),
        "ABS": lambda args: (None if args[0] is None
                             else abs(_num(args[0]))),
        # SQLite random(): a signed 64-bit integer (the reference's
        # stress tests generate pks with it, agent/tests.rs:622)
        "RANDOM": lambda args: _random.randint(-(1 << 63), (1 << 63) - 1),
        "ROUND": lambda args: (
            None if args[0] is None
            else _sqlite_round(float(_num(args[0])),
                               int(args[1]) if len(args) > 1 else 0)
        ),
    }

    def __init__(self, s: str, resolve, p: "_Params", check_params: bool):
        self.toks: List[str] = []
        i = 0
        while i < len(s):
            m = _EXPR_TOKEN_RE.match(s, i)
            if m is None:
                if s[i:].strip():
                    raise SqlError(f"bad expression near {s[i:][:30]!r}")
                break
            self.toks.append(m.group(1))
            i = m.end()
        self.pos = 0
        self.resolve = resolve
        self.p = p
        self.check_params = check_params

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def take(self) -> str:
        t = self.peek()
        if t is None:
            raise SqlError("unexpected end of expression")
        self.pos += 1
        return t

    def parse(self):
        fn = self._add()
        if self.peek() is not None:
            raise SqlError(f"trailing tokens in expression: {self.peek()!r}")
        return fn

    def _add(self):
        fn = self._mul()
        while self.peek() in ("+", "-"):
            op = self.take()
            rhs = self._mul()
            fn = self._arith(fn, rhs, op)
        return fn

    def _mul(self):
        fn = self._concat()
        while self.peek() in ("*", "/", "%"):
            op = self.take()
            rhs = self._concat()
            fn = self._arith(fn, rhs, op)
        return fn

    def _concat(self):
        fn = self._atom()
        while self.peek() == "||":
            self.take()
            rhs = self._atom()

            def concat(rec, a=fn, b=rhs):
                va, vb = a(rec), b(rec)
                if va is None or vb is None:
                    return None
                return str(va) + str(vb)

            fn = concat
        return fn

    @staticmethod
    def _arith(a, b, op):
        def run(rec):
            va, vb = _num(a(rec)), _num(b(rec))
            if va is None or vb is None:
                return None
            if op == "+":
                return va + vb
            if op == "-":
                return va - vb
            if op == "*":
                return va * vb
            if op == "%":
                if vb == 0:
                    return None
                # SQLite/C modulo: sign follows the dividend
                r = abs(va) % abs(vb)
                return r if va >= 0 else -r
            if vb == 0:
                return None  # SQLite: x / 0 is NULL
            if isinstance(va, int) and isinstance(vb, int):
                q = abs(va) // abs(vb)  # int/int truncates toward zero
                return q if (va >= 0) == (vb >= 0) else -q
            return va / vb

        return run

    def _atom(self):
        t = self.take()
        if t == "(":
            fn = self._add()
            if self.take() != ")":
                raise SqlError("unbalanced parens in expression")
            return fn
        if t == "-":
            inner = self._atom()

            def neg(rec):
                v = _num(inner(rec))
                return None if v is None else -v

            return neg
        up = t.upper()
        if up in self.FUNCS and self.peek() == "(":
            self.take()
            args = []
            if self.peek() != ")":
                args.append(self._add())
                while self.peek() == ",":
                    self.take()
                    args.append(self._add())
            if self.take() != ")":
                raise SqlError(f"unbalanced parens in {t}()")
            impl = self.FUNCS[up]
            return lambda rec: impl([a(rec) for a in args])
        if t.startswith("'") or t in ("?",) or t.startswith((":", "$")) \
                or up in ("NULL", "TRUE", "FALSE") or t[0].isdigit() \
                or (t[0] == "." and len(t) > 1 and t[1].isdigit()):
            v = (_parse_literal(t, self.p) if self.check_params else None)
            return lambda rec: v
        key = self.resolve(t)
        return lambda rec: rec.get(key)


def _split_expr_alias(raw: str) -> Tuple[str, Optional[str]]:
    """Split a projection expression from a trailing ``AS alias`` (or a
    bare trailing identifier alias) at paren depth 0."""
    m = re.search(r"\s+AS\s+([\w\"]+)\s*$", raw, re.IGNORECASE)
    if m:
        depth = raw[: m.start()].count("(") - raw[: m.start()].count(")")
        if depth == 0:
            return raw[: m.start()].strip(), _unquote(m.group(1))
    return raw.strip(), None


def _split_top_kw(s: str, kw: str) -> List[str]:
    """Split on a top-level keyword (``AND``/``OR``) only — occurrences
    inside parens (subqueries, groups), strings, or quoted identifiers
    don't count (ADVICE r4: ``"a or b"`` must not split)."""
    parts, start, depth, in_str = [], 0, 0, ""
    i, n, k = 0, len(s), len(kw)
    while i < n:
        ch = s[i]
        if in_str:
            if ch == in_str:
                in_str = ""
        elif ch in ("'", '"'):
            in_str = ch
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif depth == 0 and s[i : i + k].upper() == kw and (
            i == 0 or not (s[i - 1].isalnum() or s[i - 1] in "_\"")
        ) and (
            i + k >= n or not (s[i + k].isalnum() or s[i + k] in "_\"")
        ):
            parts.append(s[start:i])
            i += k
            start = i
            continue
        i += 1
    parts.append(s[start:])
    return [p.strip() for p in parts if p.strip()]


def _split_top_and(s: str) -> List[str]:
    return _split_top_kw(s, "AND")


def _is_paren_group(s: str) -> bool:
    """Whole string is one balanced ``( ... )`` group (so the parens are
    grouping, not part of an expression like ``(a + b) > 5``)."""
    s = s.strip()
    if not (s.startswith("(") and s.endswith(")")):
        return False
    depth, in_str = 0, ""
    for i, ch in enumerate(s):
        if in_str:
            if ch == in_str:
                in_str = ""
        elif ch in ("'", '"'):
            in_str = ch
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return i == len(s) - 1
    return False


def _unquote(ident: str) -> str:
    return ident.strip().strip('"').strip("`")


class _Params:
    """Positional ``?`` and named ``:name``/``$name`` parameter source."""

    def __init__(self, params: Any):
        self.named: Dict[str, Any] = {}
        self.positional: List[Any] = []
        if isinstance(params, dict):
            self.named = params
        elif params is not None:
            self.positional = list(params)
        self._pos = 0

    def next_positional(self) -> Any:
        if self._pos >= len(self.positional):
            raise SqlError("not enough positional parameters")
        v = self.positional[self._pos]
        self._pos += 1
        return v

    def get_named(self, name: str) -> Any:
        if name not in self.named:
            raise SqlError(f"missing named parameter :{name}")
        return self.named[name]


def _parse_literal(tok: str, params: _Params) -> Any:
    tok = tok.strip()
    if tok == "?":
        return params.next_positional()
    if tok.startswith((":", "$", "@")):
        return params.get_named(tok[1:])
    up = tok.upper()
    if up == "NULL":
        return None
    if up == "TRUE":
        return 1
    if up == "FALSE":
        return 0
    if tok.startswith("'") and tok.endswith("'") and len(tok) >= 2:
        return tok[1:-1].replace("''", "'")
    if (tok.startswith("x'") or tok.startswith("X'")) and tok.endswith("'"):
        return bytes.fromhex(tok[2:-1])
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            raise SqlError(f"unsupported literal: {tok!r}")


def _split_top_commas(s: str) -> List[str]:
    parts, depth, start = [], 0, 0
    in_str = ""
    for i, ch in enumerate(s):
        if in_str:
            if ch == in_str:
                in_str = ""
        elif ch in ("'", '"'):
            in_str = ch
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(s[start:i])
            start = i + 1
    parts.append(s[start:])
    return [p.strip() for p in parts if p.strip()]


class ExecResult(dict):
    """``{rows_affected, time}`` — corro-api-types ``ExecResult``."""


class Database:
    """Schema + heap + row map bound to one :class:`Agent` cluster."""

    def __init__(self, agent):
        self.agent = agent
        # register for checkpoint recovery: a rollback must rewind the
        # host state (schema, heap, rows) together with the device state
        agent.recovery_db = self
        self.schema = Schema()
        self.heap = ValueHeap()
        self.rows = RowMap(agent.cfg.n_rows)
        self.n_cols = agent.cfg.n_cols
        self._mu = threading.Lock()
        self._write_hooks: List = []  # pubsub/updates change hooks
        # commit-instant stamps per (table, pk), bounded LRU:
        # the write path stamps each committed notification and the
        # NDJSON subscription streams observe write-commit -> delivery
        # latency against them (corro.subs.delivery.seconds)
        from collections import OrderedDict

        self._write_stamps: "OrderedDict[Tuple[str, Any], float]" = (
            OrderedDict()
        )
        # open StagedTxs (weak: an abandoned tx drops out on GC) — their
        # planned value ids are pinned against heap compaction
        import weakref

        self._open_txs = weakref.WeakSet()
        self._delta_tracker = None  # shared per-round delta cache

    def delta_tracker(self):
        """The shared :class:`~corrosion_tpu_torch.pubsub.DeltaTracker` for
        this database — one plane baseline + one per-round delta
        computation, shared by subscriptions and updates feeds."""
        with self._mu:
            if self._delta_tracker is None:
                from corrosion_tpu_torch.pubsub import DeltaTracker

                self._delta_tracker = DeltaTracker(self)
            return self._delta_tracker

    # --- schema ----------------------------------------------------------
    def apply_schema_sql(self, sql: str) -> List[Tuple[str, str]]:
        """Parse + diff + apply (``/v1/migrations`` and startup schema
        files, ``public/mod.rs:540-593``)."""
        new = parse_schema_sql(sql)
        with self._mu:
            merged = Schema(dict(self.schema.tables))
            for name, t in new.tables.items():
                merged.tables[name] = t
            changes = diff_schemas(self.schema, merged)
            for t in merged.tables.values():
                if len(t.value_columns) > self.n_cols - 1:
                    raise SchemaError(
                        f"table {t.name} has {len(t.value_columns)} value "
                        f"columns; grid supports {self.n_cols - 1} "
                        f"(raise [sim].n_cols)"
                    )
            self.schema = merged
        return changes

    def add_write_hook(self, hook) -> None:
        """hook(node, table, pk, {col: value}, deleted: bool) after a
        local write enters the round loop — the ``match_changes`` seam
        (``util.rs:1034-1037``)."""
        with self._mu:
            self._write_hooks.append(hook)

    _STAMP_CAP = 8192  # bounded: stamps for keys nobody subscribes to age out

    def _stamp_writes(self, notes: Sequence[tuple]) -> None:
        """Record the commit instant for each write notification. Called
        on the write path right after ``write_many`` returns (the write
        has entered the round loop — the reference's committed point);
        delivery observation looks the stamp up per (table, pk)."""
        if not notes:
            return
        now = time.perf_counter()
        with self._mu:
            stamps = self._write_stamps
            for table, pk, _values, _deleted in notes:
                stamps[(table, pk)] = now
                stamps.move_to_end((table, pk))
            while len(stamps) > self._STAMP_CAP:
                stamps.popitem(last=False)

    def write_stamp(self, table: str, pk: Any) -> Optional[float]:
        """Latest commit instant (``time.perf_counter`` domain) for
        (table, pk), or None if never written / aged out."""
        with self._mu:
            return self._write_stamps.get((table, pk))

    # --- cell helpers ----------------------------------------------------
    def _cell(self, row: int, col: int) -> int:
        return row * self.n_cols + col

    def _read_plane(self, node: int, row: int, col: int,
                    overlay: Optional[Dict[int, Tuple[int, int]]] = None) -> int:
        """Value-plane read; ``overlay`` holds this transaction's pending
        ``cell -> (value, clp)`` entries so later statements observe
        earlier ones (the reference runs statements sequentially inside
        one SQLite tx, ``public/mod.rs:141-174``)."""
        cell = self._cell(row, col)
        if overlay is not None and cell in overlay:
            return overlay[cell][0]
        snap = self.agent.snapshot()
        return int(snap["store"][1][node, cell])

    def _row_live(self, node: int, row: int,
                  overlay: Optional[Dict[int, Tuple[int, int]]] = None) -> bool:
        return self._read_plane(node, row, CL_COL, overlay) % 2 == 1

    def _row_record(self, node: int, table, pk, row: int,
                    overlay: Optional[Dict[int, Tuple[int, int]]] = None
                    ) -> Dict[str, Any]:
        """The row's visible values keyed by plain column name,
        overlay-aware (UPDATE expressions read the pre-update row as
        later statements in the same tx left it)."""
        snap = self.agent.snapshot()
        vals, clps = snap["store"][1], snap["store"][4]

        def read(cell: int) -> Tuple[int, int]:
            if overlay is not None and cell in overlay:
                return overlay[cell]
            return int(vals[node, cell]), int(clps[node, cell])

        row_cl, _ = read(self._cell(row, CL_COL))
        rec: Dict[str, Any] = {table.pk.name: pk}
        for c in table.value_columns:
            v, clp = read(self._cell(row, table.col_index(c.name)))
            rec[c.name] = self.heap.lookup(v) if clp == row_cl else None
        return rec

    # --- writes ----------------------------------------------------------
    def execute(self, node: int, statements: Sequence,
                wait: bool = True, timeout: float = 30.0) -> List[ExecResult]:
        """Run a transaction of statements at ``node``
        (``/v1/transactions``). Each statement is ``sql`` or
        ``(sql, params)``; returns one ``ExecResult`` per statement."""
        t0 = time.perf_counter()
        results: List[ExecResult] = []
        # cell -> (final value, causal-length lifetime) this tx (ordered)
        merged: Dict[int, Tuple[int, int]] = {}
        notifications = []
        for stmt in statements:
            sql, params = (stmt, None) if isinstance(stmt, str) else (
                stmt[0], stmt[1] if len(stmt) > 1 else None
            )
            affected, stmt_cells, notes = self._plan_write(
                node, sql, params, merged
            )
            # later statements override earlier cells for the same target —
            # last-write-wins within the transaction, like sequential
            # statements in one SQLite tx (dict update keeps first position)
            merged.update({c: (v, l) for c, v, l in stmt_cells})
            notifications.extend(notes)
            results.append(
                ExecResult(rows_affected=affected,
                           time=time.perf_counter() - t0)
            )
        cells = self._order_tx_cells(merged)
        if cells:
            self.agent.write_many(node, cells, wait=wait, timeout=timeout)
        self._stamp_writes(notifications)
        with self._mu:
            hooks = list(self._write_hooks)
        for note in notifications:
            for hook in hooks:
                hook(node, *note)
        return results

    # --- heap compaction (vacuum_db analog, handlers.rs:398-452) ---------
    def referenced_value_ids(self) -> set:
        """Every heap id referenced by device state anywhere: the store
        value planes of all nodes, in-flight broadcast queue payloads,
        and buffered partial-version payloads. The union is the live set
        a heap compaction must preserve."""
        import numpy as np

        st = self.agent.device_state()
        crdt = getattr(st, "crdt", st)
        refs: set = set()
        arrays = [np.asarray(crdt.store[1])]
        q_val = getattr(crdt, "q_val", None)
        if q_val is not None:
            # freed queue slots (origin -1) keep stale payload bytes —
            # mask them to NULL or old ids would stay referenced forever
            live = np.asarray(crdt.q_origin) >= 0
            arrays.append(np.where(live, np.asarray(q_val), 0))
        partials = getattr(crdt, "partials", None)
        if partials is not None:
            live = (np.asarray(partials.origin) >= 0)[..., None]
            arrays.append(np.where(live, np.asarray(partials.val), 0))
        for a in arrays:
            refs.update(int(x) for x in np.unique(a))
        # ids planned inside open (uncommitted) StagedTxs live only on
        # the host until COMMIT — pin them (code review r5: an idle PG
        # BEGIN block outliving the grace window must not lose values)
        with self._mu:  # WeakSet iteration races concurrent BEGIN adds
            open_txs = list(self._open_txs)
        for tx in open_txs:
            if not tx._done:
                # snapshot: the PG handler thread mutates _merged
                # concurrently with this maintenance-thread scan
                refs.update(v for v, _l in list(tx._merged.values()))
        return refs

    def compact_heap(self, grace_seconds: float = 300.0) -> int:
        """One heap-compaction pass: free ids referenced nowhere in
        device state (ids are stable — unreferenced ones go to a free
        list for reuse, device planes are never rewritten). The grace
        window protects writes planned on the host but not yet applied
        on device. Returns the number of ids freed."""
        return self.heap.compact(self.referenced_value_ids(),
                                 grace_seconds=grace_seconds)

    def begin(self, node: int) -> "StagedTx":
        """Open a multi-statement staged transaction at ``node`` — the
        PG-wire BEGIN/COMMIT surface (``corro-pg/src/lib.rs`` runs real
        SQLite transactions; here statements are planned eagerly against
        a shared overlay, so later statements read earlier writes and
        per-statement row counts are exact, and nothing reaches the
        round loop until :meth:`StagedTx.commit`)."""
        return StagedTx(self, node)

    def _order_tx_cells(self, merged: Dict[int, Tuple[int, int]]
                        ) -> List[Tuple[int, int, int]]:
        """Drain order for the transaction's net ``(cell, value, clp)``
        writes: causal-length flips that leave a row LIVE go last (the row
        only turns visible once its values are in flight) and flips that
        leave it DEAD go first. Within one ``tx_max_cells`` chunk the
        commit is atomic (one db_version, remote buffering), so order only
        matters when an oversized transaction splits into several
        versions — there, list order is chunk order is visibility order."""
        deaths, values, lives = [], [], []
        for cell, (value, clp) in merged.items():
            if cell % self.n_cols == CL_COL:
                (lives if value % 2 == 1 else deaths).append((cell, value, clp))
            else:
                values.append((cell, value, clp))
        return deaths + values + lives

    def _plan_write(self, node: int, sql: str, params: Any,
                    overlay: Optional[Dict[int, int]] = None):
        """-> (rows_affected, [(cell, interned_val)], [notifications])."""
        sql = sql.strip().rstrip(";").strip()
        p = _Params(params)
        m = _INSERT_RE.match(sql)
        if m:
            return self._plan_insert(node, m, p, overlay)
        m = _INSERT_SELECT_RE.match(sql)
        if m:
            return self._plan_insert_select(node, m, p, overlay)
        m = _UPDATE_RE.match(sql)
        if m:
            return self._plan_update(node, m, p, overlay)
        m = _DELETE_RE.match(sql)
        if m:
            return self._plan_delete(node, m, p, overlay)
        if _SELECT_RE.match(sql):
            raise SqlError("SELECT not allowed in /v1/transactions (read-only "
                           "statements go to /v1/queries)")
        raise SqlError(f"unsupported statement: {sql[:80]!r}")

    def _insert_by_col(self, table, col_names: List[str], vals: List[Any]):
        """Shared INSERT row prep: (pk, by_col with defaults filled)."""
        if len(col_names) != len(vals):
            raise SqlError(f"{len(col_names)} columns but {len(vals)} values")
        by_col = dict(zip(col_names, vals))
        pk_name = table.pk.name
        if pk_name not in by_col:
            raise SqlError(f"INSERT into {table.name} must set pk {pk_name}")
        pk = by_col.pop(pk_name)
        if pk is None:
            raise SqlError(f"pk {table.name}.{pk_name} cannot be NULL")
        for c in table.value_columns:
            if c.name not in by_col:
                by_col[c.name] = c.default
            elif by_col[c.name] is None and c.not_null:
                raise SqlError(f"NOT NULL violation: {table.name}.{c.name}")
        for name in by_col:
            table.column(name)  # raises on unknown column
        return pk, by_col

    def _plan_insert_select(self, node: int, m, p: _Params,
                            overlay: Optional[Dict[int, int]] = None):
        """``INSERT INTO t (cols) SELECT ...`` (incl. a WITH RECURSIVE
        generator select — the reference's bulk-insert stress shape,
        ``agent/tests.rs:622``). Each produced row plans like a VALUES
        insert; later rows observe earlier ones through a local overlay
        (duplicate pks upsert, like sequential inserts)."""
        table = self.schema.table(_unquote(m.group("table")))
        col_names = [_unquote(c) for c in m.group("cols").split(",")]
        ast = self._parse_select(m.group("select"), p)
        or_clause = (m.group("or") or "").upper()
        ov = dict(overlay or {})
        total, cells_acc, notes_acc = 0, [], []
        for vals in list(self._run_select(node, ast, overlay=ov)):
            pk, by_col = self._insert_by_col(table, col_names, list(vals))
            n1, cells, notes = self._plan_insert_core(
                node, table, pk, by_col, or_clause, "", p, ov)
            ov.update({c: (v, l) for c, v, l in cells})
            total += n1
            cells_acc.extend(cells)
            notes_acc.extend(notes)
        return total, cells_acc, notes_acc

    def _plan_insert(self, node: int, m, p: _Params,
                     overlay: Optional[Dict[int, int]] = None):
        table = self.schema.table(_unquote(m.group("table")))
        col_names = [_unquote(c) for c in m.group("cols").split(",")]
        vals = [_parse_literal(v, p) for v in _split_top_commas(m.group("vals"))]
        pk, by_col = self._insert_by_col(table, col_names, vals)
        return self._plan_insert_core(
            node, table, pk, by_col, (m.group("or") or "").upper(),
            (m.group("conflict") or "").strip(), p, overlay,
        )

    def _plan_insert_core(self, node: int, table, pk, by_col: Dict[str, Any],
                          or_clause: str, conflict_raw: str, p: _Params,
                          overlay: Optional[Dict[int, int]] = None):
        pk_name = table.pk.name
        row = self.rows.get_or_alloc(table.name, pk)
        cl = self._read_plane(node, row, CL_COL, overlay)
        live = cl % 2 == 1
        conflict = conflict_raw.upper()
        if live and (or_clause == "IGNORE" or "DO NOTHING" in conflict):
            return 0, [], []
        if live and "DO UPDATE" in conflict:
            # ON CONFLICT DO UPDATE SET ... (upsert with expressions;
            # the reference gets this free from SQLite). `excluded.col`
            # refers to the proposed insert values, a bare column to the
            # existing row — standard SQLite semantics.
            du = re.search(r"DO\s+UPDATE\s+SET\s+(?P<sets>.*)$",
                           conflict_raw, re.IGNORECASE | re.DOTALL)
            if du is None:
                raise SqlError(
                    f"unsupported ON CONFLICT clause: {conflict_raw!r}")
            excluded = {**by_col, pk_name: pk}

            def res(ref: str) -> str:
                ref = ref.strip()
                if "." in ref:
                    q, _, c = ref.partition(".")
                    if _unquote(q).lower() != "excluded":
                        raise SqlError(
                            f"unknown qualifier {q!r} in DO UPDATE")
                    c = _unquote(c)
                    table.column(c)
                    return f"excluded.{c}"
                c = _unquote(ref)
                table.column(c)
                return c

            rec = self._row_record(node, table, pk, row, overlay)
            rec.update({f"excluded.{k}": v for k, v in excluded.items()})
            sets: Dict[str, Any] = {}
            for part in _split_top_commas(du.group("sets")):
                if "=" not in part:
                    raise SqlError(f"bad DO UPDATE SET clause: {part!r}")
                name, _, raw = part.partition("=")
                name = _unquote(name)
                if table.column(name).primary_key:
                    raise SqlError("cannot DO UPDATE the primary key")
                try:
                    sets[name] = _parse_literal(raw, p)
                except SqlError:
                    sets[name] = _ExprParser(raw, res, p, True).parse()(rec)
            for name, value in sets.items():
                if value is None and table.column(name).not_null:
                    raise SqlError(
                        f"NOT NULL violation: {table.name}.{name}")
            cells = [
                (self._cell(row, table.col_index(name)),
                 self.heap.intern(value), cl)
                for name, value in sets.items()
            ]
            return 1, cells, [(table.name, pk, dict(sets), False)]
        # lifetime the write belongs to: the current one for a live-row
        # upsert, the NEXT odd causal length for an insert/resurrect —
        # value cells from a previous lifetime must not leak through
        # (cr-sqlite `cl` semantics, doc/crdts.md:24-40)
        lifetime = cl if live else cl + 1
        cells: List[Tuple[int, int, int]] = []
        for name, value in by_col.items():
            cells.append(
                (self._cell(row, table.col_index(name)),
                 self.heap.intern(value), lifetime)
            )
        if not live:
            # CL flip staged LAST: within a tx_max_cells chunk the commit
            # is atomic, but an oversized transaction splits into several
            # versions — the row must only turn live once its values are
            # already committed/in flight (insert atomicity for readers)
            cells.append((self._cell(row, CL_COL), cl + 1, cl + 1))
        return 1, cells, [(table.name, pk, dict(by_col), False)]

    def _split_where_pk(self, table, where: str, p: _Params):
        cond = _COND_RE.match(where.strip())
        if not cond or cond.group("op") != "=":
            raise SqlError(
                f"writes require `WHERE {table.pk.name} = <value>` "
                f"(got {where!r})"
            )
        col = _unquote(cond.group("col"))
        if col != table.pk.name:
            raise SqlError(f"writes must filter on the pk ({table.pk.name})")
        return _parse_literal(cond.group("val"), p)

    def _plan_update(self, node: int, m, p: _Params,
                     overlay: Optional[Dict[int, int]] = None):
        table = self.schema.table(_unquote(m.group("table")))
        sets: Dict[str, Any] = {}
        exprs: Dict[str, Any] = {}  # SET col = <expression over the row>

        def res(ref: str) -> str:
            c = _unquote(ref.strip())
            table.column(c)  # raises on unknown column
            return c

        set_parts = _split_top_commas(m.group("sets"))
        for part in set_parts:
            if "=" not in part:
                raise SqlError(f"bad SET clause: {part!r}")
            name, _, raw = part.partition("=")
            name = _unquote(name)
            col = table.column(name)
            if col.primary_key:
                raise SqlError("cannot UPDATE the primary key")
            try:
                sets[name] = _parse_literal(raw, p)
            except SqlError:
                # UPDATE with an expression right side (SET x = x + 1,
                # SET x = LENGTH(y) ...) — the reference gets this free
                # from SQLite (sqlite.rs:121-139); evaluated against the
                # PRE-update row, like SQL
                exprs[name] = _ExprParser(raw, res, p, True).parse()
        pk = self._split_where_pk(table, m.group("where"), p)
        row = self.rows.get(table.name, pk)
        if row is None or not self._row_live(node, row, overlay):
            return 0, [], []
        if exprs:
            rec = self._row_record(node, table, pk, row, overlay)
            for name, fn in exprs.items():
                sets[name] = fn(rec)
        for name, value in sets.items():
            if value is None and table.column(name).not_null:
                raise SqlError(f"NOT NULL violation: {table.name}.{name}")
        lifetime = self._read_plane(node, row, CL_COL, overlay)
        cells = [
            (self._cell(row, table.col_index(name)),
             self.heap.intern(value), lifetime)
            for name, value in sets.items()
        ]
        return 1, cells, [(table.name, pk, dict(sets), False)]

    def _plan_delete(self, node: int, m, p: _Params,
                     overlay: Optional[Dict[int, int]] = None):
        table = self.schema.table(_unquote(m.group("table")))
        pk = self._split_where_pk(table, m.group("where"), p)
        row = self.rows.get(table.name, pk)
        if row is None:
            return 0, [], []
        cl = self._read_plane(node, row, CL_COL, overlay)
        if cl % 2 == 0:
            return 0, [], []
        cells = [(self._cell(row, CL_COL), cl + 1, cl + 1)]
        return 1, cells, [(table.name, pk, {}, True)]

    # --- reads -----------------------------------------------------------
    def query(self, node: int, sql: str, params: Any = None
              ) -> Tuple[List[str], Iterable[List[Any]]]:
        """Read-only query against ``node``'s replica (``/v1/queries``).
        Returns ``(column_names, row_iterator)``.

        Dialect (the read surface the reference's templates/consul/admin
        tooling actually exercises over full SQLite): projection incl.
        aggregates (COUNT/SUM/MIN/MAX/AVG/TOTAL) with ``AS`` aliases,
        ``[LEFT] JOIN ... ON a.x = b.y`` equi-joins, ``WHERE``
        conjunctions, ``GROUP BY``, ``ORDER BY ... [ASC|DESC]``, and
        ``LIMIT n [OFFSET m]``."""
        ast = self._parse_select(sql, _Params(params))
        names = [c[2] for c in ast["cols"]]
        return names, self._run_select(node, ast)

    def query_filtered(self, node: int, sql: str, params: Any,
                       extra_conds: Sequence[tuple]
                       ) -> Iterable[List[Any]]:
        """Run ``sql`` with extra top-level cond tuples injected after
        parsing — the incremental subscription matcher's candidate-pk
        restriction (the analog of the reference's per-changeset
        candidate queries against the subscription DB,
        ``pubsub.rs:527-1100``). ``extra_conds`` holds evaluator cond
        tuples over resolved record keys, e.g. ``("in", "a.pk", [...])``
        or an ``("or", [branches...], None)`` disjunction of them; rows
        are returned without column names (the caller knows the
        projection)."""
        ast = self._parse_select(sql, _Params(params))
        ast = {**ast, "conds": list(ast["conds"]) + list(extra_conds)}
        return self._run_select(node, ast)

    def query_columns(self, sql: str) -> List[str]:
        """The column names a SELECT would produce — schema-only, no
        scan (used by the PG Describe phase)."""
        ast = self._parse_select(sql, _Params(None), check_params=False)
        return [c[2] for c in ast["cols"]]

    # --- SELECT parsing ---------------------------------------------------
    @staticmethod
    def _top_level_mask(sql: str) -> List[bool]:
        """True where a char sits outside quotes (both kinds) and parens."""
        mask, depth, in_str = [], 0, ""
        for ch in sql:
            if in_str:
                mask.append(False)
                if ch == in_str:
                    in_str = ""
            elif ch in ("'", '"'):
                in_str = ch
                mask.append(False)
            elif ch == "(":
                depth += 1
                mask.append(False)
            elif ch == ")":
                depth -= 1
                mask.append(False)
            else:
                mask.append(depth == 0)
        return mask

    def _parse_cte_prefix(self, sql: str, p: _Params, check_params: bool,
                          ctes: Optional[Dict[str, "_CteTable"]]):
        """Strip a leading ``WITH name AS (...), ...`` prefix, parsing
        each CTE body (earlier CTEs are visible to later ones and to the
        main select, like SQLite's non-recursive WITH)."""
        out: Dict[str, _CteTable] = dict(ctes or {})
        rest = sql[_WITH_RE.match(sql).end():]
        while True:
            hm = _CTE_HEAD_RE.match(rest)
            if hm is None:
                raise SqlError(f"malformed WITH clause near {rest[:60]!r}")
            name = _unquote(hm.group(1))
            # find the balanced close of the body paren
            depth, in_str, i = 1, False, hm.end()
            while i < len(rest) and depth:
                ch = rest[i]
                if in_str:
                    in_str = ch != "'"
                elif ch == "'":
                    in_str = True
                elif ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                i += 1
            if depth:
                raise SqlError(f"unbalanced parens in WITH {name!r}")
            body = rest[hm.end():i - 1].strip()
            head_cols = [
                _unquote(c) for c in (hm.group(2) or "").split(",")
                if c.strip()
            ]
            um = None
            for m2 in _UNION_ALL_RE.finditer(body):
                if self._top_level_mask(body)[m2.start()]:
                    um = m2
                    break
            if um is not None:
                # recursive CTE: base UNION ALL step [LIMIT total]
                base_ast = self._parse_select(body[:um.start()], p,
                                              check_params, ctes=out)
                cols = head_cols or [c[2] for c in base_ast["cols"]]
                marker = object()
                placeholder = _CteTable(name, cols, marker)
                step_ast = self._parse_select(
                    body[um.end():], p, check_params,
                    ctes={**out, name: placeholder},
                )
                # the compound's LIMIT/OFFSET (total generated rows,
                # SQLite semantics) parse as the step select's — lift
                # them off the step
                limit = step_ast.get("limit")
                offset = step_ast.get("offset")
                step_ast = {**step_ast, "limit": None, "offset": None}
                self_ref = any(
                    isinstance(t, _CteTable) and t.ast is marker
                    for t in step_ast["aliases"].values()
                )
                out[name] = _RecursiveCte(name, cols, base_ast, step_ast,
                                          limit, marker, self_ref,
                                          offset=offset)
            else:
                sub = self._parse_select(body, p, check_params, ctes=out)
                cols = head_cols or [c[2] for c in sub["cols"]]
                out[name] = _CteTable(name, cols, sub)
            rest = rest[i:].lstrip()
            if rest.startswith(","):
                rest = rest[1:].lstrip()
                continue
            return out, rest

    def _parse_select(self, sql: str, p: _Params, check_params: bool = True,
                      ctes: Optional[Dict[str, "_CteTable"]] = None):
        sql = sql.strip().rstrip(";").strip()
        if _WITH_RE.match(sql):
            ctes, sql = self._parse_cte_prefix(sql, p, check_params, ctes)
        if not _SELECT_RE.match(sql):
            raise SqlError(f"only SELECT is allowed on the query path: "
                           f"{sql[:80]!r}")
        mask = self._top_level_mask(sql)
        marks = [
            (m.start(), m.end(), re.sub(r"\s+", " ", m.group(1)).upper())
            for m in _KW_RE.finditer(sql)
            if mask[m.start()]
        ]
        from_marks = [m for m in marks if m[2] == "FROM"]
        if not from_marks:
            # FROM-less SELECT: evaluate the projection once against a
            # one-row dual table (SQLite semantics); re-parse with the
            # synthesized FROM inserted before any trailing clauses
            insert_at = marks[0][0] if marks else len(sql)
            sql2 = (sql[:insert_at] + " FROM __dual__ " + sql[insert_at:])
            return self._parse_select(
                sql2, p, check_params,
                ctes={**(ctes or {}), "__dual__": _DualTable()},
            )
        # clause segmentation: text between consecutive top-level keywords
        segs = []
        for i, (s, e, kw) in enumerate(marks):
            end = marks[i + 1][0] if i + 1 < len(marks) else len(sql)
            segs.append((kw, sql[e:end].strip()))
        cols_raw = sql[len("SELECT"):from_marks[0][0]].strip()

        # FROM + JOINs (CTE names shadow schema tables, like SQLite)
        def table_spec(raw):
            parts = raw.split()
            name = _unquote(parts[0])
            alias = _unquote(parts[-1]) if (
                len(parts) > 1 and parts[-1].upper() != "AS"
            ) else name
            if ctes and name in ctes:
                return ctes[name], alias
            return self.schema.table(name), alias

        aliases: Dict[str, Any] = {}
        joins = []
        where_raw = group_raw = order_raw = limit_raw = offset_raw = None
        having_raw = None
        i = 0
        while i < len(segs):
            kw, seg = segs[i]
            if kw == "FROM":
                base_table, base_alias = table_spec(seg)
                aliases[base_alias] = base_table
            elif kw.endswith("JOIN"):
                jtype = "left" if kw.startswith("LEFT") else "inner"
                if i + 1 >= len(segs) or segs[i + 1][0] != "ON":
                    raise SqlError(f"JOIN without ON: {seg!r}")
                t, a = table_spec(seg)
                if a in aliases:
                    raise SqlError(f"duplicate table alias {a!r}")
                aliases[a] = t
                cond = segs[i + 1][1]
                cm = re.match(
                    r"^([\w\".]+)\s*=\s*([\w\".]+)$", cond.strip()
                )
                if cm is None:
                    raise SqlError(
                        f"only equi-join ON a.x = b.y supported: {cond!r}"
                    )
                joins.append((jtype, a, cm.group(1), cm.group(2)))
                i += 1
            elif kw == "ON":
                raise SqlError("ON outside a JOIN")
            elif kw == "WHERE":
                where_raw = seg
            elif kw == "GROUP BY":
                group_raw = seg
            elif kw == "HAVING":
                having_raw = seg
            elif kw == "ORDER BY":
                order_raw = seg
            elif kw == "LIMIT":
                limit_raw = seg
            elif kw == "OFFSET":
                offset_raw = seg
            i += 1

        def resolve(ref: str) -> str:
            """Column reference -> record key ('alias.col')."""
            ref = ref.strip()
            if "." in ref:
                q, _, c = ref.partition(".")
                q, c = _unquote(q), _unquote(c)
                if q not in aliases:
                    raise SqlError(f"unknown table alias {q!r}")
                aliases[q].column(c)  # raises on unknown column
                return f"{q}.{c}"
            c = _unquote(ref)
            owners = [a for a, t in aliases.items() if t.has_column(c)]
            if not owners:
                raise SqlError(f"unknown column {c!r}")
            if len(owners) > 1:
                raise SqlError(f"ambiguous column {c!r} (qualify it)")
            return f"{owners[0]}.{c}"

        # projection
        cols = []  # (kind, payload, output name)
        for raw in _split_top_commas(cols_raw):
            raw = raw.strip()
            if raw == "*":
                for a, t in aliases.items():
                    for c in t.columns:
                        cols.append(("col", f"{a}.{c.name}", c.name))
                continue
            am = _AGG_RE.match(raw)
            if am:
                fn = am.group("fn").upper()
                arg = am.group("arg")
                key = None if arg == "*" else resolve(arg)
                if key is None and fn != "COUNT":
                    raise SqlError(f"{fn}(*) is not valid SQL")
                name = _unquote(am.group("alias") or "") or re.sub(
                    r"\s+", "", raw.split(" AS ")[0].split(" as ")[0]
                )
                cols.append(("agg", (fn, key), name))
                continue
            cm = _COL_AS_RE.match(raw)
            if cm is not None:
                try:
                    key = resolve(cm.group("col"))
                except SqlError:
                    cm = None  # literal projection (SELECT 5, NULL, ...)
                if cm is not None:
                    name = (_unquote(cm.group("alias") or "")
                            or key.split(".", 1)[1])
                    cols.append(("col", key, name))
                    continue
            # scalar expression projection (price * 2, COALESCE(a, b), ...)
            expr_raw, alias = _split_expr_alias(raw)
            fn = _ExprParser(expr_raw, resolve, p, check_params).parse()
            name = alias or re.sub(r"\s+", "", expr_raw)
            cols.append(("expr", fn, name))

        # WHERE / HAVING conjunctions (shared grammar; HAVING resolves its
        # left sides per group at execution time, so they stay raw here)
        conds = (self._parse_conds(where_raw, p, resolve, check_params,
                                   ctes=ctes)
                 if where_raw else [])
        having = (self._parse_conds(having_raw, p, resolve, check_params,
                                    defer_lhs=True, ctes=ctes)
                  if having_raw else [])

        # GROUP BY entries: plain columns resolve to record keys, output
        # aliases group by their projected payload (SQLite allows both),
        # anything else groups by a computed expression
        out_names = {name for _k, _p, name in cols}
        by_name = {name: (kind, payload) for kind, payload, name in cols}
        group = []
        if group_raw:
            for g in _split_top_commas(group_raw):
                alias = _unquote(g)
                if alias in by_name:
                    kind, payload = by_name[alias]
                    if kind == "agg":
                        raise SqlError(
                            f"cannot GROUP BY aggregate {alias!r}"
                        )
                    group.append(payload if kind == "col"
                                 else ("\x00expr", payload))
                    continue
                try:
                    group.append(resolve(g))
                except SqlError:
                    group.append(
                        ("\x00expr",
                         _ExprParser(g, resolve, p, check_params).parse())
                    )
        order = []
        if order_raw:
            for part in _split_top_commas(order_raw):
                # strip a trailing ASC/DESC without re-joining tokens —
                # whitespace inside string literals must survive intact
                m_dir = re.search(r"\s+(ASC|DESC)\s*$", part, re.IGNORECASE)
                desc = bool(m_dir) and m_dir.group(1).upper() == "DESC"
                ref = (part[: m_dir.start()] if m_dir else part).strip()
                if re.fullmatch(r"\d+", ref):
                    # SQLite: a bare integer is an output-column ordinal
                    k = int(ref)
                    if not 1 <= k <= len(cols):
                        raise SqlError(
                            f"ORDER BY ordinal {k} out of range"
                        )
                    order.append((cols[k - 1][2], None, desc))
                    continue
                # output aliases and plain columns sort through the row
                # lookup; anything else is an ORDER BY expression
                fn = None
                if _unquote(ref) not in out_names:
                    try:
                        resolve(ref)
                    except SqlError:
                        fn = _ExprParser(ref, resolve, p,
                                         check_params).parse()
                order.append((ref, fn, desc))

        def int_or_param(raw):
            if raw is None:
                return None
            raw = raw.strip()
            if not check_params:
                return 0 if raw in ("?",) or raw.startswith((":", "$")) else int(raw)
            v = _parse_literal(raw, p)
            if not isinstance(v, int) or v < 0:
                raise SqlError(f"LIMIT/OFFSET must be a non-negative int: {raw!r}")
            return v

        return {
            "aliases": aliases, "base": base_alias, "joins": joins,
            "cols": cols, "conds": conds, "having": having, "group": group,
            "order": order,
            "limit": int_or_param(limit_raw),
            "offset": int_or_param(offset_raw),
            "resolve": resolve,
        }

    def _parse_conds(self, raw: str, p: _Params, resolve, check_params,
                     defer_lhs: bool = False, ctes=None) -> List[tuple]:
        """Parse a WHERE/HAVING boolean expression into a cond list.

        Leaves are ``(op, lhs, rhs)`` tuples — comparison operators,
        ``[not] like``/``[not] glob``, ``[not] in`` (literal list or
        subquery), ``json_contains``; an rhs of ``(SELECT ...)`` parses
        into a ``("subq"/"subq_list", ast)`` marker resolved against the
        queried node at execution (``corro-pg``'s sqlparser surface,
        ``crates/corro-pg/src/lib.rs``). The boolean structure rides the
        same shape: a list is an AND-conjunction whose entries may also
        be ``("or", [branch-conds...], None)`` / ``("not", conds, None)``
        nodes, evaluated with SQLite's three-valued logic (NULL-involved
        comparisons are UNKNOWN, excluded at the top level, and NOT
        preserves UNKNOWN rather than flipping it to true)."""
        or_parts = _split_top_kw(raw, "OR")
        if len(or_parts) > 1:
            return [(
                "or",
                [self._parse_conds(part, p, resolve, check_params,
                                   defer_lhs, ctes)
                 for part in or_parts],
                None,
            )]
        conds: List[tuple] = []
        res = (lambda r: r.strip()) if defer_lhs else resolve
        for clause in _split_top_and(raw):
            # NOT <group-or-clause> (but not the NOT of "NOT LIKE"/
            # "NOT IN", which the leaf regexes own)
            nm = re.match(r"NOT\s+(?=\()|NOT\s+(?!LIKE\b|GLOB\b|IN\b)",
                          clause, re.IGNORECASE)
            if nm and not _LIKE_RE.match(clause) and not _IN_RE.match(
                    clause):
                conds.append((
                    "not",
                    self._parse_conds(clause[nm.end():], p, resolve,
                                      check_params, defer_lhs, ctes),
                    None,
                ))
                continue
            # a grouping paren (never a subquery: those appear only as
            # rhs / IN bodies, which the leaf paths below handle)
            if _is_paren_group(clause) and not _SELECT_RE.match(
                    clause[1:-1].strip()):
                conds.extend(
                    self._parse_conds(clause[1:-1], p, resolve,
                                      check_params, defer_lhs, ctes)
                )
                continue
            fm = _FUNC_RE.match(clause)
            if fm:
                needle = (_parse_literal(fm.group("b"), p)
                          if check_params else None)
                conds.append(("json_contains", res(fm.group("a")), needle))
                continue
            lm = _LIKE_RE.match(clause)
            if lm:
                op = (("not " if lm.group("neg") else "")
                      + lm.group("fn").lower())
                conds.append(
                    (op, res(lm.group("col")),
                     self._parse_rhs(lm.group("val"), p, check_params,
                                     ctes))
                )
                continue
            km = _ISNULL_RE.match(clause)
            if km:
                conds.append((
                    "is not null" if km.group("neg") else "is null",
                    res(km.group("col")), None,
                ))
                continue
            im = _IN_RE.match(clause)
            if im:
                op = "not in" if im.group("neg") else "in"
                body = im.group("body").strip()
                if _SELECT_RE.match(body):
                    val = ("subq_list", self._parse_select(
                        body, p, check_params, ctes=ctes))
                else:
                    val = [
                        (_parse_literal(t, p) if check_params else None)
                        for t in _split_top_commas(body)
                    ]
                conds.append((op, res(im.group("col")), val))
                continue
            cm = (_HAVING_COND_RE if defer_lhs else _COND_RE).match(clause)
            if cm is not None:
                conds.append(
                    (cm.group("op"), res(cm.group("col")),
                     self._parse_rhs(cm.group("val"), p, check_params,
                                     ctes))
                )
                continue
            # expression left side: WHERE a + b > 5, LENGTH(name) = 3 ...
            em = _HAVING_COND_RE.match(clause)
            if em is not None and not defer_lhs:
                fn = _ExprParser(em.group("col"), resolve, p,
                                 check_params).parse()
                conds.append(
                    (em.group("op"), ("\x00expr", fn),
                     self._parse_rhs(em.group("val"), p, check_params,
                                     ctes))
                )
                continue
            raise SqlError(
                f"unsupported WHERE/HAVING clause: {clause!r}"
            )
        return conds

    def _parse_rhs(self, raw: str, p: _Params, check_params, ctes=None):
        raw = raw.strip()
        if (raw.startswith("(") and raw.endswith(")")
                and _SELECT_RE.match(raw[1:-1].strip())):
            return ("subq", self._parse_select(
                raw[1:-1].strip(), p, check_params, ctes=ctes))
        return _parse_literal(raw, p) if check_params else None

    # --- SELECT execution -------------------------------------------------
    def _table_records(self, node: int, table, alias: str, vals, clps,
                       cte_memo=None, overlay=None):
        """All live rows of one table as {'alias.col': value} dicts.
        A CTE materializes its sub-select against the same node ONCE
        per top-level execution (``cte_memo``): chained/self-joined CTE
        references reuse the rows, matching SQLite's materialization.
        ``overlay`` (tx-pending cells) flows into CTE bodies so an
        ``INSERT ... WITH ... SELECT`` inside a transaction sees earlier
        statements, same as the plain-select form."""
        if isinstance(table, _DualTable):
            return [{}]  # one empty record: constant projections emit once
        if isinstance(table, _RecursiveCte):
            names = [c.name for c in table.columns]
            memo = cte_memo if cte_memo is not None else {}
            key = (node, id(table))
            if key not in memo:
                memo[key] = self._run_recursive_cte(node, table, memo,
                                                    overlay=overlay)
            return [
                {f"{alias}.{k}": v for k, v in zip(names, row)}
                for row in memo[key]
            ]
        if isinstance(table, _CteTable):
            names = [c.name for c in table.columns]
            memo = cte_memo if cte_memo is not None else {}
            key = (node, id(table.ast))
            if key not in memo:
                if not isinstance(table.ast, dict):
                    # the bare self-reference marker outside a seeded
                    # recursive evaluation (e.g. referenced from a
                    # subquery, which runs with a fresh memo)
                    raise SqlError(
                        f"recursive reference to {table.name!r} is only "
                        f"supported in the step's FROM/JOIN"
                    )
                memo[key] = list(
                    self._run_select(node, table.ast, cte_memo=memo,
                                     overlay=overlay)
                )
            return [
                {f"{alias}.{k}": v for k, v in zip(names, row)}
                for row in memo[key]
            ]
        out = []
        for pk, row in self.rows.rows_of(table.name):
            if int(vals[self._cell(row, CL_COL)]) % 2 == 0:
                continue
            rec = self._materialize(table, pk, vals, clps, row)
            out.append({f"{alias}.{k}": v for k, v in rec.items()})
        return out

    def _resolve_subqueries(self, node: int, conds: List[tuple]) -> List[tuple]:
        """Materialize ``("subq"/"subq_list", ast)`` rhs markers against
        ``node``'s replica: scalar = first row's first column (None when
        empty, like SQLite), list = every row's first column."""
        out = []
        for op, lhs, val in conds:
            if op == "or":
                lhs = [self._resolve_subqueries(node, b) for b in lhs]
            elif op == "not":
                lhs = self._resolve_subqueries(node, lhs)
            elif (isinstance(val, tuple) and len(val) == 2
                    and val[0] in ("subq", "subq_list")):
                rows = list(self._run_select(node, val[1]))
                if val[0] == "subq":
                    val = rows[0][0] if rows else None
                else:
                    val = [r[0] for r in rows]
            out.append((op, lhs, val))
        return out

    def _run_select(self, node: int, ast,
                    cte_memo=None, overlay=None) -> Iterable[List[Any]]:
        if cte_memo is None:
            cte_memo = {}
        ast = {
            **ast,
            "conds": self._resolve_subqueries(node, ast["conds"]),
            "having": self._resolve_subqueries(node, ast.get("having", [])),
        }
        snap = self.agent.snapshot()
        vals = snap["store"][1][node]
        clps = snap["store"][4][node]
        if overlay:
            # transaction-local pending cells (INSERT ... SELECT inside
            # a multi-statement tx must see earlier statements' writes,
            # like every other write path); nested subqueries still read
            # the committed store. Patched planes are memoized per
            # (node, overlay) so a recursive CTE's per-iteration
            # re-entry doesn't re-copy the full planes every time.
            memo_key = ("__overlay__", node, id(overlay))
            patched = cte_memo.get(memo_key)
            if patched is None:
                import numpy as np

                vals = np.array(vals)
                clps = np.array(clps)
                for cell, (v, lf) in overlay.items():
                    vals[cell] = v
                    clps[cell] = lf
                cte_memo[memo_key] = (vals, clps)
            else:
                vals, clps = patched
        aliases = ast["aliases"]
        has_agg = any(k == "agg" for k, _, _ in ast["cols"])
        if (not ast["joins"] and not ast["group"] and not ast["order"]
                and not has_agg and not ast["having"]
                and not isinstance(aliases[ast["base"]], _CteTable)):
            # streaming fast path: plain filtered scan short-circuits at
            # LIMIT without materializing the table (the /v1/queries
            # NDJSON stream shape); CTE bases always materialize
            yield from self._stream_select(node, ast, vals, clps)
            return
        records = self._table_records(
            node, aliases[ast["base"]], ast["base"], vals, clps,
            cte_memo=cte_memo, overlay=overlay,
        )
        # hash equi-joins, in declaration order
        for jtype, a, lref, rref in ast["joins"]:
            lkey, rkey = ast["resolve"](lref), ast["resolve"](rref)
            # probe side = the newly joined table's rows
            right = self._table_records(node, aliases[a], a, vals, clps,
                                        cte_memo=cte_memo, overlay=overlay)
            probe_key = rkey if rkey.startswith(f"{a}.") else lkey
            build_key = lkey if probe_key == rkey else rkey
            if not probe_key.startswith(f"{a}."):
                raise SqlError(
                    f"JOIN ON must reference the joined table {a!r}"
                )
            index: Dict[Any, List[dict]] = {}
            for r in right:
                if r[probe_key] is not None:  # SQL: NULL = NULL is not true
                    index.setdefault(r[probe_key], []).append(r)
            joined = []
            for rec in records:
                bkey = rec.get(build_key)
                matches = index.get(bkey, []) if bkey is not None else []
                if matches:
                    for mrec in matches:
                        joined.append({**rec, **mrec})
                elif jtype == "left":
                    joined.append(
                        {**rec, **{f"{a}.{c.name}": None
                                   for c in aliases[a].columns}}
                    )
            records = joined
        # WHERE
        records = [
            r for r in records
            if all(self._eval(c, r) for c in ast["conds"])
        ]
        # GROUP BY / aggregates / HAVING
        if ast["group"] or has_agg or ast["having"]:
            groups: Dict[tuple, List[dict]] = {}
            for r in records:
                gkey = tuple(
                    g[1](r) if isinstance(g, tuple) and g[0] == "\x00expr"
                    else r.get(g)
                    for g in ast["group"]
                )
                groups.setdefault(gkey, []).append(r)
            if not records and not ast["group"]:
                groups[()] = []  # aggregates over an empty table emit 1 row
            rows = []
            for gkey, grp in groups.items():
                out = {}
                for kind, payload, name in ast["cols"]:
                    if kind == "col":
                        out[name] = grp[0].get(payload) if grp else None
                    elif kind == "expr":
                        out[name] = payload(grp[0]) if grp else None
                    else:
                        out[name] = self._aggregate(payload, grp)
                if not self._having_ok(ast, out, grp):
                    continue
                # representative source row: lets ORDER BY evaluate the
                # grouping expression (constant within a group) or a
                # grouped input column, like SQLite
                out["\x00src"] = grp[0] if grp else None
                rows.append(out)
        else:
            rows = [
                {
                    name: (payload(r) if kind == "expr" else r.get(payload))
                    for kind, payload, name in ast["cols"]
                }
                for r in records
            ]
            # keep source record reachable for ORDER BY non-projected cols
            for out, src in zip(rows, records):
                out["\x00src"] = src
        # ORDER BY: output alias first, then projected source column,
        # then (non-aggregate queries) any input column
        by_payload = {
            payload: name for kind, payload, name in ast["cols"]
            if kind == "col"
        }
        for ref, fn, desc in reversed(ast["order"]):
            name = _unquote(ref)

            def key_of(row, name=name, ref=ref, fn=fn):
                if name in row:
                    v = row[name]
                elif fn is not None:
                    src = row.get("\x00src")
                    # src is None only for the empty-aggregate row
                    v = fn(src) if src is not None else None
                else:
                    key = ast["resolve"](ref)
                    if key in by_payload:
                        v = row[by_payload[key]]
                    else:
                        src = row.get("\x00src")
                        if src is None:
                            raise SqlError(f"cannot ORDER BY {ref!r} here")
                        v = src.get(key)
                # SQLite: NULLs sort first ASC; type-tag mixed values
                return (v is not None, isinstance(v, (bytes, str)), v)

            rows.sort(key=key_of, reverse=desc)
        off = ast["offset"] or 0
        if off:
            rows = rows[off:]
        if ast["limit"] is not None:
            rows = rows[:ast["limit"]]
        names = [c[2] for c in ast["cols"]]
        for row in rows:
            yield [row[n] for n in names]

    def _stream_select(self, node: int, ast, vals, clps):
        """Lazy single-table scan: filter, offset, project, stop at
        LIMIT — the early-exit path the bounded read APIs rely on."""
        alias = ast["base"]
        table = ast["aliases"][alias]
        emitted, skipped = 0, 0
        off = ast["offset"] or 0
        for pk, row in self.rows.rows_of(table.name):
            if int(vals[self._cell(row, CL_COL)]) % 2 == 0:
                continue
            rec = self._materialize(table, pk, vals, clps, row)
            rec = {f"{alias}.{k}": v for k, v in rec.items()}
            if not all(self._eval(c, rec) for c in ast["conds"]):
                continue
            if skipped < off:
                skipped += 1
                continue
            yield [
                payload(rec) if kind == "expr" else rec.get(payload)
                for kind, payload, _n in ast["cols"]
            ]
            emitted += 1
            if ast["limit"] is not None and emitted >= ast["limit"]:
                return

    def _having_ok(self, ast, out: dict, grp: List[dict]) -> bool:
        """Evaluate HAVING conditions on one group. A left side may be an
        aggregate expression (``COUNT(*) > 5``), an output alias, or a
        grouped input column; the boolean structure (AND lists with
        or/not nodes) evaluates with the same three-valued logic as
        WHERE."""

        def eval_one(cond):
            op, lhs, val = cond
            if op == "or":
                acc = False
                for branch in lhs:
                    r = eval_conj(branch)
                    if r is True:
                        return True
                    if r is None:
                        acc = None
                return acc
            if op == "not":
                r = eval_conj(lhs)
                return None if r is None else not r
            if not isinstance(lhs, str):
                # a parsed expression node (('\x00expr', fn) tuple) —
                # arbitrary expressions aren't supported on a HAVING
                # left side; fail as a SqlError, not a TypeError
                raise SqlError("unsupported HAVING left side (expression)")
            am = _AGG_RE.match(lhs)
            if am:
                fn = am.group("fn").upper()
                arg = am.group("arg")
                key = None if arg == "*" else ast["resolve"](arg)
                v = self._aggregate((fn, key), grp)
            else:
                name = _unquote(lhs)
                if name in out:
                    v = out[name]
                else:
                    v = grp[0].get(ast["resolve"](lhs)) if grp else None
            return self._eval((op, "\x00v", val), {"\x00v": v})

        def eval_conj(conds):
            acc = True
            for c in conds:
                r = eval_one(c)
                if r is False:
                    return False
                if r is None:
                    acc = None
            return acc

        return eval_conj(ast.get("having", [])) is True

    @staticmethod
    def _aggregate(payload, grp: List[dict]):
        fn, key = payload
        vals = ([r.get(key) for r in grp if r.get(key) is not None]
                if key is not None else grp)
        if fn == "COUNT":
            return len(vals)
        if not vals:
            return 0.0 if fn == "TOTAL" else None
        if fn == "SUM":
            return sum(vals)
        if fn == "TOTAL":
            return float(sum(vals))
        if fn == "MIN":
            return min(vals)
        if fn == "MAX":
            return max(vals)
        if fn == "AVG":
            return sum(vals) / len(vals)
        raise SqlError(f"unknown aggregate {fn}")

    def _run_recursive_cte(self, node: int, cte: _RecursiveCte,
                           memo: dict, overlay=None) -> List[list]:
        """Iterative evaluation: rows = base; repeat step (which sees
        only the previous iteration's rows through the pre-seeded memo
        slot) until no new rows, the total LIMIT (+OFFSET skip, SQLite
        compound semantics), or the safety cap."""
        off = cte.offset or 0
        cap = (cte.limit + off) if cte.limit is not None else cte.MAX_ROWS
        rows = list(self._run_select(node, cte.base_ast, cte_memo=memo,
                                     overlay=overlay))
        frontier = rows
        self_key = (node, id(cte.self_marker))
        if not cte.self_referential:
            rows.extend(self._run_select(node, cte.step_ast,
                                         cte_memo=memo, overlay=overlay))
            return rows[off:cap]
        while frontier and len(rows) < cap:
            # overwrite the self-ref slot: the step sees ONLY the
            # previous iteration's rows (other CTEs stay memoized once)
            memo[self_key] = frontier
            frontier = list(
                self._run_select(node, cte.step_ast, cte_memo=memo,
                                 overlay=overlay)
            )
            rows.extend(frontier)
            if cte.limit is None and len(rows) > cte.MAX_ROWS:
                raise SqlError(
                    f"recursive CTE {cte.name!r} exceeded "
                    f"{cte.MAX_ROWS} rows without a LIMIT"
                )
        return rows[off:cap]

    def _materialize(self, table, pk, vals, clps, row) -> Dict[str, Any]:
        """A row's visible values: a cell counts only if it was written in
        the row's CURRENT causal-length lifetime — values from before a
        delete/resurrect cycle read as NULL, matching SQLite's fresh-row
        semantics (cr-sqlite `cl`, doc/crdts.md:24-40)."""
        row_cl = int(vals[self._cell(row, CL_COL)])
        rec = {table.pk.name: pk}
        for c in table.value_columns:
            cell = self._cell(row, table.col_index(c.name))
            if int(clps[cell]) == row_cl:
                rec[c.name] = self.heap.lookup(int(vals[cell]))
            else:
                rec[c.name] = None
        return rec

    def read_row(self, node: int, table_name: str, pk: Any
                 ) -> Optional[Dict[str, Any]]:
        """One row of ``node``'s replica, or None if absent/deleted."""
        table = self.schema.table(table_name)
        row = self.rows.get(table_name, pk)
        if row is None:
            return None
        snap = self.agent.snapshot()
        vals = snap["store"][1][node]
        clps = snap["store"][4][node]
        if int(vals[self._cell(row, CL_COL)]) % 2 == 0:
            return None
        return self._materialize(table, pk, vals, clps, row)

    @classmethod
    def _eval_conj(cls, conds, rec):
        """Three-valued AND over a cond list: False dominates, then
        UNKNOWN (None), then True. ``all(_eval(...))`` at the callers
        treats UNKNOWN as falsy — SQL's WHERE-excludes-unknown."""
        out = True
        for c in conds:
            r = cls._eval(c, rec)
            if r is False:
                return False
            if r is None:
                out = None
        return out

    @classmethod
    def _eval(cls, cond, rec):
        """Evaluate one cond to SQLite's three-valued logic:
        True / False / None (UNKNOWN — a NULL-involved comparison).
        Callers gate rows on ``is True``-like truthiness, so UNKNOWN
        excludes; NOT preserves UNKNOWN instead of flipping it."""
        op, col, ref = cond
        if op == "or":
            out = False
            for branch in col:
                r = cls._eval_conj(branch, rec)
                if r is True:
                    return True
                if r is None:
                    out = None
            return out
        if op == "not":
            r = cls._eval_conj(col, rec)
            return None if r is None else not r
        if isinstance(col, tuple) and col and col[0] == "\x00expr":
            v = col[1](rec)
        else:
            v = rec.get(col)
        if op == "is null":
            return v is None  # never UNKNOWN: IS is a 2-valued test
        if op == "is not null":
            return v is not None
        if op == "json_contains":
            try:
                return corro_json_contains(v, ref)
            except (TypeError, ValueError):
                return False
        if op in ("like", "not like", "glob", "not glob"):
            # SQLite coerces numeric operands to text for LIKE/GLOB
            # (SELECT 15 LIKE '1%' -> 1); NULL operands -> UNKNOWN
            if v is None or ref is None:
                return None
            if isinstance(v, (int, float)):
                v = str(v)
            if isinstance(ref, (int, float)):
                ref = str(ref)
            if not isinstance(v, str) or not isinstance(ref, str):
                return False  # blobs never LIKE-match
            glob = "glob" in op
            if not glob:  # ASCII-only case folding, like SQLite's LIKE
                v = v.translate(_ASCII_LOWER)
                ref = ref.translate(_ASCII_LOWER)
            hit = _like_to_regex(ref, glob).match(v) is not None
            return (not hit) if op.startswith("not") else hit
        if op in ("in", "not in"):
            if v is None:
                return None
            hit = any(v == x for x in ref if x is not None)
            if op == "not in":
                # x NOT IN (..., NULL) is UNKNOWN unless x matched a
                # non-NULL member
                if hit:
                    return False
                return None if any(x is None for x in ref) else True
            if not hit and any(x is None for x in ref):
                return None  # x IN (..., NULL) with no match is UNKNOWN
            return hit
        if v is None or ref is None:
            return None
        try:
            if op == "=":
                return v == ref
            if op in ("!=", "<>"):
                return v != ref
            if op == "<":
                return v < ref
            if op == "<=":
                return v <= ref
            if op == ">":
                return v > ref
            if op == ">=":
                return v >= ref
        except TypeError:
            return False
        raise SqlError(f"unsupported operator {op!r}")

    # --- stats & checkpoint ----------------------------------------------
    def table_stats(self, node: int = 0) -> Dict[str, Dict[str, int]]:
        """``/v1/table_stats`` analog: row counts per table on ``node``."""
        snap = self.agent.snapshot()
        vals = snap["store"][1][node]
        out: Dict[str, Dict[str, int]] = {}
        for name in self.schema.tables:
            rows = self.rows.rows_of(name)
            live = sum(
                1 for _, r in rows
                if int(vals[self._cell(r, CL_COL)]) % 2 == 1
            )
            out[name] = {"allocated": len(rows), "live": live}
        return out

    def schema_sql(self) -> str:
        parts = []
        for t in self.schema.tables.values():
            cols = []
            for c in t.columns:
                bits = [c.name, c.sql_type]
                if c.primary_key:
                    bits.append("PRIMARY KEY")
                elif c.not_null:
                    bits.append("NOT NULL")
                if c.default is not None:
                    d = (f"'{c.default}'" if isinstance(c.default, str)
                         else str(c.default))
                    bits.append(f"DEFAULT {d}")
                cols.append(" ".join(bits))
            parts.append(f"CREATE TABLE {t.name} ({', '.join(cols)});")
        return "\n".join(parts)

    def state_dict(self) -> dict:
        return {
            "schema_sql": self.schema_sql(),
            "heap": self.heap.state_dict(),
            "rows": self.rows.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        with self._mu:
            self.schema = parse_schema_sql(state["schema_sql"])
            self.heap = ValueHeap.from_state_dict(state["heap"])
            self.rows = RowMap.from_state_dict(state["rows"])


class StagedTx:
    """A buffered multi-statement transaction (PG ``BEGIN``/``COMMIT``).

    Statements are planned eagerly — ``execute()`` runs the same
    ``_plan_write`` path as :meth:`Database.execute`, against a
    transaction-local overlay, so each statement's row count is exact
    and later statements observe earlier writes. Nothing is visible to
    the cluster (or to reads outside the tx) until :meth:`commit`
    stages the net cell writes into one round-loop transaction;
    :meth:`rollback` discards everything. Mirrors the reference's PG
    server running real SQLite txs over the corrosion write path
    (``corro-pg/src/lib.rs``)."""

    def __init__(self, db: Database, node: int):
        self.db = db
        self.node = node
        self._merged: Dict[int, Tuple[int, int]] = {}
        self._notes: List[tuple] = []
        self._results: List[ExecResult] = []
        self._done = False
        with db._mu:  # pin planned value ids vs compaction
            db._open_txs.add(self)

    def execute(self, sql: str, params: Any = None) -> ExecResult:
        if self._done:
            raise SqlError("transaction already finished")
        t0 = time.perf_counter()
        affected, cells, notes = self.db._plan_write(
            self.node, sql, params, self._merged
        )
        self._merged.update({c: (v, l) for c, v, l in cells})
        self._notes.extend(notes)
        res = ExecResult(rows_affected=affected,
                         time=time.perf_counter() - t0)
        self._results.append(res)
        return res

    def commit(self, wait: bool = True, timeout: float = 30.0
               ) -> List[ExecResult]:
        if self._done:
            raise SqlError("transaction already finished")
        self._done = True
        with self.db._mu:
            self.db._open_txs.discard(self)
        cells = self.db._order_tx_cells(self._merged)
        if cells:
            self.db.agent.write_many(self.node, cells, wait=wait,
                                     timeout=timeout)
        self.db._stamp_writes(self._notes)
        with self.db._mu:
            hooks = list(self.db._write_hooks)
        for note in self._notes:
            for hook in hooks:
                hook(self.node, *note)
        return self._results

    def rollback(self) -> None:
        self._done = True
        with self.db._mu:
            self.db._open_txs.discard(self)
        self._merged.clear()
        self._notes.clear()
