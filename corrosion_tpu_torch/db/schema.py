"""Schema management: parse CREATE TABLE SQL, diff, apply onto the grid.

Mirrors the reference's ``crates/corro-types/src/schema.rs``: schema files
are parsed into a ``Schema`` (``parse_sql``, ``schema.rs:747``), diffed
against the current one and applied non-destructively (``apply_schema``,
``schema.rs:287``), with the same constraint posture — every table needs a
primary key, unique indexes are forbidden, destructive changes (dropping
tables/columns, changing types) are rejected (``schema.rs:113-200``).

Grid mapping (TPU reframing of ``crsql_as_crr``): each table's rows live
anywhere in the simulator's ``[n_rows, n_cols]`` cell grid via a
host-global row map (``RowMap``); column 0 of every row is the
causal-length register ``cl`` — odd = live, even = deleted — exactly
cr-sqlite's delete tracking (``doc/crdts.md:24-40``); user columns occupy
cols 1..n_cols-1 in declaration order.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

CL_COL = 0  # causal-length register column (cr-sqlite `cl`)

_TYPE_ALIASES = {
    "INT": "INTEGER",
    "INTEGER": "INTEGER",
    "BIGINT": "INTEGER",
    "SMALLINT": "INTEGER",
    "TEXT": "TEXT",
    "VARCHAR": "TEXT",
    "CHAR": "TEXT",
    "REAL": "REAL",
    "FLOAT": "REAL",
    "DOUBLE": "REAL",
    "BLOB": "BLOB",
    "ANY": "ANY",
    "BOOLEAN": "INTEGER",
}


class SchemaError(ValueError):
    """Constraint violation or unsupported schema construct."""


@dataclass(frozen=True)
class Column:
    name: str
    sql_type: str
    primary_key: bool = False
    not_null: bool = False
    default: Optional[object] = None


@dataclass
class Table:
    name: str
    columns: List[Column]

    @property
    def pk(self) -> Column:
        return next(c for c in self.columns if c.primary_key)

    @property
    def value_columns(self) -> List[Column]:
        return [c for c in self.columns if not c.primary_key]

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise SchemaError(f"no such column: {self.name}.{name}")

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def col_index(self, name: str) -> int:
        """Grid column for a value column (pk is implicit in the row map)."""
        idx = CL_COL + 1
        for c in self.columns:
            if c.primary_key:
                continue
            if c.name == name:
                return idx
            idx += 1
        raise SchemaError(f"no such column: {self.name}.{name}")


@dataclass
class Schema:
    tables: Dict[str, Table] = field(default_factory=dict)

    def table(self, name: str) -> Table:
        t = self.tables.get(name)
        if t is None:
            raise SchemaError(f"no such table: {name}")
        return t


# --- SQL parsing ---------------------------------------------------------

_CREATE_RE = re.compile(
    r"CREATE\s+TABLE\s+(?:IF\s+NOT\s+EXISTS\s+)?"
    r"(?P<name>[\w\"]+)\s*\((?P<body>.*?)\)\s*(?:;|$)",
    re.IGNORECASE | re.DOTALL,
)
_INDEX_RE = re.compile(
    r"CREATE\s+(?P<unique>UNIQUE\s+)?INDEX\b", re.IGNORECASE
)


def _split_commas(body: str) -> List[str]:
    """Split on top-level commas (respecting parens and quotes)."""
    parts, depth, start, i = [], 0, 0, 0
    in_str: Optional[str] = None
    while i < len(body):
        ch = body[i]
        if in_str:
            if ch == in_str:
                in_str = None
        elif ch in "'\"":
            in_str = ch
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
        i += 1
    parts.append(body[start:])
    return [p.strip() for p in parts if p.strip()]


def _unquote(ident: str) -> str:
    return ident.strip().strip('"').strip("`")


def _parse_default(tokens: List[str]) -> object:
    raw = tokens[0] if tokens else "NULL"
    if raw.upper() == "NULL":
        return None
    if raw.startswith("'") and raw.endswith("'"):
        return raw[1:-1]
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            raise SchemaError(f"unsupported DEFAULT expression: {raw!r}")


def _parse_column(defn: str, table: str) -> Column:
    tokens = defn.split()
    name = _unquote(tokens[0])
    if len(tokens) < 2:
        raise SchemaError(f"column {table}.{name} needs a type")
    sql_type = _TYPE_ALIASES.get(tokens[1].split("(")[0].upper())
    if sql_type is None:
        raise SchemaError(f"unsupported type {tokens[1]!r} for {table}.{name}")
    rest = " ".join(tokens[2:]).upper()
    primary_key = "PRIMARY KEY" in rest
    not_null = "NOT NULL" in rest or primary_key
    default = None
    m = re.search(r"DEFAULT\s+(\S+)", " ".join(tokens[2:]), re.IGNORECASE)
    if m:
        default = _parse_default([m.group(1)])
    if "UNIQUE" in rest and not primary_key:
        # same posture as the reference: unique constraints other than the
        # pk break CRDT merge (schema.rs:113-200)
        raise SchemaError(
            f"UNIQUE constraint on {table}.{name} is not allowed on CRR tables"
        )
    if "AUTOINCREMENT" in rest:
        raise SchemaError(f"AUTOINCREMENT not allowed on CRR table {table}")
    return Column(name, sql_type, primary_key, not_null, default)


def parse_schema_sql(sql: str) -> Schema:
    """Parse a schema file's CREATE TABLE statements into a ``Schema``."""
    if _INDEX_RE.search(sql) and any(
        m.group("unique") for m in _INDEX_RE.finditer(sql)
    ):
        raise SchemaError("unique indexes are not allowed on CRR tables")
    schema = Schema()
    for m in _CREATE_RE.finditer(sql):
        name = _unquote(m.group("name"))
        columns: List[Column] = []
        table_pk: List[str] = []
        for defn in _split_commas(m.group("body")):
            upper = defn.upper()
            if upper.startswith("PRIMARY KEY"):
                inner = defn[defn.index("(") + 1 : defn.rindex(")")]
                table_pk = [_unquote(c) for c in inner.split(",")]
                continue
            if upper.startswith(("UNIQUE", "CHECK", "FOREIGN KEY", "CONSTRAINT")):
                raise SchemaError(
                    f"table constraint not allowed on CRR table {name}: {defn!r}"
                )
            columns.append(_parse_column(defn, name))
        if table_pk:
            if len(table_pk) != 1:
                raise SchemaError(
                    f"composite primary keys are not supported (table {name})"
                )
            columns = [
                Column(c.name, c.sql_type, c.name == table_pk[0],
                       c.not_null or c.name == table_pk[0], c.default)
                for c in columns
            ]
        pks = [c for c in columns if c.primary_key]
        if len(pks) != 1:
            raise SchemaError(
                f"table {name} must have exactly one primary key column "
                f"(found {len(pks)}) — required for CRR conversion"
            )
        if name in schema.tables:
            raise SchemaError(f"duplicate table {name}")
        schema.tables[name] = Table(name, columns)
    return schema


# --- diff & apply --------------------------------------------------------

def diff_schemas(old: Schema, new: Schema) -> List[Tuple[str, str]]:
    """List of (kind, detail) changes; raises on destructive ones
    (``apply_schema`` posture, ``schema.rs:287-360``)."""
    changes: List[Tuple[str, str]] = []
    for name in old.tables:
        if name not in new.tables:
            raise SchemaError(f"cannot drop table {name} (destructive)")
    for name, table in new.tables.items():
        if name not in old.tables:
            changes.append(("create_table", name))
            continue
        old_t = old.tables[name]
        old_cols = {c.name: c for c in old_t.columns}
        for c in old_t.columns:
            if c.name not in {x.name for x in table.columns}:
                raise SchemaError(f"cannot drop column {name}.{c.name}")
        for i, c in enumerate(table.columns):
            prev = old_cols.get(c.name)
            if prev is None:
                if i < len(old_t.columns):
                    raise SchemaError(
                        f"new column {name}.{c.name} must be appended last"
                    )
                if c.primary_key:
                    raise SchemaError(f"cannot add pk column {name}.{c.name}")
                changes.append(("add_column", f"{name}.{c.name}"))
            elif (prev.sql_type, prev.primary_key) != (c.sql_type, c.primary_key):
                raise SchemaError(f"cannot alter column {name}.{c.name}")
    return changes


class RowMap:
    """Host-global (table, pk) -> grid row allocator, shared by all
    simulated nodes. Append-only: rows are never reclaimed (deletes are
    causal-length tombstones, like cr-sqlite)."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self._rows: Dict[Tuple[str, object], int] = {}
        self._by_table: Dict[str, List[Tuple[object, int]]] = {}
        self._by_row: Dict[int, Tuple[str, object]] = {}
        self._next = 0
        self._mu = threading.Lock()

    def get(self, table: str, pk: object) -> Optional[int]:
        return self._rows.get((table, pk))

    def get_or_alloc(self, table: str, pk: object) -> int:
        with self._mu:
            row = self._rows.get((table, pk))
            if row is None:
                if self._next >= self.n_rows:
                    raise SchemaError(
                        f"grid row capacity exhausted ({self.n_rows}); raise "
                        f"[sim].n_rows"
                    )
                row = self._next
                self._next += 1
                self._rows[(table, pk)] = row
                self._by_table.setdefault(table, []).append((pk, row))
                self._by_row[row] = (table, pk)
            return row

    def table_pk_of(self, row: int) -> Optional[Tuple[str, object]]:
        """Reverse lookup: grid row -> (table, pk). Used by the
        incremental subscription matcher to turn applied cell deltas
        into candidate pks (the ``match_changes`` seam,
        ``pubsub.rs:527-1100``)."""
        with self._mu:
            return self._by_row.get(row)

    def rows_of(self, table: str) -> List[Tuple[object, int]]:
        with self._mu:
            return list(self._by_table.get(table, ()))

    def __len__(self) -> int:
        return self._next

    def state_dict(self) -> dict:
        def enc(pk):
            if isinstance(pk, bytes):
                return ["b", pk.hex()]
            if isinstance(pk, float):
                return ["r", pk]
            if isinstance(pk, int):
                return ["i", pk]
            return ["t", pk]

        return {
            "n_rows": self.n_rows,
            "rows": [[t, enc(pk), row] for (t, pk), row in self._rows.items()],
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "RowMap":
        rm = cls(state["n_rows"])

        def dec(e):
            tag, raw = e
            if tag == "b":
                return bytes.fromhex(raw)
            if tag == "r":
                return float(raw)
            if tag == "i":
                return int(raw)
            return raw

        for t, pk_enc, row in sorted(state["rows"], key=lambda x: x[2]):
            got = rm.get_or_alloc(t, dec(pk_enc))
            if got != row:
                raise SchemaError(
                    f"row map restore out of order: expected row {row}, "
                    f"allocated {got}"
                )
        return rm
