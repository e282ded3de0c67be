"""DB layer: schema management, value storage, SQL statement execution.

Plays the role of the reference's layer 1 (``crates/corro-types/src/
{schema,sqlite}.rs`` + ``sqlite-pool`` + the SQLite file itself) on top of
the TPU-resident LWW store: named tables/columns are mapped onto the
simulator's ``[N, n_rows, n_cols]`` cell grid, values live in a host-side
interned heap (the device gossips compact int32 ids), and a small SQL
dialect covers the reference's write/read statement surface.
"""

from corrosion_tpu_torch.db.database import Database
from corrosion_tpu_torch.db.schema import Schema, SchemaError, parse_schema_sql
from corrosion_tpu_torch.db.values import NULL_ID, ValueHeap

__all__ = [
    "Database",
    "Schema",
    "SchemaError",
    "parse_schema_sql",
    "ValueHeap",
    "NULL_ID",
]
