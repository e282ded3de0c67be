"""Interned value heap: SQL values <-> compact int32 ids.

The reference's CRDT cells hold arbitrary SQL values (``SqliteValue``,
``crates/corro-api-types/src/lib.rs:422-433``). The TPU store holds int32
planes — so the host keeps an append-only interning heap mapping every
distinct value (NULL, integer, real, text, blob) to a stable id, and the
device gossips ids. The heap is process-global state shared by all
simulated nodes (one process hosts the whole cluster), so id assignment
is trivially consistent across replicas.

Deviation from the reference, by design: the LWW tie-break on equal
``col_version`` orders by *intern id* (assignment order) rather than by
serialized value bytes (``doc/crdts.md:14-16``). Both are deterministic
total orders; parity checks against the CPU oracle use the same heap, so
convergence results are unaffected.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Optional

NULL_ID = 0

# type tags for serialization
_T_NULL, _T_INT, _T_REAL, _T_TEXT, _T_BLOB = "n", "i", "r", "t", "b"
_T_FREE = "f"  # compacted hole (id awaiting reuse)


class _Free:
    """Sentinel marking a compacted heap slot."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debugging aid
        return "<freed>"


_FREE = _Free()


def _key(value: Any):
    """Hashable identity key: 1 and 1.0 intern separately (SQL types)."""
    if value is None:
        return (_T_NULL,)
    if isinstance(value, bool):  # bools are ints in SQLite
        return (_T_INT, int(value))
    if isinstance(value, int):
        return (_T_INT, value)
    if isinstance(value, float):
        return (_T_REAL, value)
    if isinstance(value, str):
        return (_T_TEXT, value)
    if isinstance(value, (bytes, bytearray)):
        return (_T_BLOB, bytes(value))
    raise TypeError(f"unsupported SQL value type: {type(value).__name__}")


class ValueHeap:
    """Thread-safe value interning table with compaction. Id 0 is NULL.

    Ids are STABLE for the lifetime of their value: :meth:`compact`
    (the ``vacuum_db`` analog, ``handlers.rs:398-452``) never remaps —
    it frees ids no longer referenced anywhere (device store planes,
    in-flight queue/partial buffers) onto a free list that later
    :meth:`intern` calls reuse, so device state is never rewritten."""

    def __init__(self):
        self._values: list = [None]
        self._ids: dict = {(_T_NULL,): NULL_ID}
        self._free: list = []  # compacted ids awaiting reuse (LIFO)
        self._touch: dict = {}  # vid -> monotonic ts of last intern()
        self._freed_total = 0
        self._mu = threading.Lock()

    def intern(self, value: Any) -> int:
        k = _key(value)
        with self._mu:
            vid = self._ids.get(k)
            if vid is None:
                if self._free:
                    vid = self._free.pop()
                    self._values[vid] = (
                        bytes(value) if isinstance(value, bytearray)
                        else value
                    )
                else:
                    vid = len(self._values)
                    if vid >= (1 << 31):
                        raise OverflowError(
                            "value heap exceeded int32 id space")
                    self._values.append(
                        bytes(value) if isinstance(value, bytearray)
                        else value
                    )
                self._ids[k] = vid
            self._touch[vid] = time.monotonic()
            return vid

    def lookup(self, vid: int) -> Any:
        if vid == NULL_ID:
            return None
        v = self._values[vid]
        if v is _FREE:
            raise LookupError(
                f"value id {vid} was compacted away (heap corruption or "
                f"a reference the compaction scan missed)"
            )
        # refresh the grace clock on READ too (GIL-atomic dict write).
        # Honest contract: this protects ids a reader RE-dereferences;
        # an id a stale snapshot has not read yet is protected only by
        # the grace window itself — a streaming consumer iterating a
        # snapshot older than grace_seconds can hit a loud LookupError
        # (never silent reuse inside the window). Size grace_seconds
        # above the longest expected reader.
        self._touch[vid] = time.monotonic()  # corrolint: disable=unlocked-mutation -- deliberate GIL-atomic dict write; taking _mu here would serialize every read (see contract above)
        return v

    def __len__(self) -> int:
        return len(self._values)

    @property
    def live_count(self) -> int:
        """Interned values currently reachable (len minus free slots)."""
        with self._mu:
            return len(self._values) - len(self._free)

    @property
    def freed_total(self) -> int:
        return self._freed_total

    def compact(self, referenced, grace_seconds: float = 300.0) -> int:
        """Free every id not in ``referenced`` and not interned within
        the last ``grace_seconds`` (a write planned on the host may not
        have reached device state yet — the grace window keeps its id
        alive until it does). Returns the number of ids freed."""
        cutoff = time.monotonic() - grace_seconds
        referenced = set(int(r) for r in referenced)
        freed = 0
        with self._mu:
            for k, vid in list(self._ids.items()):
                if vid == NULL_ID or vid in referenced:
                    continue
                if self._touch.get(vid, 0.0) > cutoff:
                    continue
                del self._ids[k]
                self._values[vid] = _FREE
                self._free.append(vid)
                self._touch.pop(vid, None)
                freed += 1
            self._freed_total += freed
        return freed

    # --- checkpoint support ----------------------------------------------
    def state_dict(self) -> dict:
        out = []
        for v in self._values[1:]:
            if v is _FREE:
                out.append([_T_FREE])
            elif isinstance(v, bytes):
                out.append([_T_BLOB, v.hex()])
            elif isinstance(v, str):
                out.append([_T_TEXT, v])
            elif isinstance(v, float):
                out.append([_T_REAL, v])
            else:
                out.append([_T_INT, v])
        return {"values": out}

    @classmethod
    def from_state_dict(cls, state: dict) -> "ValueHeap":
        heap = cls()
        for entry in state["values"]:
            tag, raw = entry[0], (entry[1] if len(entry) > 1 else None)
            vid = len(heap._values)
            if tag == _T_FREE:
                # preserve the hole: ids position-encode device state
                heap._values.append(_FREE)
                heap._free.append(vid)
                continue
            if tag == _T_BLOB:
                value = bytes.fromhex(raw)
            elif tag == _T_REAL:
                value = float(raw)
            elif tag == _T_INT:
                value = int(raw)
            else:
                value = raw
            heap._values.append(value)
            heap._ids[_key(value)] = vid
        return heap


def corro_json_contains(outer: Any, inner: Any) -> bool:
    """The custom SQL function from ``sqlite-functions``
    (``crates/sqlite-functions/src/lib.rs:5-30``): true when ``inner``'s
    JSON object/array is recursively contained in ``outer``'s."""
    a = json.loads(outer) if isinstance(outer, (str, bytes)) else outer
    b = json.loads(inner) if isinstance(inner, (str, bytes)) else inner
    return _contains(a, b)


def _contains(outer: Any, inner: Any) -> bool:
    if isinstance(inner, dict):
        return isinstance(outer, dict) and all(
            k in outer and _contains(outer[k], v) for k, v in inner.items()
        )
    if isinstance(inner, list):
        return isinstance(outer, list) and all(
            any(_contains(o, v) for o in outer) for v in inner
        )
    return outer == inner
