"""Pure-Python host oracle for the simulator — the small-N ground truth
(a copy of ``corrosion_tpu/sim/oracle.py``; the port imports nothing of
the JAX package).

Mirrors the semantics the array kernels must reproduce, in plain dicts and
sets: LWW cell merge (``doc/crdts.md:14-16,237``), per-origin version
bookkeeping (seen-set / contiguous head — ``BookedVersions``, reference
``crates/corro-types/src/agent.rs:1270-1604``), and the convergence
predicate ("no needs, equal heads", as the reference's Antithesis
``check_bookkeeping.py`` script checks).

Deliberately slow and obvious; property tests drive both this and the
simulator's rounds with the same random traffic and demand identical states.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Set, Tuple

# (cell, ver, val, site, origin, dbv, clp) — clp is the causal-length
# row lifetime the cell was written under (cr-sqlite `cl`)
Change = Tuple[int, int, int, int, int, int, int]


def lww_wins(a: Tuple[int, int, int, int], b: Tuple[int, int, int, int]) -> bool:
    """Does clock ``a`` = (cl_lifetime, col_version, value, site_id) beat
    ``b``? A later causal-length lifetime beats anything from an earlier
    one (cr-sqlite "greater causal length wins", ``doc/crdts.md:24-40``);
    within a lifetime the plain LWW rule applies.

    Ties keep the incumbent ``a`` (identical change)."""
    return a >= b  # Python tuple comparison IS the lexicographic rule


@dataclass
class OracleNode:
    """One simulated node: LWW store + per-origin version bookkeeping."""

    n_origins: int
    # cell -> (col_version, value, site, origin_db_version, cl_lifetime)
    store: Dict[int, Tuple[int, int, int, int, int]] = field(default_factory=dict)
    seen: Dict[int, Set[int]] = field(default_factory=dict)  # origin -> versions
    known_max: Dict[int, int] = field(default_factory=dict)
    # (origin, dbv) -> {seq: (cell, ver, val, site, clp)} — buffered cells
    # of incomplete chunked versions (the __corro_buffered_changes analog,
    # reference crates/corro-agent/src/agent/util.rs:1061-1194); applied
    # atomically once seqs 0..nseq-1 are all present
    partial: Dict[Tuple[int, int], Dict[int, Tuple[int, int, int, int, int]]] = (
        field(default_factory=dict)
    )

    def head(self, origin: int) -> int:
        s = self.seen.get(origin, set())
        h = 0
        while (h + 1) in s:
            h += 1
        return h

    def merge_cell(self, cell: int, ver: int, val: int, site: int, dbv: int,
                   clp: int = 0):
        cur = self.store.get(cell)
        if cur is None or not lww_wins(
            (cur[4], cur[0], cur[1], cur[2]), (clp, ver, val, site)
        ):
            self.store[cell] = (ver, val, site, dbv, clp)

    def record(self, origin: int, version: int) -> bool:
        """Record an origin-version; returns True when fresh (unseen)."""
        s = self.seen.setdefault(origin, set())
        self.known_max[origin] = max(self.known_max.get(origin, 0), version)
        if version in s:
            return False
        s.add(version)
        return True

    def apply(self, change: Change) -> bool:
        cell, ver, val, site, origin, dbv, clp = change
        fresh = self.record(origin, dbv)
        if fresh:
            self.merge_cell(cell, ver, val, site, dbv, clp)
        return fresh

    def apply_chunk(self, change: Change, seq: int, nseq: int) -> bool:
        """Ingest one cell of a chunked version. ``nseq == 1`` is the
        complete-changeset fast path; otherwise the cell buffers until
        the whole seq range 0..nseq-1 is present, then the version
        applies atomically and records as seen
        (``process_incomplete_version`` ->
        ``process_fully_buffered_changes``, ``util.rs:1061-1194,546-696``).
        Returns True when this cell was fresh (re-broadcast it)."""
        if nseq <= 1:
            return self.apply(change)
        cell, ver, val, site, origin, dbv, clp = change
        self.known_max[origin] = max(self.known_max.get(origin, 0), dbv)
        if dbv in self.seen.get(origin, set()):
            return False  # whole version already seen
        buf = self.partial.setdefault((origin, dbv), {})
        if seq in buf:
            return False  # duplicate chunk
        buf[seq] = (cell, ver, val, site, clp)
        if len(buf) == nseq:  # seq range closed -> atomic apply
            self.seen.setdefault(origin, set()).add(dbv)
            for c, v, vl, st, cl in buf.values():
                self.merge_cell(c, v, vl, st, dbv, cl)
            del self.partial[(origin, dbv)]
        return True

    def needs(self, origin: int) -> int:
        s = self.seen.get(origin, set())
        km = self.known_max.get(origin, 0)
        return sum(1 for v in range(1, km + 1) if v not in s)


def converged(nodes) -> bool:
    """The reference's convergence check: no needs + equal heads
    (``check_bookkeeping.py``), plus (stronger) identical LWW stores."""
    first = nodes[0]
    for n in nodes[1:]:
        if n.store != first.store:
            return False
        for o in range(first.n_origins):
            if n.head(o) != first.head(o) or n.needs(o) or first.needs(o):
                return False
    return True
