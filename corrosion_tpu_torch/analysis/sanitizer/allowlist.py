"""Sanctioned runtime findings, each with a reason (port of
``corrosion_tpu/analysis/sanitizer/allowlist.py``: the same entries,
named after the port's modules).

The corrolint contract, carried to runtime: a suppression that does not
say WHY is itself a bug. Every entry here is a deliberate design
decision the sanitizer would otherwise flag — the dynamic analog of the
``# corrolint: disable=... -- reason`` sites in the tree. An entry with
an empty reason raises at import (meta-tested), so the list can never
silently grow unexplained holes.

Keep entries MINIMAL and specific: the detector's value is exactly the
set of accesses NOT listed here.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: (class name, attribute) -> why the unsynchronized access is safe.
#: These mirror the lock-discipline suppressions corrolint already
#: carries for single-writer / GIL-atomic sites.
ALLOWED_ATTR_RACES: Dict[Tuple[str, str], str] = {
    ("Agent", "round_no"): (
        "GIL-atomic monotonic int; API readers tolerate a one-round "
        "stale value by design (the serving contract is eventual)"
    ),
    ("Agent", "_state"): (
        "single-reference state swap by the round thread; snapshot() "
        "re-checks round_no under _snap_lock and tolerates staleness"
    ),
    ("Agent", "_net"): (
        "single-reference NetModel swap between rounds; admin readers "
        "(members) only render it"
    ),
    ("Agent", "_key"): (
        "round-thread-owned PRNG key; soak() swaps it only with the "
        "loop stopped (guarded by a RuntimeError)"
    ),
    ("Agent", "_supervisor"): (
        "start() binds it before the loop spawns (ordered by the spawn "
        "edge); tests that inject a supervisor into a LIVE agent "
        "tolerate one stale round of the single-reference swap"
    ),
    ("Agent", "generation"): (
        "GIL-atomic int fence; the commit-side compare runs under "
        "_input_lock, observers only render it"
    ),
    ("Agent", "_recovering"): (
        "GIL-atomic bool flag set around a restore; health() reads it "
        "under _input_lock and a stale False only delays the 503"
    ),
    ("Agent", "_thread"): (
        "written before the loop exists or with it provably stopped; "
        "liveness checks tolerate staleness"
    ),
    ("Supervisor", "retries"): (
        "GIL-atomic telemetry counter; /v1/health renders it, nothing "
        "branches on it"
    ),
    ("Supervisor", "aborts"): (
        "GIL-atomic telemetry counter; /v1/health renders it, nothing "
        "branches on it"
    ),
    ("Matcher", "_subs"): (
        "mutation is under _mu; the n_subscribers property does a "
        "GIL-atomic len() on the list reference"
    ),
    ("Matcher", "n_queries"): (
        "GIL-atomic test/metrics counter incremented by the round "
        "thread; test readers assert on quiesced values"
    ),
    ("Matcher", "last_change_id"): (
        "mutated only under _mu; unlocked reads (manifest fast path, "
        "tests) render a monotonic int and tolerate staleness"
    ),
    ("Database", "schema"): (
        "immutable Schema object swapped under _mu; readers hold a "
        "consistent snapshot via one attribute read"
    ),
    ("Database", "heap"): (
        "immutable-identity swap on restore only (load_state_dict); "
        "concurrent readers during a restore are fenced by the agent "
        "generation bump"
    ),
    ("Database", "rows"): (
        "same restore-only swap contract as Database.heap"
    ),
    ("AsyncCheckpointWriter", "last_path"): (
        "worker-thread-owned; submitters read it only after close() "
        "joins the worker (join edge orders it)"
    ),
    ("AsyncCheckpointWriter", "io_seconds"): (
        "worker-thread-owned stat, read after close() join"
    ),
    ("AsyncCheckpointWriter", "written"): (
        "worker-thread-owned stat, read after close() join"
    ),
    ("AsyncCheckpointWriter", "overlapped"): (
        "worker-thread-owned stat, read after close() join"
    ),
}

#: (lock node, lock node) witnessed-edge pairs sanctioned BEYOND the
#: static graph. The meta-test asserts witnessed ⊆ static ∪ this dict:
#: a dynamically-created edge static call resolution provably cannot
#: see (these all flow through the ``Matcher(...)`` constructor, which
#: ``callgraph.resolve_call`` deliberately abstains on) must be argued
#: in with the argument, never silently absorbed. Deadlock-safety
#: argument shared by all three: the right-hand locks are LEAF locks —
#: they protect pure data, never call out, so no path can ever acquire
#: a pubsub lock under them and close a cycle.
ALLOWED_LOCK_EDGES: Dict[Tuple[str, str], str] = {
    ("corrosion_tpu_torch.pubsub.SubsManager._mu",
     "corrosion_tpu_torch.db.schema.RowMap._mu"): (
        "subscribe() validates the query under its lock; the row-map "
        "lookup lock is a leaf (guards dict reads, no outcalls)"
    ),
    ("corrosion_tpu_torch.pubsub.SubsManager._mu",
     "corrosion_tpu_torch.utils.locks.TrackedLock._lock"): (
        "query validation reads the agent snapshot under subscribe()'s "
        "lock; agent-plane locks never acquire host-plane pubsub locks "
        "(one-way layering)"
    ),
    ("corrosion_tpu_torch.pubsub.SubsManager._mu",
     "corrosion_tpu_torch.utils.locks.LockRegistry._mu"): (
        "every TrackedLock acquisition notes itself in the registry; "
        "the registry lock is a leaf (event-dict updates only)"
    ),
    ("corrosion_tpu_torch.db.database.Database._mu",
     "corrosion_tpu_torch.db.schema.RowMap._mu"): (
        "schema/restore surgery touches row-map lookups under the db "
        "lock; RowMap._mu is a leaf (guards dict reads, no outcalls)"
    ),
    ("corrosion_tpu_torch.pubsub.DeltaTracker._mu",
     "corrosion_tpu_torch.db.schema.RowMap._mu"): (
        "changed() maps delta cells to (table, pk) through the row-map "
        "reverse lookup while holding its baseline lock; RowMap._mu is "
        "a leaf (guards dict reads, no outcalls)"
    ),
    ("corrosion_tpu_torch.pubsub.UpdatesManager._mu",
     "corrosion_tpu_torch.db.schema.RowMap._mu"): (
        "attach()'s first-feed snapshot queries under the feeds lock; "
        "RowMap._mu is a leaf"
    ),
    ("corrosion_tpu_torch.pubsub.UpdatesManager._mu",
     "corrosion_tpu_torch.utils.locks.TrackedLock._lock"): (
        "attach()'s first-feed snapshot reads the agent snapshot under "
        "the feeds lock; agent-plane locks never acquire host-plane "
        "pubsub locks (one-way layering)"
    ),
    ("corrosion_tpu_torch.pubsub.UpdatesManager._mu",
     "corrosion_tpu_torch.utils.locks.LockRegistry._mu"): (
        "same snapshot path as TrackedLock._lock above; the registry "
        "lock is a leaf"
    ),
    ("corrosion_tpu_torch.api.admission.AdmissionController._mu",
     "corrosion_tpu_torch.utils.metrics.Registry._lock"): (
        "admit()/release() publish the corro.admission.* counters and "
        "level gauges while the admission mutex is held so the levels "
        "are snapshot-consistent with the decision; Registry._lock is "
        "a leaf (pure dict updates, no outcalls), so no path can "
        "acquire an admission lock under it and close a cycle"
    ),
}

#: thread-name prefixes the leak gate exempts, with reasons.
ALLOWED_LEAK_PREFIXES: Dict[str, str] = {
    "corro-supervised-": (
        "a dispatch that missed its deadline cannot be cancelled, only "
        "orphaned (Supervisor._with_deadline) — daemonic by design"
    ),
}


def _validate() -> None:
    for table in (ALLOWED_ATTR_RACES, ALLOWED_LOCK_EDGES,
                  ALLOWED_LEAK_PREFIXES):
        for key, reason in table.items():
            if not str(reason).strip():
                raise ValueError(
                    f"corrosan allowlist entry {key!r} has no reason — "
                    "a suppression that does not say why is a bug"
                )


_validate()
