"""Subscriptions (pubsub) + table update feeds.

Mirrors the reference's subscription engine (``crates/corro-types/src/
pubsub.rs:527-1100``) and its lighter sibling, the table updates feed
(``crates/corro-types/src/updates.rs``):

- a **Matcher** owns one SQL query against one observer node's replica,
  keeps the last materialized result keyed by pk (the reference keeps it
  in a dedicated per-subscription SQLite db), and on every round diffs
  the fresh result against it, emitting ``QueryEvent::Change`` rows with
  a **monotonic ChangeId** per matcher;
- subscribers attach live via per-subscriber queues (the tokio broadcast
  channel analog) and can **catch up from a ChangeId** through the
  matcher's retained change log (``pubsub.rs:842-878``);
- the **UpdatesManager** streams row-level ``NotifyEvent``s per table
  without a query (``/v1/updates/:table``).

Matchers re-poll on the agent's round listener — the seam where the
reference calls ``match_changes`` on every applied changeset
(``util.rs:1034-1037``, ``broadcast.rs:539-540``).
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

from corrosion_tpu_torch.utils.tracing import logger

# change kinds (reference ChangeType)
UPSERT = "update"
INSERT = "insert"
DELETE = "delete"


def _enc(v: Any) -> Any:
    """JSON-safe encoding for pk/row values (bytes get a tag)."""
    if isinstance(v, bytes):
        return {"__bytes__": v.hex()}
    return v


def _dec(v: Any) -> Any:
    if isinstance(v, dict) and "__bytes__" in v:
        return bytes.fromhex(v["__bytes__"])
    return v


def _enc_key(k: Any) -> Any:
    """Row keys are scalar pks (single-table) or composite pk tuples
    (JOIN subscriptions) — tuples get a tag so restore re-hashes them."""
    if isinstance(k, tuple):
        return {"__key__": [_enc(x) for x in k]}
    return _enc(k)


def _enc_wire(v: Any) -> Any:
    """HTTP wire encoding for change-event values (the ``{"blob"}``
    convention of ``api/http.py``, applied recursively to composite pk
    tuples)."""
    if isinstance(v, bytes):
        return {"blob": v.hex()}
    if isinstance(v, tuple):
        return [_enc_wire(x) for x in v]
    return v


def encode_change_frame(rec) -> bytes:
    """The NDJSON wire line for one change record, exactly as the HTTP
    layer frames it (``{"change": [kind, key, row, id]}`` + newline).
    Batched fanout (corroguard, docs/overload.md): the matcher encodes
    each per-round delta record ONCE through this and caches the bytes
    by change id — every subscriber stream multicasts the same frame
    instead of re-encoding per subscriber."""
    cid, kind, key, row = rec
    return json.dumps({"change": [
        kind,
        _enc_wire(key),
        None if row is None else [_enc_wire(v) for v in row],
        cid,
    ]}).encode() + b"\n"


def _dec_key(k: Any) -> Any:
    if isinstance(k, dict) and "__key__" in k:
        return tuple(_dec(x) for x in k["__key__"])
    return _dec(k)


def _serve_policy(serve):
    """Subscription queue policy triple ``(sub_queue, shed_policy,
    sub_shed_threshold)`` from a duck-typed ``[serve]`` section.

    ``serve=None`` means the DEFAULT policy (``config.ServeConfig``'s
    measured caps, docs/overload.md "Default caps") — NOT unlimited;
    ``sub_queue=0`` is the explicit unbounded opt-out
    (``ServeConfig.unlimited()``), which maps straight onto
    ``queue.Queue``'s ``maxsize<=0`` = infinite semantics. The lazy
    import keeps pubsub free of a module-level config dependency (any
    object with these attrs still works)."""
    if serve is None:
        from corrosion_tpu_torch.config import ServeConfig

        serve = ServeConfig()
    return (
        int(getattr(serve, "sub_queue", 1024)),
        str(getattr(serve, "shed_policy", "shed-oldest")),
        int(getattr(serve, "sub_shed_threshold", 256)),
    )


class SubQueue(queue.Queue):
    """Per-subscriber event queue with bounded backpressure
    (corroguard, docs/overload.md). The producer (the round thread)
    never blocks. Two shed policies:

    - ``shed-oldest`` (default): on overflow the OLDEST queued frame is
      dropped to admit the new one — the consumer keeps receiving fresh
      events with a bounded lag and learns about the gap through the
      stream's resync marker (:meth:`take_resync`). Crossing
      ``shed_threshold`` cumulative drops marks the consumer lagged:
      the slow-consumer disconnect policy.
    - ``drop-newest`` (legacy): overflow refuses the new frame and
      marks the consumer lagged immediately — the tokio broadcast
      ``RecvError::Lagged`` behavior the reference relies on.
    """

    def __init__(self, maxsize: int = 65536,
                 shed_policy: str = "shed-oldest",
                 shed_threshold: int = 256):
        super().__init__(maxsize=maxsize)
        self.shed_policy = shed_policy
        self.shed_threshold = max(1, int(shed_threshold))
        self.lagged = False
        self._shed_mu = threading.Lock()
        self._shed = 0  # lifetime frames dropped (shed-oldest)
        self._resync = 0  # drops since the consumer last took a marker
        self._reported = 0  # drops already drained into shed_total

    def offer(self, item) -> bool:
        """Producer-side non-blocking enqueue. False = refused: the
        consumer is lagged and the fanout will disconnect it."""
        if self.lagged:
            return False
        while True:
            try:
                self.put_nowait(item)
                return True
            except queue.Full:
                if self.shed_policy != "shed-oldest":
                    self.lagged = True
                    return False
                try:
                    self.get_nowait()  # drop the oldest frame
                except queue.Empty:
                    continue  # the consumer drained it first; retry
                with self._shed_mu:
                    self._shed += 1
                    self._resync += 1
                    if self._shed >= self.shed_threshold:
                        self.lagged = True

    def preload(self, item) -> None:
        """Attach-time enqueue that bypasses ``maxsize``: the initial
        snapshot / catch-up backlog must arrive whole even when it is
        larger than the live bound (the consumer has not even started
        reading yet, so it cannot be 'slow'). Live ``offer`` traffic
        sheds against the bound as usual once the stream is running."""
        with self.mutex:
            self.queue.append(item)
            self.unfinished_tasks += 1
            self.not_empty.notify()

    def drain_shed(self) -> int:
        """Producer side: drops not yet folded into
        ``corro.subs.shed_total`` (the fanout drains after each round)."""
        with self._shed_mu:
            n = self._shed - self._reported
            self._reported = self._shed
            return n

    def take_resync(self) -> int:
        """Consumer side: drops since the last call — non-zero means
        the stream has a gap and the HTTP loop owes the client a resync
        marker before the next event (docs/overload.md)."""
        with self._shed_mu:
            n, self._resync = self._resync, 0
            return n


class DeltaTracker:
    """Applied-change detection per observed node, from store-plane
    diffs — the device-side analog of the reference feeding each applied
    changeset to ``match_changes`` (``util.rs:1036-1037``).

    Each round, the observer node's ``(ver, val, clp)`` planes are
    compared against the previous round's copy; changed cells map to
    grid rows, and rows map to ``(table, pk)`` through the
    :class:`RowMap` reverse lookup. The result is a candidate dict
    ``{table: {pk, ...}}`` — ``None`` means "no baseline yet"
    (callers fall back to a full re-query)."""

    def __init__(self, db):
        self.db = db
        self._planes: Dict[int, tuple] = {}
        # (round, delta) per node: consumers arriving within the same
        # round share one computation instead of each advancing the
        # baseline (which would hand the second caller an empty delta)
        self._cache: Dict[int, tuple] = {}
        self._mu = threading.Lock()

    def changed(self, node: int) -> Optional[Dict[str, set]]:
        import numpy as np

        snap = self.db.agent.snapshot()
        rnd = snap.get("round", -1)
        with self._mu:
            cached = self._cache.get(node)
            if cached is not None and cached[0] == rnd:
                return cached[1]
            store = snap["store"]  # (ver, val, site, dbv, clp) planes
            ver = np.asarray(store[0][node])
            val = np.asarray(store[1][node])
            clp = np.asarray(store[4][node])
            prev = self._planes.get(node)
            self._planes[node] = (ver.copy(), val.copy(), clp.copy())
            if prev is None:
                out = None
            else:
                ch = (prev[0] != ver) | (prev[1] != val) | (prev[2] != clp)
                if not ch.any():
                    out = {}
                else:
                    out = {}
                    n_cols = self.db.n_cols
                    for row in {int(c) // n_cols
                                for c in np.nonzero(ch)[0]}:
                        tp = self.db.rows.table_pk_of(row)
                        if tp is not None:
                            out.setdefault(tp[0], set()).add(tp[1])
            self._cache[node] = (rnd, out)
            return out


class Matcher:
    """One subscription query: materialized result + change log."""

    def __init__(self, db, node: int, sql: str, params: Any = None,
                 sub_id: Optional[str] = None, max_log: int = 4096,
                 restore: Optional[dict] = None, serve=None):
        self.id = sub_id or uuid.uuid4().hex
        self.db = db
        self.node = node
        self.sql = sql
        self.params = params
        self.max_log = max_log
        # validate the query + capture column names up front
        cols, _ = db.query(node, sql, params)
        self.columns: List[str] = list(cols)
        # the reference rewrites the SELECT to expose the pks of EVERY
        # table involved in the query (``pubsub.rs:527+``) so a change to
        # either side of a JOIN re-evaluates the match. Mirror that: run
        # a variant with every alias-qualified pk prepended and key the
        # materialized result by the composite pk tuple, stripping the
        # key columns on emit.
        import re

        from corrosion_tpu_torch.db.database import SqlError, _Params

        ast = db._parse_select(sql, _Params(None), check_params=False)
        if ast["group"] or any(k == "agg" for k, _, _ in ast["cols"]):
            raise SqlError(
                "subscriptions require plain row queries "
                "(no aggregates / GROUP BY)"
            )
        from corrosion_tpu_torch.db.database import _CteTable

        if any(isinstance(t, _CteTable) for t in ast["aliases"].values()):
            # CTE results have no pk to track matches by; the reference
            # likewise restricts subscription queries to its supported
            # matcher surface (pubsub.rs:527+)
            raise SqlError("subscriptions do not support WITH (CTEs)")
        pk_refs = [f"{a}.{t.pk.name}" for a, t in ast["aliases"].items()]
        self._n_keys = len(pk_refs)
        self._key_sql = re.sub(
            r"^\s*SELECT\s+", f"SELECT {', '.join(pk_refs)}, ", sql,
            count=1, flags=re.IGNORECASE,
        )
        # incremental matching (VERDICT r4 #6): per-alias candidate
        # restriction needs the alias->(table, pk record key) map in
        # pk_refs order, plus the set of tables reached only through
        # subqueries (a change there invalidates candidate filtering —
        # fall back to a full re-query)
        self._aliases = [
            (a, t.name, f"{a}.{t.pk.name}")
            for a, t in ast["aliases"].items()
        ]
        self._subq_tables: set = self._collect_subq_tables(
            list(ast["conds"]) + list(ast.get("having", [])), set()
        )
        # ORDER BY / LIMIT / OFFSET change which rows are IN the result
        # for reasons outside the changed pks; LEFT JOINs null-extend —
        # a right-side insert/delete flips (pk, None) keys the candidate
        # filter cannot reach. Diff the full result in both cases.
        self._can_increment = not (
            ast.get("order") or ast.get("limit") or ast.get("offset")
            or any(j[0] == "left" for j in ast.get("joins", ()))
        )
        self.n_queries = 0  # full + filtered executions (tests/metrics)
        # serving-plane telemetry: fanout depth/shed series
        # land on the owning agent's registry; bound once at build time
        # (read-only after publication)
        self._registry = db.agent.metrics
        # a restored matcher's state predates any delta baseline (the
        # persisted manifest may be a whole downtime old): its first
        # poll MUST be a full re-diff or down-window changes are lost
        self._force_full = restore is not None
        # corroguard queue policy for the subscriber queues this matcher
        # hands out (duck-typed [serve] section — pubsub stays free of a
        # config import; any object with these attrs works)
        self.sub_queue, self.shed_policy, self.shed_threshold = (
            _serve_policy(serve))
        self._state: Dict[Any, Tuple] = {}
        self._log: List[Tuple[int, str, Any, Optional[List[Any]]]] = []
        self._log_base = 1  # change id of _log[0]
        self.last_change_id = 0
        self._subs: List[SubQueue] = []
        # batched fanout: pre-encoded NDJSON frame per retained change id
        # (trimmed alongside _log); n_encodes counts encode operations so
        # tests can pin encode-once-per-event (not per-subscriber)
        self._wire: Dict[int, bytes] = {}
        self.n_encodes = 0
        self._mu = threading.Lock()
        if restore is not None:
            # resume the change-id sequence where the persisted manifest
            # left off (the reference resumes from its per-sub SQLite db,
            # pubsub.rs:842-878), PLUS a max_log alias gap: the manifest
            # may be stale by up to a persist interval, so ids in
            # (persisted, crash] were handed to clients but are not
            # recorded — restarting right after the persisted id would
            # re-assign those ids to *different* events. Skipping max_log
            # ids guarantees no client-held id aliases (a client further
            # behind than max_log gets the full re-dump path anyway).
            self.last_change_id = int(restore.get("last_change_id", 0))
            if self.last_change_id:
                self.last_change_id += self.max_log
            self._log_base = self.last_change_id + 1
            if "state" in restore:
                # pre-shutdown materialized rows: the first poll() diffs
                # them against the live replica, so changes that happened
                # while the agent was down surface as ordinary events
                self._state = {
                    _dec_key(k): tuple(_dec(v) for v in row)
                    for k, row in restore["state"]
                }
            else:
                self._prime()
        else:
            self._prime()

    @classmethod
    def _collect_subq_tables(cls, conds, acc: set) -> set:
        """Table names reachable only through subquery right sides."""
        for cond in conds:
            op, lhs, rhs = cond
            if op == "or":
                for branch in lhs:
                    cls._collect_subq_tables(branch, acc)
            elif op == "not":
                cls._collect_subq_tables(lhs, acc)
            elif isinstance(rhs, tuple) and rhs and rhs[0] in (
                "subq", "subq_list"
            ):
                sub = rhs[1]
                for t in sub["aliases"].values():
                    name = getattr(t, "name", None)
                    if name:
                        acc.add(name)
                cls._collect_subq_tables(sub.get("conds", []), acc)
        return acc

    def _current(self) -> Dict[Any, Tuple]:
        self.n_queries += 1
        _, rows = self.db.query(self.node, self._key_sql, self.params)
        k = self._n_keys
        if k == 1:
            # single-table: scalar pk key (the wire shape clients expect)
            return {row[0]: tuple(row[1:]) for row in rows}
        return {tuple(row[:k]): tuple(row[k:]) for row in rows}

    def _prime(self) -> None:
        fresh = self._current()
        with self._mu:
            self._state = fresh

    # --- diffing ---------------------------------------------------------
    def poll(self, candidates: Optional[Dict[str, set]] = None) -> int:
        """Diff the node's replica against the materialized state; emit
        change events. Returns the number of events emitted.

        ``candidates`` is the round's applied-delta dict
        ``{table: {pk, ...}}`` from :class:`DeltaTracker`. When given
        (and the query is incrementally evaluable), only candidate pks
        are re-queried — matcher cost per round is proportional to the
        changed rows, not the result set (the reference's candidate-PK
        diffing, ``pubsub.rs:527-1100``). ``None`` = unknown delta:
        full re-query."""
        if candidates is not None and (
            self._force_full
            or not self._can_increment
            or any(t in candidates for t in self._subq_tables)
        ):
            candidates = None
        if candidates is None:
            fresh = self._current()
            with self._mu:
                self._force_full = False
                events = self._diff_upserts(fresh)
                for key in self._state:
                    if key not in fresh:
                        events.append((DELETE, key, None))
                self._state = fresh
                out, subs = self._log_events_locked(events)
            return self._fanout(out, subs)
        # incremental: ONE re-query restricted to the candidate pks — a
        # disjunction of per-alias IN conds, so a delta touching both
        # sides of a JOIN still costs a single scan
        k = self._n_keys
        pk_sets: Dict[int, set] = {}
        for i, (alias, tname, pk_key) in enumerate(self._aliases):
            pks = candidates.get(tname)
            if pks:
                pk_sets[i] = set(pks)
        if not pk_sets:
            return 0  # nothing this matcher watches changed
        in_conds = [
            ("in", self._aliases[i][2], sorted(s, key=repr))
            for i, s in pk_sets.items()
        ]
        extra = (in_conds if len(in_conds) == 1
                 else [("or", [[c] for c in in_conds], None)])
        self.n_queries += 1
        rows = self.db.query_filtered(
            self.node, self._key_sql, self.params, extra)
        if k == 1:
            fresh_part = {row[0]: tuple(row[1:]) for row in rows}
        else:
            fresh_part = {tuple(row[:k]): tuple(row[k:]) for row in rows}
        with self._mu:
            events = self._diff_upserts(fresh_part)
            for key in list(self._state):
                if key in fresh_part:
                    continue
                # affected = some component pk was a candidate
                if k == 1:
                    hit = any(key in s for s in pk_sets.values())
                else:
                    hit = any(key[i] in s for i, s in pk_sets.items())
                if hit:
                    events.append((DELETE, key, None))
            for kind, key, row in events:
                if kind == DELETE:
                    self._state.pop(key, None)
                else:
                    self._state[key] = tuple(row)
            out, subs = self._log_events_locked(events)
        return self._fanout(out, subs)

    def _diff_upserts(self, fresh: Dict[Any, Tuple]) -> list:
        """INSERT/UPSERT events for ``fresh`` vs the materialized state
        (``self._mu`` held). Deletes differ per path — callers append."""
        events = []
        for key, row in fresh.items():
            old = self._state.get(key)
            if old is None:
                events.append((INSERT, key, list(row)))
            elif old != row:
                events.append((UPSERT, key, list(row)))
        return events

    def _log_events_locked(self, events):
        """Assign change ids + append to the log. Named per the
        ``*_locked`` convention: ``self._mu`` must be held (state
        already updated). Returns (records, subscribers)."""
        out = []
        for kind, key, row in events:
            self.last_change_id += 1
            rec = (self.last_change_id, kind, key, row)
            self._log.append(rec)
            out.append(rec)
        if len(self._log) > self.max_log:
            drop = len(self._log) - self.max_log
            self._log = self._log[drop:]
            self._log_base += drop
        return out, list(self._subs)

    def _fanout(self, out, subs) -> int:
        """Deliver records to subscriber queues OUTSIDE the lock
        (detach of a lagged subscriber re-acquires it).

        Batched fanout (corroguard): the per-round delta is walked once
        — each record's NDJSON wire line is encoded a single time and
        cached by change id, so every subscriber's HTTP loop multicasts
        the same bytes instead of re-encoding per subscriber. Shed
        accounting: shed-oldest drops drain into
        ``corro.subs.shed_total`` here (frame-accurate — the series
        agrees with the gaps clients observe), and consumers past their
        shed threshold are disconnected."""
        if out and subs:
            frames = {rec[0]: encode_change_frame(rec) for rec in out}
            self.n_encodes += len(frames)
            with self._mu:
                self._wire.update(frames)
                if len(self._wire) > self.max_log:
                    for cid in [c for c in self._wire
                                if c < self._log_base]:
                        del self._wire[cid]
        lagged = []
        for q in subs:
            refused = False
            for rec in out:
                if not q.offer(("change", rec)):
                    refused = True
                    break
            shed = q.drain_shed()
            if shed:
                self._registry.counter("corro.subs.shed_total",
                                       float(shed), {"sub": self.id})
            if refused or q.lagged:
                lagged.append(q)
        if out and subs:
            # deepest subscriber queue after this fanout: the early-
            # warning signal admission control acts on — a depth
            # climbing toward SubQueue maxsize means a consumer is
            # about to shed
            self._registry.gauge(
                "corro.subs.queue.depth",
                max(q.qsize() for q in subs), {"sub": self.id})
        for q in lagged:
            if q.shed_policy != "shed-oldest":
                # legacy drop-newest: the disconnect IS the shed event
                self._registry.counter("corro.subs.shed_total", 1.0,
                                       {"sub": self.id})
            logger.warning("matcher %s: disconnecting lagged subscriber",
                           self.id)
            self.detach(q)
        return len(out)

    def wire_frame(self, change_id: int) -> Optional[bytes]:
        """The cached pre-encoded NDJSON line for a retained change id
        (None once trimmed past ``max_log`` — streaming loops fall back
        to encoding the record themselves)."""
        with self._mu:
            return self._wire.get(change_id)

    # --- subscriber attach/detach ---------------------------------------
    def attach(self, from_change_id: Optional[int] = None) -> "SubQueue":
        """A live event queue, optionally preloaded with the catch-up
        backlog from ``from_change_id`` (exclusive). If the backlog has
        been GC'd past that id, the subscriber gets a full re-dump
        (columns + rows), like the reference's query restart."""
        q = SubQueue(maxsize=self.sub_queue, shed_policy=self.shed_policy,
                     shed_threshold=self.shed_threshold)
        with self._mu:
            # preload (not offer): the catch-up dump bypasses the live
            # bound — a subscriber must never be shed before it has had
            # a chance to read its first frame
            q.preload(("columns", self.columns))
            if from_change_id is None:
                for key, row in self._state.items():
                    q.preload(("row", (key, list(row))))
                q.preload(("eoq", self.last_change_id))
            elif (from_change_id + 1 >= self._log_base
                  and from_change_id <= self.last_change_id):
                for rec in self._log[from_change_id + 1 - self._log_base:]:
                    q.preload(("change", rec))
            else:
                # backlog GC'd: full resync
                for key, row in self._state.items():
                    q.preload(("row", (key, list(row))))
                q.preload(("eoq", self.last_change_id))
            self._subs.append(q)
        return q

    def detach(self, q: queue.Queue) -> None:
        with self._mu:
            if q in self._subs:
                self._subs.remove(q)

    @property
    def n_subscribers(self) -> int:
        return len(self._subs)

    @property
    def delivery_tables(self) -> List[str]:
        """Table name per pk-key component, in key order — the HTTP
        streaming loop resolves commit stamps (delivery latency) through
        this without reaching into the parse internals."""
        return [tname for _alias, tname, _pk in self._aliases]

    # --- persistence (pubsub.rs stores matcher SQL + state on disk) ------
    def manifest(self) -> dict:
        with self._mu:
            # cheap pointer copy under the lock; the O(result-set) encode
            # happens outside so poll()/attach() are not blocked by it
            state_items = list(self._state.items())
            last = self.last_change_id
        state = [[_enc_key(k), [_enc(v) for v in row]]
                 for k, row in state_items]
        return {"id": self.id, "node": self.node, "sql": self.sql,
                "params": self.params, "last_change_id": last,
                "state": state}


class SubsManager:
    """All matchers of one agent; re-polls them after every round."""

    def __init__(self, db, persist_dir: Optional[str] = None, serve=None):
        self.db = db
        self.persist_dir = persist_dir
        self.serve = serve  # corroguard [serve] queue policy (or None)
        self._tracker = db.delta_tracker()  # shared, per-round cached
        self._matchers: Dict[str, Matcher] = {}
        self._by_query: Dict[Tuple, str] = {}
        self._dirty: set = set()
        self._mu = threading.Lock()
        self._persist_q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._persist_thread: Optional[threading.Thread] = None
        db.agent.add_round_listener(self._on_round)
        if persist_dir:
            import sys

            from corrosion_tpu_torch.utils.lifecycle import spawn_counted

            os.makedirs(persist_dir, exist_ok=True)
            # a corrosan session (if one is active) witnesses manifest
            # write/delete ordering under this root — the PR-5
            # unsubscribe-vs-persist resurrection is detected here.
            # Resolved via sys.modules so the production path never
            # imports the sanitizer: any live session necessarily
            # already imported the hooks module.
            san_hooks = sys.modules.get(
                "corrosion_tpu_torch.analysis.sanitizer.hooks")
            if san_hooks is not None:
                san_hooks.watch_dir(persist_dir)
            # manifests are written off-thread: a large materialized state
            # must not stall the agent round loop. Counted + corro- named:
            # close() joins it, and leak reports name the owner.
            self._persist_thread = spawn_counted(
                self._persist_worker, name="corro-subs-persist"
            )

    PERSIST_EVERY = 16  # rounds between manifest re-writes per dirty matcher

    def _on_round(self, round_no: int) -> None:
        # snapshot under _mu: subscribe() publishes freshly-built
        # matchers through this dict, and an unlocked read would hand
        # the round thread a matcher with no happens-before edge to its
        # construction (corrosan attr-race on the init attrs)
        with self._mu:
            matchers = list(self._matchers.values())
        # one delta computation per observed node, shared by all its
        # matchers (None on the node's first round = full re-query)
        cands: Dict[int, Optional[Dict[str, set]]] = {}
        for node in {m.node for m in matchers}:
            try:
                cands[node] = self._tracker.changed(node)
            except Exception:  # noqa: BLE001 — degrade to full polls
                logger.exception("delta tracking failed for node %s", node)
                cands[node] = None
        for m in matchers:
            try:
                if m.poll(cands.get(m.node)):
                    with self._mu:
                        self._dirty.add(m.id)
            except Exception:  # noqa: BLE001 — a bad matcher must not stall rounds
                logger.exception("matcher %s poll failed", m.id)
        # re-persist dirty matchers periodically (not every round — the
        # manifest carries the full materialized state) so a restart
        # resumes the change-id sequence close to where it stopped; a
        # stale manifest is safe: restore re-diffs from the persisted
        # state, skips a max_log id alias gap, and attach() treats
        # from>last_change_id as backlog-lost. The dirty check runs
        # under _mu (corrosan attr-race: the old unlocked `if
        # self._dirty` fast path raced close()'s swap) — the cadence
        # check alone keeps the common round lock-free.
        if round_no % self.PERSIST_EVERY == 0:
            with self._mu:
                dirty, self._dirty = self._dirty, set()
            for mid in dirty:
                if mid in self._matchers:
                    self._persist_q.put(mid)

    def _persist_worker(self) -> None:
        while True:
            mid = self._persist_q.get()
            if mid is None:
                return
            m = self._matchers.get(mid)
            if m is not None:
                try:
                    self._persist(m)
                except Exception:  # noqa: BLE001
                    logger.exception("failed to persist subscription %s", mid)
                # an unsubscribe() racing the write above has already
                # unlinked the manifest — a write that lands after it
                # would resurrect the dead subscription on restart.
                # Re-check liveness and remove the file we just wrote.
                with self._mu:
                    alive = mid in self._matchers
                if not alive and self.persist_dir:
                    path = os.path.join(self.persist_dir, f"{mid}.json")
                    with contextlib.suppress(FileNotFoundError):
                        os.unlink(path)

    def subscribe(self, node: int, sql: str, params: Any = None
                  ) -> Tuple[Matcher, bool]:
        """Get-or-create a matcher (the reference dedupes identical query
        subs onto one matcher). Returns (matcher, created)."""
        key = (node, sql, json.dumps(params, sort_keys=True, default=str))
        with self._mu:
            mid = self._by_query.get(key)
            if mid is not None:
                return self._matchers[mid], False
            m = Matcher(self.db, node, sql, params, serve=self.serve)
            self._matchers[m.id] = m
            self._by_query[key] = m.id
            self._persist(m)
            return m, True

    def get(self, sub_id: str) -> Optional[Matcher]:
        return self._matchers.get(sub_id)

    def unsubscribe(self, sub_id: str) -> bool:
        with self._mu:
            m = self._matchers.pop(sub_id, None)
            if m is None:
                return False
            self._by_query = {k: v for k, v in self._by_query.items()
                              if v != sub_id}
        # filesystem work OUTSIDE the lock (corrolint blocking-under-lock)
        if self.persist_dir:
            path = os.path.join(self.persist_dir, f"{sub_id}.json")
            if os.path.exists(path):
                os.unlink(path)
        return True

    def ids(self) -> List[str]:
        return list(self._matchers)

    def close(self) -> None:
        """Detach from the agent's round loop and flush pending manifests
        (matchers stop polling; their state stays restorable)."""
        self.db.agent.remove_round_listener(self._on_round)
        thread = self._persist_thread
        if thread is not None:
            self._persist_q.put(None)
            thread.join(timeout=30.0)
            with self._mu:
                self._persist_thread = None
        with self._mu:
            dirty, self._dirty = self._dirty, set()
        for mid in dirty:
            m = self._matchers.get(mid)
            if m is not None:
                self._persist(m)

    def _persist(self, m: Matcher) -> None:
        if not self.persist_dir:
            return
        with open(os.path.join(self.persist_dir, f"{m.id}.json"), "w") as f:
            json.dump(m.manifest(), f)

    def restore(self) -> int:
        """Recreate persisted matchers (boot hook, ``setup.rs:291-344``)."""
        if not self.persist_dir or not os.path.isdir(self.persist_dir):
            return 0
        n = 0
        for name in sorted(os.listdir(self.persist_dir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.persist_dir, name)) as f:
                    man = json.load(f)
                m = Matcher(self.db, man["node"], man["sql"], man["params"],
                            sub_id=man["id"], restore=man, serve=self.serve)
                with self._mu:
                    self._matchers[m.id] = m
                    key = (m.node, m.sql,
                           json.dumps(m.params, sort_keys=True, default=str))
                    self._by_query[key] = m.id
                n += 1
            except Exception:  # noqa: BLE001
                logger.exception("failed to restore subscription %s", name)
        return n


class UpdatesManager:
    """Row-level per-table feeds (``updates.rs:61-250``): each table feed
    diffs pk liveness + row content every round and emits
    ``NotifyEvent {kind, pk}``."""

    def __init__(self, db, node: int = 0, serve=None):
        self.db = db
        self.node = node
        self.serve = serve  # corroguard [serve] queue policy (or None)
        self._tracker = db.delta_tracker()  # shared, per-round cached
        self._feeds: Dict[str, List[queue.Queue]] = {}
        self._state: Dict[str, Dict[Any, Tuple]] = {}
        # tables whose last incremental re-read failed: their deltas are
        # consumed (the tracker baseline advanced), so the next round
        # must run a full self-healing snapshot
        self._force_full: set = set()
        self._mu = threading.Lock()
        db.agent.add_round_listener(self._on_round)

    def attach(self, table: str) -> SubQueue:
        self.db.schema.table(table)  # raises on unknown table
        maxsize, shed_policy, shed_threshold = _serve_policy(self.serve)
        q = SubQueue(maxsize=maxsize, shed_policy=shed_policy,
                     shed_threshold=shed_threshold)
        with self._mu:
            if table not in self._feeds:
                self._state[table] = self._snapshot_table(table)
            self._feeds.setdefault(table, []).append(q)
        return q

    def detach(self, table: str, q: queue.Queue) -> None:
        with self._mu:
            if table in self._feeds and q in self._feeds[table]:
                self._feeds[table].remove(q)
                if not self._feeds[table]:
                    del self._feeds[table]
                    del self._state[table]
                    self._force_full.discard(table)

    def _snapshot_table(self, table: str) -> Dict[Any, Tuple]:
        t = self.db.schema.table(table)
        cols = [c.name for c in t.columns]
        sql = f"SELECT {', '.join(cols)} FROM {table}"
        _, rows = self.db.query(self.node, sql)
        pk_idx = cols.index(t.pk.name)
        return {row[pk_idx]: tuple(row) for row in rows}

    def _on_round(self, round_no: int) -> None:
        with self._mu:
            tables = list(self._feeds)
        if not tables:
            return
        try:
            cands = self._tracker.changed(self.node)
        except Exception:  # noqa: BLE001 — degrade to full snapshots
            logger.exception("delta tracking failed for node %s", self.node)
            cands = None
        for table in tables:
            force = table in self._force_full
            if cands is not None and table not in cands and not force:
                continue  # no applied change touched this table
            try:
                if cands is None or force:
                    # unknown delta (or recovering from a failed
                    # incremental read whose candidates are already
                    # consumed): full table snapshot + full diff
                    fresh = self._snapshot_table(table)
                    partial = None
                    # detach() also mutates _force_full from API
                    # threads — not single-writer, so take the lock
                    with self._mu:
                        self._force_full.discard(table)
                else:
                    # incremental: re-read only the candidate rows
                    # (read_row returns None for dead/absent rows)
                    t = self.db.schema.table(table)
                    cols = [c.name for c in t.columns]
                    partial = {}
                    for pk in cands[table]:
                        row = self.db.read_row(self.node, table, pk)
                        partial[pk] = (
                            tuple(row.get(c) for c in cols)
                            if row is not None else None
                        )
                    fresh = None
            except Exception:  # noqa: BLE001
                logger.exception("updates feed poll failed for %s", table)
                # the round's candidates are consumed (tracker baseline
                # advanced): self-heal with a full snapshot next round
                with self._mu:
                    self._force_full.add(table)
                continue
            with self._mu:
                old = self._state.get(table)
                if old is None:
                    continue
                events = []
                if partial is not None:
                    for pk, row in partial.items():
                        if row is None:
                            if pk in old:
                                events.append((DELETE, pk))
                                old.pop(pk, None)
                        elif pk not in old:
                            events.append((INSERT, pk))
                            old[pk] = row
                        elif old[pk] != row:
                            events.append((UPSERT, pk))
                            old[pk] = row
                else:
                    for pk, row in fresh.items():
                        if pk not in old:
                            events.append((INSERT, pk))
                        elif old[pk] != row:
                            events.append((UPSERT, pk))
                    for pk in old:
                        if pk not in fresh:
                            events.append((DELETE, pk))
                    self._state[table] = fresh
                subs = list(self._feeds.get(table, ()))
            lagged = []
            label = {"sub": f"updates:{table}"}
            for q in subs:
                refused = False
                for ev in events:
                    if not q.offer(("notify", ev)):
                        refused = True
                        break
                shed = q.drain_shed()
                if shed:
                    # shed-oldest drops (frame-accurate, like the
                    # matcher fanout)
                    self.db.agent.metrics.counter(
                        "corro.subs.shed_total", float(shed), label)
                if refused or q.lagged:
                    lagged.append(q)
            if events and subs:
                self.db.agent.metrics.gauge(
                    "corro.subs.queue.depth",
                    max(q.qsize() for q in subs), label)
            for q in lagged:
                if q.shed_policy != "shed-oldest":
                    # legacy drop-newest: the disconnect IS the shed
                    self.db.agent.metrics.counter(
                        "corro.subs.shed_total", 1.0, label)
                logger.warning("updates feed %s: disconnecting lagged "
                               "subscriber", table)
                self.detach(table, q)
