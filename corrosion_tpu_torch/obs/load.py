"""corroload: the seeded concurrent-client load harness (port of
``corrosion_tpu/obs/load.py``).

The reference serves whole fleets over its HTTP API, subscriptions and
PG-wire server; this repo's serving plane had only ever seen single
test clients. ``run_load`` drives it the way a fleet would — N open-loop
writers (``POST /v1/transactions``), M NDJSON subscribers measuring
write-commit -> delivery lag client-side, and K PG-wire readers speaking
the v3 simple-query protocol — against an in-process devcluster rig
(Agent + Database + ApiServer + PgServer), and reports client-side
p50/p95/p99 per op class, sustained QPS, and error/503 counts as a
``BENCH_SERVE`` record.

Determinism: the op streams come from :func:`plan_ops`, a pure function
of the seed — the record carries the plan digest that pins them. Wall
times obviously vary run to run; WHAT was issued does not.

The record's ``agreement`` section is the harness's own oracle: the
server-side ``corro.http.request.seconds`` / ``corro.pg.query.seconds``
histograms (scraped off ``/metrics`` and parsed back through
``utils.metrics.parse_exposition``) must count exactly the requests the
clients tallied. A lost or double-counted request fails the record.

CLI: ``python -m corrosion_tpu_torch load`` (``--output-json`` writes the
record). Every rig runs its agent on ``device`` (default ``"cuda"``, which
raises without a card; ``"cpu"`` runs the kernels' plain versions). The
JAX package's CLI turns on its persistent jit cache before a run; the port
compiles no programs, so there is no such call. ``CORROSAN=1`` (the
runtime sanitizer, ``analysis/``) is not ported and the CLI refuses it.

Two departures from the JAX package's ``run_overload``: a closed-loop op
that runs out of 503 retries is counted once in the client tally (the
JAX package's counts its last 503 twice, as a 503 attempt and as a failed
op, so such a run fails its agreement gate), and the closed loop's retry
count is a parameter (``closed_loop_retries``, JAX's 16 by default).
"""

from __future__ import annotations

import hashlib
import json
import random
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

BENCH_SERVE_SCHEMA = 1
BENCH_SERVE_OVERLOAD_SCHEMA = 1

LOAD_SCHEMA = (
    "CREATE TABLE load_kv (k TEXT PRIMARY KEY, v INTEGER, who TEXT);"
)
_STOP_KEY = "__stop__"


# --- seeded op planning (pure) -------------------------------------------
def plan_ops(seed: int, writers: int, write_ops: int, pg_readers: int,
             pg_ops: int, keys: int) -> dict:
    """The deterministic op plan: per-writer and per-reader key-index
    streams, derived only from ``seed`` (``random.Random`` — a stable
    algorithm across CPython versions). Returns
    ``{"writers": [[idx,...],...], "pg": [[idx,...],...], "digest"}``."""
    plan: Dict[str, Any] = {
        "writers": [
            [random.Random(seed * 7919 + w).randrange(keys)
             for _ in range(write_ops)]
            for w in range(writers)
        ],
        "pg": [
            [random.Random(seed * 104729 + 31 * r).randrange(keys)
             for _ in range(pg_ops)]
            for r in range(pg_readers)
        ],
    }
    digest = hashlib.sha256(
        json.dumps(plan, sort_keys=True).encode()
    ).hexdigest()[:16]
    plan["digest"] = digest
    return plan


def percentiles(samples: List[float],
                qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
    """Exact client-side percentiles (sorted-sample interpolation) —
    the client half of the client-vs-server latency story; the server
    half comes from bucketed ``quantiles_from_histogram``."""
    out: Dict[str, float] = {}
    if not samples:
        return {f"p{int(round(q * 100))}": 0.0 for q in qs}
    s = sorted(samples)
    n = len(s)
    for q in qs:
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        out[f"p{int(round(q * 100))}"] = s[lo] + (s[hi] - s[lo]) * (pos - lo)
    return out


# --- minimal PG v3 frontend (simple query only) --------------------------
class _PgClient:
    """Just enough of the PG wire protocol for the reader legs: startup,
    simple query, ReadyForQuery drain. (The image ships no PG client
    library; tests/test_pg.py speaks the same dialect.)"""

    def __init__(self, addr: str, port: int, database: str = "corrosion",
                 timeout: float = 30.0):
        self.sock = socket.create_connection((addr, port), timeout=timeout)
        payload = struct.pack("!I", 196608)
        for k, v in (("user", "corroload"), ("database", database)):
            payload += k.encode() + b"\x00" + v.encode() + b"\x00"
        payload += b"\x00"
        self.sock.sendall(struct.pack("!I", len(payload) + 4) + payload)
        self._drain()

    def close(self) -> None:
        try:
            self.sock.sendall(b"X" + struct.pack("!I", 4))
        finally:
            self.sock.close()

    def _read_exact(self, n: int) -> bytes:
        data = b""
        while len(data) < n:
            chunk = self.sock.recv(n - len(data))
            if not chunk:
                raise ConnectionResetError
            data += chunk
        return data

    def _drain(self) -> List[tuple]:
        msgs = []
        while True:
            kind = self._read_exact(1)
            (length,) = struct.unpack("!I", self._read_exact(4))
            payload = self._read_exact(length - 4)
            msgs.append((kind, payload))
            if kind == b"Z":
                return msgs

    def query(self, sql: str) -> List[List[Optional[str]]]:
        """Simple query; returns decoded text rows. Raises on an
        ErrorResponse (the reader legs only issue valid SELECTs)."""
        q = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack("!I", len(q) + 4) + q)
        rows: List[List[Optional[str]]] = []
        for kind, payload in self._drain():
            if kind == b"D":
                (n,) = struct.unpack("!H", payload[:2])
                off = 2
                row: List[Optional[str]] = []
                for _ in range(n):
                    (ln,) = struct.unpack("!i", payload[off:off + 4])
                    off += 4
                    if ln == -1:
                        row.append(None)
                    else:
                        row.append(payload[off:off + ln].decode())
                        off += ln
                rows.append(row)
            elif kind == b"E":
                raise RuntimeError(f"pg error for {sql!r}: {payload!r}")
        return rows


# --- the harness ---------------------------------------------------------
def run_load(writers: int = 4, subscribers: int = 2, pg_readers: int = 2,
             write_ops: int = 32, pg_ops: int = 32, keys: int = 12,
             seed: int = 0, n_nodes: int = 16, warm_rounds: int = 8,
             deadline_s: float = 120.0, device="cuda") -> dict:
    """Boot a devcluster rig, run the seeded concurrent-client load, and
    return the ``BENCH_SERVE`` record (see docs/observability.md)."""
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.api.http import ApiServer
    from corrosion_tpu_torch.client import ApiError, CorrosionApiClient
    from corrosion_tpu_torch.db import Database
    from corrosion_tpu_torch.pg import PgServer
    from corrosion_tpu_torch.testing import cluster_config
    from corrosion_tpu_torch.utils.lifecycle import spawn_counted
    from corrosion_tpu_torch.utils.metrics import (
        parse_exposition,
        quantiles_from_histogram,
    )

    plan = plan_ops(seed, writers, write_ops, pg_readers, pg_ops, keys)
    problems: List[str] = []

    # keyspace + stop marker + headroom must fit the row budget
    cfg = cluster_config(n_nodes=n_nodes, n_rows=keys + 4)

    # per-leg results: one pre-allocated slot per thread, read only
    # after join (no shared mutation)
    w_out: List[Optional[dict]] = [None] * writers
    s_out: List[Optional[dict]] = [None] * subscribers
    p_out: List[Optional[dict]] = [None] * pg_readers

    with Agent(cfg, device=device) as agent:
        agent.wait_rounds(warm_rounds, timeout=deadline_s)
        db = Database(agent)
        with ApiServer(db, port=0) as api, PgServer(db, port=0) as pgs:
            setup = CorrosionApiClient(api.addr, api.port)
            setup.schema([LOAD_SCHEMA])
            # pre-populate the keyspace so writers are pure UPDATEs
            # (fixed row budget; INSERT-vs-UPDATE split stays seeded)
            setup.execute([
                ("INSERT INTO load_kv (k, v, who) VALUES (?, ?, ?)",
                 [f"k{i}", 0, "seed"])
                for i in range(keys)
            ])
            setup_tx_posts = 1
            agent.wait_rounds(2, timeout=deadline_s)

            def subscriber(i: int) -> None:
                out = {"lags": [], "changes": 0, "errors": 0,
                       "ready": False}
                s_out[i] = out
                c = CorrosionApiClient(api.addr, api.port)
                try:
                    stream = c.subscribe("SELECT k, v, who FROM load_kv",
                                         stream_timeout=deadline_s)
                    for ev in stream:
                        if "eoq" in ev:
                            out["ready"] = True
                        ch = ev.get("change")
                        if ch is None:
                            continue
                        _kind, key, row, _cid = ch
                        if key == _STOP_KEY:
                            break
                        out["changes"] += 1
                        if row and isinstance(row[1], int) and row[1] > 0:
                            out["lags"].append(
                                max(0.0, (time.time_ns() - row[1]) / 1e9))
                except (TimeoutError, OSError, ApiError):
                    out["errors"] += 1

            def writer(i: int) -> None:
                out = {"lat": [], "errors": 0, "http_503": 0, "posts": 0}
                w_out[i] = out
                c = CorrosionApiClient(api.addr, api.port)
                for key_idx in plan["writers"][i]:
                    t0 = time.perf_counter()
                    try:
                        out["posts"] += 1
                        c.execute([(
                            "UPDATE load_kv SET v = ?, who = ? WHERE k = ?",
                            [time.time_ns(), f"w{i}", f"k{key_idx}"],
                        )])
                        out["lat"].append(time.perf_counter() - t0)
                    except ApiError as e:
                        if e.status == 503:
                            out["http_503"] += 1
                        else:
                            out["errors"] += 1
                    except OSError:
                        out["errors"] += 1

            def pg_reader(i: int) -> None:
                out = {"lat": [], "errors": 0, "queries": 0}
                p_out[i] = out
                try:
                    client = _PgClient(pgs.addr, pgs.port)
                except OSError:
                    out["errors"] += 1
                    return
                try:
                    for key_idx in plan["pg"][i]:
                        t0 = time.perf_counter()
                        try:
                            out["queries"] += 1
                            rows = client.query(
                                "SELECT k, v, who FROM load_kv "
                                f"WHERE k = 'k{key_idx}'")
                            out["lat"].append(time.perf_counter() - t0)
                            if len(rows) != 1 or rows[0][0] != f"k{key_idx}":
                                out["errors"] += 1
                        except (RuntimeError, OSError):
                            out["errors"] += 1
                finally:
                    try:
                        client.close()
                    except OSError:
                        pass

            t_start = time.perf_counter()
            threads = [
                spawn_counted(lambda i=i: subscriber(i),
                              name=f"corro-load-sub-{i}")
                for i in range(subscribers)
            ]
            # subscribers must be attached (initial snapshot drained)
            # before the first write or early deliveries are invisible
            deadline = time.monotonic() + deadline_s
            while not all(s and s["ready"] for s in s_out):
                if time.monotonic() > deadline:
                    problems.append("subscribers never reached eoq")
                    break
                time.sleep(0.01)
            threads += [
                spawn_counted(lambda i=i: writer(i),
                              name=f"corro-load-writer-{i}")
                for i in range(writers)
            ]
            threads += [
                spawn_counted(lambda i=i: pg_reader(i),
                              name=f"corro-load-pg-{i}")
                for i in range(pg_readers)
            ]
            for t in threads[subscribers:]:
                t.join(timeout=deadline_s)
            # stop marker: subscribers exit when its change delivers
            try:
                setup.execute([(
                    "INSERT INTO load_kv (k, v, who) VALUES (?, ?, ?)",
                    [_STOP_KEY, 0, "stop"],
                )])
                setup_tx_posts += 1
            except ApiError:
                problems.append("stop-marker write failed")
            agent.wait_rounds(3, timeout=deadline_s)
            for t in threads[:subscribers]:
                t.join(timeout=deadline_s)
            duration = time.perf_counter() - t_start
            if any(t.is_alive() for t in threads):
                problems.append("load legs did not finish before deadline")

            # --- server-side scrape + agreement -----------------------
            scrape = parse_exposition(setup.metrics())
            hist = scrape["histograms"]

            def server_count(name: str, **want: str) -> int:
                total = 0
                for (pname, labels), h in hist.items():
                    if pname != name:
                        continue
                    lab = dict(labels)
                    if all(lab.get(k) == v for k, v in want.items()):
                        total += h["count"]
                return total

            def server_hist(name: str, **want: str) -> dict:
                agg = {"buckets": (), "counts": [], "sum": 0.0, "count": 0}
                for (pname, labels), h in hist.items():
                    if pname != name:
                        continue
                    lab = dict(labels)
                    if not all(lab.get(k) == v for k, v in want.items()):
                        continue
                    if not agg["counts"]:
                        agg["buckets"] = h["buckets"]
                        agg["counts"] = list(h["counts"])
                    else:
                        agg["counts"] = [
                            a + b
                            for a, b in zip(agg["counts"], h["counts"])
                        ]
                    agg["sum"] += h["sum"]
                    agg["count"] += h["count"]
                return agg

            client_tx = (sum(w["posts"] for w in w_out if w)
                         + setup_tx_posts)
            server_tx = server_count("corro_http_request_seconds",
                                     route="/v1/transactions", method="POST")
            client_pg = sum(p["queries"] for p in p_out if p)
            server_pg = server_count("corro_pg_query_seconds", kind="select")
            agreement = {
                "transactions": {"client": client_tx, "server": server_tx,
                                 "ok": client_tx == server_tx},
                "pg_select": {"client": client_pg, "server": server_pg,
                              "ok": client_pg == server_pg},
            }
            agreement["ok"] = (agreement["transactions"]["ok"]
                               and agreement["pg_select"]["ok"])
            if not agreement["ok"]:
                problems.append(f"server/client count disagreement: "
                                f"{agreement}")

            w_lat = [x for w in w_out if w for x in w["lat"]]
            p_lat = [x for p in p_out if p for x in p["lat"]]
            s_lag = [x for s in s_out if s for x in s["lags"]]
            w_errors = sum(w["errors"] for w in w_out if w)
            p_errors = sum(p["errors"] for p in p_out if p)
            s_errors = sum(s["errors"] for s in s_out if s)
            if w_errors or p_errors or s_errors:
                problems.append(
                    f"client errors: write={w_errors} pg={p_errors} "
                    f"sub={s_errors}")
            if not s_lag and subscribers:
                problems.append("subscribers observed no deliveries")

            delivery_h = server_hist("corro_subs_delivery_seconds")
            record = {
                "schema": BENCH_SERVE_SCHEMA,
                "kind": "bench_serve",
                "seed": seed,
                "plan_digest": plan["digest"],
                "n_nodes": n_nodes,
                "writers": writers,
                "subscribers": subscribers,
                "pg_readers": pg_readers,
                "write_ops_per_writer": write_ops,
                "pg_ops_per_reader": pg_ops,
                "keys": keys,
                "duration_s": duration,
                "qps": ((len(w_lat) + len(p_lat)) / duration
                        if duration > 0 else 0.0),
                "ops": {
                    "write": dict(
                        percentiles(w_lat),
                        count=len(w_lat), errors=w_errors,
                        http_503=sum(w["http_503"] for w in w_out if w),
                        qps=(len(w_lat) / duration if duration else 0.0),
                    ),
                    "pg_query": dict(
                        percentiles(p_lat),
                        count=len(p_lat), errors=p_errors,
                        qps=(len(p_lat) / duration if duration else 0.0),
                    ),
                    "subscribe_delivery": dict(
                        percentiles(s_lag),
                        count=len(s_lag), errors=s_errors,
                        changes=sum(s["changes"] for s in s_out if s),
                    ),
                },
                "server": {
                    "tx_requests": server_tx,
                    "pg_selects": server_pg,
                    "deliveries": delivery_h["count"],
                    "delivery_quantiles_s":
                        quantiles_from_histogram(delivery_h)
                        if delivery_h["count"] else None,
                    "unready_total": sum(
                        v for (n, _l), v in scrape["counters"].items()
                        if n == "corro_http_unready_total"),
                    "shed_total": sum(
                        v for (n, _l), v in scrape["counters"].items()
                        if n == "corro_subs_shed_total"),
                },
                "agreement": agreement,
                "problems": problems,
                "ok": not problems,
            }
            return record


# --- corroguard overload mode (docs/overload.md) --------------------------
def plan_overload(seed: int, stages: Sequence[int], write_ops: int,
                  keys: int, closed_loop_ops: int) -> dict:
    """Deterministic overload plan: per-stage per-writer key-index
    streams plus the closed-loop client's stream, all pure in ``seed``."""
    plan: Dict[str, Any] = {
        "stages": [
            [
                [random.Random(seed * 7919 + 1009 * si + w).randrange(keys)
                 for _ in range(write_ops)]
                for w in range(n_writers)
            ]
            for si, n_writers in enumerate(stages)
        ],
        "closed_loop": [
            random.Random(seed * 104729 + 17).randrange(keys)
            for _ in range(closed_loop_ops)
        ],
    }
    digest = hashlib.sha256(
        json.dumps(plan, sort_keys=True).encode()
    ).hexdigest()[:16]
    plan["digest"] = digest
    return plan


class _CountingClient:
    """The closed-loop leg: a :class:`CorrosionApiClient` with
    ``retry_503`` enabled, instrumented so every 503 the retry engine
    absorbs is still visible to the harness's server/client agreement
    accounting (each shed attempt DID traverse the server's request
    histogram)."""

    def __init__(self, addr: str, port: int, retry_503: int,
                 retry_503_max_wait: float):
        from corrosion_tpu_torch.client import ApiUnavailable, CorrosionApiClient

        self.attempts_503 = 0
        self.retry_delays: List[float] = []
        harness = self

        class _Client(CorrosionApiClient):
            def _retry_connect(self, attempt):
                def counted():
                    try:
                        return attempt()
                    except ApiUnavailable as e:
                        harness.attempts_503 += 1
                        if e.retry_after is not None:
                            harness.retry_delays.append(
                                min(float(e.retry_after),
                                    self.retry_503_max_wait))
                        raise
                return super()._retry_connect(counted)

        self.client = _Client(addr, port, retry_503=retry_503,
                              retry_503_max_wait=retry_503_max_wait)


def _leaked_serving_threads() -> List[str]:
    """Names of still-alive serving-plane connection threads — must be
    empty once the servers' context managers have exited (the
    degradation contract's leak gate; CORROSAN covers fds/races)."""
    return sorted(
        t.name for t in threading.enumerate()
        if t.name.startswith(("corro-http-conn", "corro-pg-conn"))
    )


def run_overload(stages: Sequence[int] = (2, 4, 8), write_ops: int = 30,
                 subscribers: int = 4, slow_subs: int = 2,
                 slow_ms: float = 25.0, keys: int = 32,
                 closed_loop_ops: int = 24, pg_probes: int = 6,
                 pad_bytes: int = 1024, seed: int = 0, n_nodes: int = 16,
                 warm_rounds: int = 8, deadline_s: float = 240.0,
                 lag_bound_s: float = 2.5, closed_loop_think_s: float = 0.15,
                 closed_loop_retries: int = 16,
                 guard: bool = True, serve=None, device="cuda") -> dict:
    """Drive the serving plane to its breaking point and report whether
    the degradation contract held (docs/overload.md).

    Open-loop writer waves ramp through ``stages`` (each wave spawns
    that many writers, each issuing ``write_ops`` seeded UPDATEs with a
    ``time.time_ns()`` stamp in the row); ``subscribers`` fast plus
    ``slow_subs`` deliberately slow NDJSON subscribers measure
    client-observed delivery lag off those stamps; one closed-loop
    client retries 503s per the server's Retry-After hint (capped at
    0.25 s, at most ``closed_loop_retries`` times: a window that must
    outlast the heaviest stage, so it scales with how fast rounds commit)
    and must land every op. After each wave the server's cumulative shed
    counters are scraped — under guard they must rise monotonically with offered
    load while delivery lag stays under ``lag_bound_s``; without guard
    (``guard=False``) the slow subscribers' unbounded queues let lag
    diverge, which is the contract violation the bench exists to show.
    """
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.api.admission import AdmissionController
    from corrosion_tpu_torch.api.http import ApiServer
    from corrosion_tpu_torch.client import ApiError, CorrosionApiClient
    from corrosion_tpu_torch.config import ServeConfig
    from corrosion_tpu_torch.db import Database
    from corrosion_tpu_torch.pg import PgServer
    from corrosion_tpu_torch.testing import cluster_config
    from corrosion_tpu_torch.utils.lifecycle import spawn_counted
    from corrosion_tpu_torch.utils.metrics import parse_exposition

    if guard and serve is None:
        serve = ServeConfig(
            max_inflight=3, max_queue=3, queue_wait=0.05,
            max_streams=max(32, 2 * (subscribers + slow_subs)),
            retry_after_cap=5.0, shed_policy="shed-oldest",
            # small per-sub bound: a slow consumer only ever sees the
            # freshest ~sub_queue frames, so its observed lag is bounded
            # by sub_queue * service time instead of the whole backlog;
            # the sndbuf clamp keeps the kernel from hiding more backlog
            # behind the queue (frames are pad_bytes-sized on purpose)
            sub_queue=32, sub_shed_threshold=1 << 30,
            stream_sndbuf=4608,
        )
    elif not guard:
        # the EXPLICIT all-off opt-out: with measured non-zero
        # ServeConfig defaults, a bare None would hand the "unguarded"
        # arm the default guard and the A/B bench would prove nothing
        serve = ServeConfig.unlimited()

    plan = plan_overload(seed, stages, write_ops, keys, closed_loop_ops)
    problems: List[str] = []
    # writes carry a payload pad so NDJSON frames have realistic size:
    # a few KB of socket buffer then holds a few frames, not thousands
    # (which would let the kernel hide the whole backlog)
    pad = "x" * max(0, pad_bytes)
    n_subs = subscribers + slow_subs
    cfg = cluster_config(n_nodes=n_nodes, n_rows=keys + 4)

    s_out: List[Optional[dict]] = [None] * n_subs
    stage_out: List[List[Optional[dict]]] = [
        [None] * n for n in stages
    ]
    stage_stats: List[dict] = []

    with Agent(cfg, device=device) as agent:
        agent.wait_rounds(warm_rounds, timeout=deadline_s)
        db = Database(agent)
        admission = AdmissionController(serve, registry=agent.metrics)
        with ApiServer(db, port=0, serve=serve,
                       admission=admission) as api, \
                PgServer(db, port=0, admission=admission) as pgs:
            setup = CorrosionApiClient(api.addr, api.port)
            setup.schema([LOAD_SCHEMA])
            setup.execute([
                ("INSERT INTO load_kv (k, v, who) VALUES (?, ?, ?)",
                 [f"k{i}", 0, "seed"])
                for i in range(keys)
            ])
            setup_tx_posts = 1
            agent.wait_rounds(2, timeout=deadline_s)

            # warmup at peak concurrency BEFORE the measured window:
            # the first large concurrent write burst pays one-time costs
            # (the kernels' first load, allocations at the batch's
            # shape), which would otherwise land inside the lag
            # percentiles as a stall that has nothing to do with queueing
            n_warm = max(stages) + 1
            warm_posts = [0] * n_warm

            def _warm(i: int) -> None:
                c = CorrosionApiClient(api.addr, api.port)
                for j in range(3):
                    warm_posts[i] += 1  # attempts: 503 rejects count too
                    try:
                        c.execute([(
                            "UPDATE load_kv SET v = ?, who = ? WHERE k = ?",
                            [time.time_ns(), "warm" + pad,
                             f"k{(i + j) % keys}"],
                        )])
                    except (ApiError, OSError):
                        pass

            warm_threads = [
                spawn_counted(lambda i=i: _warm(i), name=f"corro-ovl-warm{i}")
                for i in range(n_warm)
            ]
            for t in warm_threads:
                t.join(timeout=deadline_s)
            setup_tx_posts += sum(warm_posts)
            agent.wait_rounds(2, timeout=deadline_s)

            def subscriber(i: int, slow: bool) -> None:
                out = {"lags": [], "changes": 0, "errors": 0,
                       "ready": False, "resyncs": 0, "dropped": 0,
                       "slow": slow, "rejected": False}
                s_out[i] = out
                c = CorrosionApiClient(api.addr, api.port)
                try:
                    stream = c.subscribe("SELECT k, v, who FROM load_kv",
                                         stream_timeout=deadline_s)
                    if slow:
                        # a slow consumer's receive window must not act
                        # as an invisible extra queue either
                        try:
                            stream._conn.sock.setsockopt(
                                socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
                        except (OSError, AttributeError):
                            pass
                    for ev in stream:
                        if "eoq" in ev:
                            out["ready"] = True
                        ch = ev.get("change")
                        if ch is None:
                            continue
                        if slow:
                            time.sleep(slow_ms / 1e3)
                        _kind, key, row, _cid = ch
                        if key == _STOP_KEY:
                            break
                        out["changes"] += 1
                        if row and isinstance(row[1], int) and row[1] > 0:
                            out["lags"].append(
                                max(0.0, (time.time_ns() - row[1]) / 1e9))
                    out["resyncs"] = stream.resyncs
                    out["dropped"] = stream.dropped
                except ApiError as e:
                    if e.status == 503:
                        out["rejected"] = True
                    else:
                        out["errors"] += 1
                except (TimeoutError, OSError):
                    out["errors"] += 1

            def writer(si: int, i: int) -> None:
                out = {"lat": [], "errors": 0, "http_503": 0, "posts": 0}
                stage_out[si][i] = out
                c = CorrosionApiClient(api.addr, api.port)
                for key_idx in plan["stages"][si][i]:
                    t0 = time.perf_counter()
                    try:
                        out["posts"] += 1
                        c.execute([(
                            "UPDATE load_kv SET v = ?, who = ? WHERE k = ?",
                            [time.time_ns(), f"s{si}w{i}" + pad,
                             f"k{key_idx}"],
                        )])
                        out["lat"].append(time.perf_counter() - t0)
                    except ApiError as e:
                        if e.status == 503:
                            out["http_503"] += 1
                        else:
                            out["errors"] += 1
                    except OSError:
                        out["errors"] += 1

            closed = _CountingClient(api.addr, api.port,
                                     retry_503=closed_loop_retries,
                                     retry_503_max_wait=0.25)
            # "exhausted": failed ops whose last attempt was a 503, which
            # ``closed.attempts_503`` already counts
            closed_out = {"done": 0, "failed": 0, "exhausted": 0, "lat": []}

            def closed_loop() -> None:
                from corrosion_tpu_torch.client import ApiError as _ApiError
                from corrosion_tpu_torch.client import ApiUnavailable as _Api503
                for key_idx in plan["closed_loop"]:
                    # think time paces the ops across the whole ramp so
                    # the closed loop meets the heavy stages too
                    time.sleep(closed_loop_think_s)
                    t0 = time.perf_counter()
                    try:
                        closed.client.execute([(
                            "UPDATE load_kv SET v = ?, who = ? WHERE k = ?",
                            [time.time_ns(), "closed" + pad,
                             f"k{key_idx}"],
                        )])
                        closed_out["done"] += 1
                        closed_out["lat"].append(time.perf_counter() - t0)
                    except _Api503:
                        closed_out["failed"] += 1
                        closed_out["exhausted"] += 1
                    except (_ApiError, OSError):
                        closed_out["failed"] += 1

            def pg_probe_wave() -> dict:
                """A burst of concurrent PG connections against the
                shared admission budget; counts how many the guard shed
                at startup (``SQLSTATE 53300`` closes the wire, which
                the minimal client sees as a reset)."""
                results = {"ok": 0, "shed": 0}
                mu = threading.Lock()

                def probe() -> None:
                    try:
                        c = _PgClient(pgs.addr, pgs.port, timeout=10.0)
                    except (OSError, ConnectionResetError):
                        with mu:
                            results["shed"] += 1
                        return
                    try:
                        c.query("SELECT k FROM load_kv WHERE k = 'k0'")
                        with mu:
                            results["ok"] += 1
                    except (RuntimeError, OSError):
                        with mu:
                            results["shed"] += 1
                    finally:
                        try:
                            c.close()
                        except OSError:
                            pass

                ts = [spawn_counted(probe, name=f"corro-ovl-pg-{j}")
                      for j in range(pg_probes)]
                for t in ts:
                    t.join(timeout=deadline_s)
                return results

            def counter_sum(scrape: dict, name: str, **want: str) -> float:
                total = 0.0
                for (pname, labels), v in scrape["counters"].items():
                    lab = dict(labels)
                    if pname == name and all(
                            lab.get(k) == w for k, w in want.items()):
                        total += v
                return total

            # attach all subscribers before the first wave
            sub_threads = [
                spawn_counted(
                    lambda i=i: subscriber(i, slow=i >= subscribers),
                    name=f"corro-ovl-sub-{i}")
                for i in range(n_subs)
            ]
            deadline = time.monotonic() + deadline_s
            while not all(
                    s and (s["ready"] or s["rejected"] or s["errors"])
                    for s in s_out):
                if time.monotonic() > deadline:
                    problems.append("subscribers never reached eoq")
                    break
                time.sleep(0.01)
            if any(s and s["rejected"] for s in s_out):
                problems.append("subscriber rejected at attach "
                                "(max_streams too small for the pool)")

            t_start = time.perf_counter()
            closed_thread = spawn_counted(closed_loop,
                                          name="corro-ovl-closed")
            pname = "corro_http_request_seconds"
            for si, n_writers in enumerate(stages):
                wave = [
                    spawn_counted(lambda si=si, i=i: writer(si, i),
                                  name=f"corro-ovl-w{si}-{i}")
                    for i in range(n_writers)
                ]
                for t in wave:
                    t.join(timeout=deadline_s)
                scrape = parse_exposition(setup.metrics())
                posts = sum(w["posts"] for w in stage_out[si] if w)
                http_503 = sum(w["http_503"] for w in stage_out[si] if w)
                stage_stats.append({
                    "stage": si,
                    "writers": n_writers,
                    "posts": posts,
                    "http_503": http_503,
                    # cumulative server-side pressure counters — the
                    # monotone half of the degradation contract
                    "admission_rejected_total": counter_sum(
                        scrape, "corro_admission_rejected_total"),
                    "subs_shed_total": counter_sum(
                        scrape, "corro_subs_shed_total"),
                    "unready_overloaded_total": counter_sum(
                        scrape, "corro_http_unready_total",
                        status="overloaded"),
                })
            pg_wave = pg_probe_wave()
            closed_thread.join(timeout=deadline_s)
            if closed_thread.is_alive():
                problems.append("closed-loop client did not finish")

            # stop marker: subscribers exit once it delivers (the slow
            # ones only after draining whatever backlog sits ahead)
            try:
                setup.execute([(
                    "INSERT INTO load_kv (k, v, who) VALUES (?, ?, ?)",
                    [_STOP_KEY, 0, "stop"],
                )])
                setup_tx_posts += 1
            except ApiError:
                problems.append("stop-marker write failed")
            agent.wait_rounds(3, timeout=deadline_s)
            for t in sub_threads:
                t.join(timeout=deadline_s)
            duration = time.perf_counter() - t_start
            if any(t.is_alive() for t in sub_threads):
                problems.append("subscriber legs did not finish")

            # --- final scrape + agreement ------------------------------
            scrape = parse_exposition(setup.metrics())
            server_tx = sum(
                h["count"] for (n, labels), h in
                scrape["histograms"].items()
                if n == pname and dict(labels).get(
                    "route") == "/v1/transactions")
            open_posts = sum(w["posts"] for wave_o in stage_out
                             for w in wave_o if w)
            client_tx = (open_posts + setup_tx_posts
                         + closed_out["done"] + closed_out["failed"]
                         - closed_out["exhausted"] + closed.attempts_503)
            agreement = {
                "transactions": {"client": client_tx, "server": server_tx,
                                 "ok": client_tx == server_tx},
            }
            agreement["ok"] = agreement["transactions"]["ok"]
            if not agreement["ok"]:
                problems.append(
                    f"server/client count disagreement: {agreement}")

    leaked = _leaked_serving_threads()
    if leaked:
        problems.append(f"leaked serving threads: {leaked}")

    all_lags = [x for s in s_out if s for x in s["lags"]]
    slow_lags = [x for s in s_out if s and s["slow"] for x in s["lags"]]
    lag_p = percentiles(all_lags)
    total_503 = (sum(st["http_503"] for st in stage_stats)
                 + closed.attempts_503)
    rejected_series = [st["admission_rejected_total"]
                       for st in stage_stats]
    shed_series = [st["subs_shed_total"] for st in stage_stats]
    pressure_series = [r + s for r, s in zip(rejected_series, shed_series)]
    shed_monotone = all(
        b >= a for a, b in zip(pressure_series, pressure_series[1:]))
    absorbed = (closed_out["failed"] == 0
                and closed_out["done"] == closed_loop_ops)
    lag_bounded = bool(all_lags) and lag_p["p99"] <= lag_bound_s
    contract = {
        "lag_bound_s": lag_bound_s,
        "delivery_p99_s": lag_p["p99"],
        "lag_bounded": lag_bounded,
        "shed_monotone": shed_monotone,
        "pressure_final": pressure_series[-1] if pressure_series else 0.0,
        "absorbed": absorbed,
        "ok": lag_bounded and shed_monotone and absorbed,
    }
    if guard and contract["pressure_final"] <= 0:
        problems.append("guarded run never shed: the ramp did not "
                        "overload the plane (raise stages/write_ops)")

    return {
        "schema": BENCH_SERVE_OVERLOAD_SCHEMA,
        "kind": "serve_overload",
        "seed": seed,
        "plan_digest": plan["digest"],
        "guard": guard,
        "serve": (None if serve is None else {
            "max_inflight": serve.max_inflight,
            "max_queue": serve.max_queue,
            "max_streams": serve.max_streams,
            "queue_wait": serve.queue_wait,
            "sub_queue": serve.sub_queue,
            "shed_policy": serve.shed_policy,
        }),
        "stages": list(stages),
        "write_ops_per_writer": write_ops,
        "subscribers": subscribers,
        "slow_subs": slow_subs,
        "slow_ms": slow_ms,
        "keys": keys,
        "n_nodes": n_nodes,
        "duration_s": duration,
        "stage_stats": stage_stats,
        "delivery_lag_s": dict(lag_p, count=len(all_lags)),
        "slow_delivery_lag_s": dict(percentiles(slow_lags),
                                    count=len(slow_lags)),
        "resyncs": sum(s["resyncs"] for s in s_out if s),
        "frames_dropped": sum(s["dropped"] for s in s_out if s),
        "http_503": total_503,
        "closed_loop": {
            "ops": closed_loop_ops,
            "done": closed_out["done"],
            "failed": closed_out["failed"],
            "retries": closed_loop_retries,
            "attempts_503": closed.attempts_503,
            "retry_delays": closed.retry_delays[:32],
            "lat": percentiles(closed_out["lat"]),
        },
        "pg_probe": pg_wave,
        "leaked_threads": leaked,
        "agreement": agreement,
        "contract": contract,
        "problems": problems,
        "ok": not problems and contract["ok"],
    }


def run_overload_bench(device="cuda", **kw) -> dict:
    """Both arms of the degradation-contract story, one record: the
    guarded plane must HOLD the contract (bounded p99 delivery lag,
    monotone shed counters, closed-loop client fully absorbed) while
    the identical ramp against the unguarded plane must VIOLATE it —
    otherwise the bench proves nothing about the guard."""
    guarded = run_overload(guard=True, device=device, **kw)
    unguarded = run_overload(guard=False, device=device, **kw)
    holds = bool(guarded["contract"]["ok"]
                 and guarded["contract"]["pressure_final"] > 0
                 and not guarded["problems"])
    violated = not unguarded["contract"]["lag_bounded"]
    return {
        "schema": BENCH_SERVE_OVERLOAD_SCHEMA,
        "kind": "bench_serve_overload",
        "seed": guarded["seed"],
        "plan_digest": guarded["plan_digest"],
        "guarded": guarded,
        "unguarded": unguarded,
        "contract_holds_guarded": holds,
        "contract_violated_unguarded": violated,
        "ok": holds and violated,
    }
