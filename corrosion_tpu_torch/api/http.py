"""HTTP API server.

The reference's public REST surface (``crates/corro-agent/src/api/public/``,
router at ``agent/util.rs:182-294``), same routes and event shapes:

- ``POST /v1/transactions[?node=K]`` — JSON array of statements (each a
  string, ``[sql, params]`` pair, or ``{"query", "params"}``) executed as
  one transaction at writer node K; returns ``{"results": [...]}``
  (``api_v1_transactions``, ``public/mod.rs:177-256``).
- ``POST /v1/queries[?node=K]`` — one read-only statement; NDJSON stream
  of ``{"columns"}``, ``{"row": [rowid, values]}``, ``{"eoq"}`` events
  (``public/mod.rs:266-538``).
- ``POST /v1/subscriptions[?node=K&from=ID]`` — subscribe to a query;
  NDJSON stream (initial snapshot then ``{"change"}`` events); the
  matcher id is returned in the ``corro-query-id`` header.
  ``GET /v1/subscriptions/{id}[?from=ID]`` re-attaches, resuming from a
  ChangeId (``api/public/pubsub.rs:29-112``).
- ``GET /v1/updates/{table}`` — row-level NotifyEvent stream
  (``api/public/update.rs``).
- ``POST /v1/migrations`` — JSON array of schema SQL strings
  (``execute_schema``, ``public/mod.rs:540-593``).
- ``GET /v1/table_stats``, ``GET /v1/members``, ``GET /v1/sync`` —
  introspection (admin surface exposes the same data over UDS).
- ``GET /v1/obs/memory`` — per-table HBM audit of the live device state
  (``obs/memory.py``; metadata only, docs/observability.md).
- ``GET /metrics`` — Prometheus exposition (the reference serves this on
  the telemetry listener, ``command/agent.rs:114-139``); a running
  soak advances the ``corro.soak.*`` series here live.

Statement values ride JSON; blobs are not representable in JSON and use
``{"blob": "<hex>"}`` wrappers on both paths.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional, Tuple

from corrosion_tpu_torch.api.admission import AdmissionController, route_class
from corrosion_tpu_torch.db.database import SqlError
from corrosion_tpu_torch.db.schema import SchemaError
from corrosion_tpu_torch.pubsub import SubsManager, UpdatesManager
from corrosion_tpu_torch.utils.lifecycle import DrainingConnMixin
from corrosion_tpu_torch.utils.tracing import inject_traceparent, logger, span


class _DrainingHTTPServer(DrainingConnMixin, ThreadingHTTPServer):
    _conn_name = "corro-http-conn"

# fixed route templates: request metrics label by TEMPLATE,
# never by raw path — subscription ids and table names in the path (or
# arbitrary 404 probes) would otherwise mint unbounded label cardinality
_FIXED_ROUTES = frozenset({
    "/v1/transactions", "/v1/queries", "/v1/migrations",
    "/v1/subscriptions", "/v1/health", "/v1/ready", "/v1/table_stats",
    "/v1/members", "/v1/sync", "/v1/obs/memory", "/metrics",
})


def route_label(path: str) -> str:
    """Collapse a request path onto its route template."""
    if path in _FIXED_ROUTES:
        return path
    if path.startswith("/v1/subscriptions/"):
        return "/v1/subscriptions/{id}"
    if path.startswith("/v1/updates/"):
        return "/v1/updates/{table}"
    return "unmatched"


def _encode_value(v: Any) -> Any:
    if isinstance(v, bytes):
        return {"blob": v.hex()}
    return v


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict) and set(v) == {"blob"}:
        return bytes.fromhex(v["blob"])
    return v


def _decode_params(params: Any) -> Any:
    if isinstance(params, dict):
        return {k: _decode_value(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_decode_value(v) for v in params]
    return params


def parse_statements(body: Any) -> List[Tuple[str, Any]]:
    """JSON statement forms -> (sql, params) pairs (corro-api-types
    ``Statement``: Simple / WithParams / WithNamedParams)."""
    out: List[Tuple[str, Any]] = []
    for stmt in body:
        if isinstance(stmt, str):
            out.append((stmt, None))
        elif isinstance(stmt, list):
            sql = stmt[0]
            params = _decode_params(stmt[1]) if len(stmt) > 1 else None
            out.append((sql, params))
        elif isinstance(stmt, dict):
            out.append((stmt["query"], _decode_params(stmt.get("params"))))
        else:
            raise SqlError(f"bad statement shape: {type(stmt).__name__}")
    return out


class ApiServer:
    """HTTP listener bound to one Database (+ its Agent)."""

    def __init__(self, db, addr: str = "127.0.0.1", port: int = 0,
                 default_node: int = 0, subs: Optional[SubsManager] = None,
                 updates: Optional[UpdatesManager] = None, serve=None,
                 admission: Optional[AdmissionController] = None):
        self.db = db
        self.agent = db.agent
        self.default_node = default_node
        # corroguard (docs/overload.md): ``serve`` is the [serve] config
        # section (queue bounds + admission limits); ``admission`` lets a
        # PgServer share ONE controller so both listeners shed against
        # the same per-class budgets
        self.serve = serve
        self.admission = admission or AdmissionController(
            serve, registry=db.agent.metrics)
        self.subs = subs or SubsManager(db, serve=serve)
        self.updates = updates or UpdatesManager(db, serve=serve)
        handler = _make_handler(self)
        self.httpd = _DrainingHTTPServer((addr, port), handler)
        self.addr, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        # stop() raises this so streaming handlers (which otherwise
        # poll their queue forever on a quiet subscription) exit within
        # one poll period and the connection drain stays graceful
        self._stopping = threading.Event()

    def start(self) -> "ApiServer":
        from corrosion_tpu_torch.utils.lifecycle import spawn_counted

        # counted + corro- named: stop() drains serve_forever
        # and joins, so the shutdown barrier and the sanitizer's leak
        # gate both see an attributable, finishing thread
        self._thread = spawn_counted(
            self.httpd.serve_forever, name="corro-api-http"
        )
        return self

    def stop(self) -> None:
        self._stopping.set()
        self.httpd.shutdown()
        self.httpd.drain_connections()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def _make_handler(server: ApiServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # per-request accounting (reset by _serve; a keep-alive
        # connection reuses one Handler instance across requests)
        _code = 0
        _resp_bytes = 0

        def log_message(self, fmt, *args):  # route to our logger
            logger.debug("http: " + fmt, *args)

        def send_response(self, code, message=None):
            self._code = code
            super().send_response(code, message)

        # --- helpers -----------------------------------------------------
        def _json_body(self) -> Any:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b""
            return json.loads(raw) if raw else None

        def _reply_json(self, code: int, obj: Any,
                        headers: Optional[dict] = None) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
            self._resp_bytes += len(data)

        def _reply_error(self, code: int, msg: str) -> None:
            self._reply_json(code, {"error": msg})

        def _start_ndjson(self, headers: Optional[dict] = None) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()

        def _ndjson_line(self, obj: Any) -> None:
            self._write_frame(json.dumps(obj).encode() + b"\n")

        def _write_frame(self, data: bytes) -> None:
            """One NDJSON line, pre-encoded: the chunked framing around
            the multicast bytes the batched fanout cached (the hot path
            writes frames verbatim instead of re-encoding per
            subscriber — corroguard, docs/overload.md)."""
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()
            self._resp_bytes += len(data)

        def _end_chunks(self) -> None:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        def _route(self) -> Tuple[str, dict]:
            parsed = urllib.parse.urlparse(self.path)
            q = {k: v[-1] for k, v in
                 urllib.parse.parse_qs(parsed.query).items()}
            return parsed.path.rstrip("/"), q

        def _node(self, q: dict) -> int:
            return int(q.get("node", server.default_node))

        # --- instrumented dispatch ----------------------------
        def do_POST(self):
            self._serve("POST")

        def do_GET(self):
            self._serve("GET")

        def _serve(self, method: str) -> None:
            """Every route rides one instrumented envelope: a joined
            per-request span (the ``sync.serve`` traceparent pattern
            extended to the whole surface — a client write traces
            through commit into fanout), the per-{route, method, code}
            latency histogram, the in-flight gauge, and request/response
            byte counters. Streaming routes observe their full stream
            lifetime — that IS the request latency for an NDJSON feed."""
            path, q = self._route()
            route = route_label(path)
            metrics = server.agent.metrics
            self._code = 0
            self._resp_bytes = 0
            req_bytes = int(self.headers.get("Content-Length") or 0)
            metrics.gauge_add("corro.http.inflight", 1)
            t0 = time.perf_counter()
            # corroguard admission (docs/overload.md): every route
            # except the control plane takes a per-class slot before
            # dispatch; a shed request still rides the full metrics
            # envelope below (the 503 is a served request — the
            # server-vs-client agreement gates count it)
            cls = route_class(route, method)
            admitted = cls is None or server.admission.admit(cls)
            try:
                if not admitted:
                    self._reject_overloaded(cls, route)
                else:
                    with span(f"http.{method.lower()}.{route}",
                              traceparent=self.headers.get("traceparent"),
                              route=route, method=method):
                        if method == "POST":
                            self._dispatch_post(path, q)
                        else:
                            self._dispatch_get(path, q)
            except (SqlError, SchemaError, ValueError, KeyError) as e:
                self._reply_error(400, str(e))
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001
                logger.exception("http handler error")
                try:
                    self._reply_error(500, str(e))
                except Exception:  # noqa: BLE001 — headers may be gone
                    pass
            finally:
                if admitted and cls is not None:
                    server.admission.release(cls)
                dt = time.perf_counter() - t0
                metrics.gauge_add("corro.http.inflight", -1)
                metrics.histogram(
                    "corro.http.request.seconds", dt,
                    {"route": route, "method": method,
                     "code": str(self._code or 0)})
                if req_bytes:
                    metrics.counter(
                        "corro.http.request.bytes", float(req_bytes),
                        {"route": route, "method": method})
                if self._resp_bytes:
                    metrics.counter(
                        "corro.http.response.bytes", float(self._resp_bytes),
                        {"route": route, "method": method})

        def _dispatch_post(self, path: str, q: dict) -> None:
            if path == "/v1/transactions":
                self._transactions(q)
            elif path == "/v1/queries":
                self._queries(q)
            elif path == "/v1/migrations":
                self._migrations()
            elif path == "/v1/subscriptions":
                self._subscribe_new(q)
            else:
                self._reply_error(404, f"no such route: POST {path}")

        def _dispatch_get(self, path: str, q: dict) -> None:
            if path in ("/v1/health", "/v1/ready"):
                self._health()
            elif path == "/v1/table_stats":
                self._reply_json(
                    200, server.db.table_stats(self._node(q)))
            elif path == "/v1/members":
                self._reply_json(200, server.agent.members())
            elif path == "/v1/sync":
                node = self._node(q)
                # serve_sync answers inside its own joined span
                # (sync.rs:33-67 + peer/mod.rs:1414-1416), nested under
                # the request span; the server span id is returned so
                # the caller can link both sides
                with span("sync.serve",
                          traceparent=self.headers.get("traceparent")):
                    state = server.agent.sync_state(node)
                    state["traceparent"] = inject_traceparent()
                self._reply_json(200, state)
            elif path == "/v1/obs/memory":
                # per-table HBM audit of the live state:
                # array metadata only, never a device transfer —
                # cheap enough to poll while a 1M-node soak runs
                self._reply_json(200, server.agent.memory_report())
            elif path == "/metrics":
                data = server.agent.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                self._resp_bytes += len(data)
            elif path.startswith("/v1/subscriptions/"):
                self._subscribe_existing(path.rsplit("/", 1)[1], q)
            elif path.startswith("/v1/updates/"):
                self._updates_feed(path.rsplit("/", 1)[1])
            else:
                self._reply_error(404, f"no such route: GET {path}")

        # --- route bodies ------------------------------------------------
        def _reject_overloaded(self, cls: str, route: str) -> None:
            """corroguard shed: 503 + a Retry-After derived from the
            LIVE latency histograms (p95 × requests ahead, clamped),
            riding the same unready accounting the ``/v1/ready``
            machinery established (docs/overload.md)."""
            ra = server.admission.retry_after(cls)
            metrics = server.agent.metrics
            metrics.counter("corro.http.unready_total", 1.0,
                            {"status": "overloaded"})
            metrics.histogram("corro.http.retry_after.seconds", float(ra))
            self._reply_json(
                503,
                {"error": "overloaded", "class": cls, "route": route,
                 "retry_after": ra},
                headers={"Retry-After": str(ra)})

        def _health(self) -> None:
            """``/v1/health`` and ``/v1/ready`` (both route here — the
            two names exist for orchestrator convention; this agent has
            no alive-but-not-ready phase they could distinguish).

            Degrades gracefully instead of lying: while the agent is
            restoring a checkpoint or the watchdog supervisor is backing
            off between dispatch retries, the reply is 503 with a
            ``Retry-After`` hint so load balancers drain politely and
            clients (whose retries ride the shared ``retry_call``
            policy) know when to come back. Once the agent is shut down
            for good the 503 carries no ``Retry-After``: nothing will
            recover — restart instead of waiting."""
            h = server.agent.health()
            ok = h["ready"]
            headers = {}
            if not ok and h["status"] != "down":
                headers["Retry-After"] = str(h.get("retry_after", 1))
            if not ok:
                # readiness shedding is measurable: the
                # future admission-control PR needs a baseline of how
                # often — and for how long — the plane turned clients
                # away while restoring / backing off
                metrics = server.agent.metrics
                metrics.counter("corro.http.unready_total", 1.0,
                                {"status": h["status"]})
                if "Retry-After" in headers:
                    metrics.histogram("corro.http.retry_after.seconds",
                                      float(headers["Retry-After"]))
            self._reply_json(200 if ok else 503, h, headers=headers)

        def _transactions(self, q: dict) -> None:
            stmts = parse_statements(self._json_body() or [])
            results = server.db.execute(self._node(q), stmts)
            self._reply_json(200, {"results": [dict(r) for r in results]})

        def _queries(self, q: dict) -> None:
            body = self._json_body()
            stmts = parse_statements([body])
            sql, params = stmts[0]
            cols, rows = server.db.query(self._node(q), sql, params)
            self._start_ndjson()
            self._ndjson_line({"columns": cols})
            for i, row in enumerate(rows):
                self._ndjson_line(
                    {"row": [i + 1, [_encode_value(v) for v in row]]}
                )
            self._ndjson_line({"eoq": {}})
            self._end_chunks()

        def _migrations(self) -> None:
            body = self._json_body() or []
            if isinstance(body, str):
                body = [body]
            changes = []
            for sql in body:
                changes.extend(server.db.apply_schema_sql(sql))
            self._reply_json(200, {"results": [list(c) for c in changes]})

        def _subscribe_new(self, q: dict) -> None:
            body = self._json_body()
            sql, params = parse_statements([body])[0]
            from_id = int(q["from"]) if "from" in q else None
            matcher, _created = server.subs.subscribe(
                self._node(q), sql, params)
            self._stream_matcher(matcher, from_id)

        def _subscribe_existing(self, sub_id: str, q: dict) -> None:
            matcher = server.subs.get(sub_id)
            if matcher is None:
                self._reply_error(404, f"no such subscription: {sub_id}")
                return
            from_id = int(q["from"]) if "from" in q else None
            self._stream_matcher(matcher, from_id)

        def _clamp_stream_socket(self) -> None:
            """Bound the kernel half of the delivery pipeline: the
            per-sub queue only bounds a slow consumer's lag if the
            socket send buffer behind it can't silently absorb the
            backlog (docs/overload.md)."""
            sndbuf = getattr(server.serve, "stream_sndbuf", 0) or 0
            if sndbuf > 0:
                try:
                    self.connection.setsockopt(
                        socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
                except OSError:
                    pass

        def _stream_matcher(self, matcher, from_id: Optional[int]) -> None:
            sub_q = matcher.attach(from_change_id=from_id)
            self._clamp_stream_socket()
            self._start_ndjson({"corro-query-id": matcher.id})
            try:
                while not (server.agent.tripwire.tripped
                           or server._stopping.is_set()):
                    try:
                        kind, payload = sub_q.get(timeout=1.0)
                    except queue.Empty:
                        if sub_q.lagged:
                            # slow consumer disconnected by the fanout:
                            # the stream's last line is an explicit
                            # resync marker — the client must re-snapshot
                            # (docs/overload.md resync contract)
                            self._resync_marker(
                                sub_q.take_resync(), matcher,
                                "slow-consumer")
                            break
                        continue
                    # shed-oldest drops leave a gap in the change-id
                    # sequence: announce it BEFORE the next event so the
                    # client knows the stream skipped ahead
                    dropped = sub_q.take_resync()
                    if dropped:
                        self._resync_marker(dropped, matcher,
                                            "shed-oldest")
                    if kind == "columns":
                        self._ndjson_line({"columns": payload})
                    elif kind == "row":
                        key, row = payload
                        self._ndjson_line(
                            {"row": [_encode_value(key),
                                     [_encode_value(v) for v in row]]}
                        )
                    elif kind == "eoq":
                        self._ndjson_line({"eoq": {"change_id": payload}})
                    elif kind == "change":
                        cid, ckind, key, row = payload
                        # batched fanout: multicast the frame the matcher
                        # encoded once for ALL subscribers; encode only
                        # when the cache already trimmed past this id
                        frame = matcher.wire_frame(cid)
                        if frame is None:
                            frame = json.dumps({"change": [
                                ckind, _encode_value(key),
                                None if row is None
                                else [_encode_value(v) for v in row],
                                cid,
                            ]}).encode() + b"\n"
                        self._write_frame(frame)
                        self._observe_delivery(matcher, key)
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                matcher.detach(sub_q)

        def _resync_marker(self, dropped: int, matcher, reason: str
                           ) -> None:
            """The catch-up resync marker (docs/overload.md): the
            stream shed frames (or is disconnecting a slow consumer) —
            the client must re-snapshot, or re-attach with
            ``?from=<last delivered id>`` to replay the gap from the
            retained change log."""
            self._ndjson_line({"resync": {
                "dropped": int(dropped),
                "change_id": matcher.last_change_id,
                "reason": reason,
            }})

        def _observe_delivery(self, matcher, key) -> None:
            """Write-commit -> NDJSON delivery latency: the change event
            just went out on the wire; diff against the commit stamp the
            Database recorded for its (table, pk). Composite JOIN keys
            observe the first component carrying a stamp (the write that
            triggered the event)."""
            keys = key if isinstance(key, tuple) else (key,)
            now = time.perf_counter()
            for table, pk in zip(matcher.delivery_tables, keys):
                t = server.db.write_stamp(table, pk)
                if t is not None:
                    server.agent.metrics.histogram(
                        "corro.subs.delivery.seconds", max(0.0, now - t))
                    return

        def _updates_feed(self, table: str) -> None:
            feed_q = server.updates.attach(table)
            self._clamp_stream_socket()
            self._start_ndjson()
            try:
                while not (server.agent.tripwire.tripped
                           or server._stopping.is_set()):
                    try:
                        kind, payload = feed_q.get(timeout=1.0)
                    except queue.Empty:
                        if feed_q.lagged:
                            # same resync contract as subscriptions
                            self._ndjson_line({"resync": {
                                "dropped": feed_q.take_resync(),
                                "reason": "slow-consumer"}})
                            break
                        continue
                    dropped = feed_q.take_resync()
                    if dropped:
                        self._ndjson_line({"resync": {
                            "dropped": dropped, "reason": "shed-oldest"}})
                    ckind, pk = payload
                    self._ndjson_line({"notify": [ckind, _encode_value(pk)]})
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                server.updates.detach(table, feed_q)

    return Handler
