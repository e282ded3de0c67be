"""HTTP API client.

Mirrors ``crates/corro-client``: ``CorrosionApiClient`` with
``/v1/transactions`` execution, streaming ``/v1/queries`` (NDJSON), and
``SubscriptionStream`` with resume-from-ChangeId
(``corro-client/src/lib.rs:32``, ``sub.rs``).
"""

from __future__ import annotations

import http.client
import json
import urllib.parse
from typing import Any, Iterator, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.utils.backoff import Backoff, retry_call


class ApiError(RuntimeError):
    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        # the server's Retry-After hint (seconds, parsed off a 503) —
        # ``retry_call`` honors it over its own jittered schedule,
        # capped at the policy's max_wait (corroguard, docs/overload.md)
        self.retry_after = retry_after


class ApiUnavailable(ApiError):
    """503 from the serving plane: the agent is restoring/backing off
    (``/v1/ready`` machinery) or corroguard admission shed the request.
    Carries the Retry-After hint; a client built with ``retry_503 > 0``
    retries these through the shared ``retry_call`` policy."""


def _parse_retry_after(resp) -> Optional[float]:
    raw = resp.headers.get("Retry-After")
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _raise_for_status(resp, status: int, msg: str) -> None:
    if status == 503:
        raise ApiUnavailable(status, msg, _parse_retry_after(resp))
    raise ApiError(status, msg)


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict) and set(v) == {"blob"}:
        return bytes.fromhex(v["blob"])
    return v


def _encode_params(params: Any) -> Any:
    def enc(v):
        return {"blob": v.hex()} if isinstance(v, (bytes, bytearray)) else v

    if isinstance(params, dict):
        return {k: enc(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [enc(v) for v in params]
    return params


class _NdjsonStream:
    """Iterate parsed NDJSON events off an open HTTP response."""

    def __init__(self, conn: http.client.HTTPConnection,
                 resp: http.client.HTTPResponse):
        self._conn = conn
        self.resp = resp

    def __iter__(self) -> Iterator[dict]:
        try:
            for raw in self.resp:
                raw = raw.strip()
                if raw:
                    yield json.loads(raw)
        finally:
            self.close()

    def close(self) -> None:
        try:
            self._conn.close()
        except Exception:  # noqa: BLE001
            pass


class SubscriptionStream(_NdjsonStream):
    """A live subscription: tracks the matcher id + last seen ChangeId so
    the caller can reconnect with ``client.resubscribe(stream)``."""

    def __init__(self, conn, resp, sub_id: str,
                 last_change_id: Optional[int] = None):
        super().__init__(conn, resp)
        self.id = sub_id
        self.last_change_id = last_change_id
        # resync markers seen (corroguard shed — the stream has gaps
        # and the consumer should re-snapshot, docs/overload.md)
        self.resyncs = 0
        self.dropped = 0

    def __iter__(self) -> Iterator[dict]:
        for event in super().__iter__():
            if "change" in event:
                self.last_change_id = event["change"][3]
            elif "eoq" in event and isinstance(event["eoq"], dict):
                cid = event["eoq"].get("change_id")
                if cid is not None:
                    self.last_change_id = cid
            elif "resync" in event:
                self.resyncs += 1
                self.dropped += int(event["resync"].get("dropped", 0))
            yield event


class CorrosionApiClient:
    """Client for one agent's HTTP API."""

    def __init__(self, addr: str = "127.0.0.1", port: int = 8787,
                 timeout: float = 30.0, connect_retries: int = 2,
                 retry_503: int = 0, retry_503_max_wait: float = 2.0):
        self.addr = addr
        self.port = port
        self.timeout = timeout
        # connection-refused retries ride the shared retry_call policy:
        # a CLI racing agent boot (or an agent restarting under its
        # supervisor) answers after a brief jittered wait instead of
        # failing the one-shot command. Refused means nothing was sent,
        # so retrying is safe for writes too.
        self.connect_retries = connect_retries
        # corroguard closed-loop mode (docs/overload.md): retry_503 > 0
        # also retries 503s, sleeping the server's Retry-After hint
        # (capped at retry_503_max_wait) instead of the jittered
        # schedule. A 503 was a complete (rejected) exchange — nothing
        # committed — so retrying writes is safe too.
        self.retry_503 = retry_503
        self.retry_503_max_wait = retry_503_max_wait

    def _retry_connect(self, attempt):
        retry_on: tuple = (ConnectionRefusedError,)
        max_wait = 0.5
        retries = self.connect_retries
        if self.retry_503 > 0:
            retry_on = (ConnectionRefusedError, ApiUnavailable)
            max_wait = self.retry_503_max_wait
            retries = max(self.connect_retries, self.retry_503)
        return retry_call(
            attempt,
            backoff=Backoff(min_wait=0.05, max_wait=max_wait,
                            max_retries=retries),
            retry_on=retry_on,
        )

    # --- plumbing --------------------------------------------------------
    _UNSET = object()  # sentinel: None must mean "no timeout" (endless streams)

    def _connect(self, timeout=_UNSET) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(
            self.addr, self.port,
            timeout=self.timeout if timeout is self._UNSET else timeout,
        )

    def _request_json(self, method: str, path: str, body: Any = None) -> Any:
        payload = None if body is None else json.dumps(body)
        headers = {"Content-Type": "application/json"}
        # cross-process trace propagation (the reference injects
        # SyncTraceContextV1 into sync handshakes, sync.rs:33-67 +
        # peer/mod.rs:1017-1020); any active client span rides the
        # standard W3C header
        from corrosion_tpu_torch.utils.tracing import inject_traceparent

        tp = inject_traceparent()
        if tp:
            headers["traceparent"] = tp

        def attempt():
            conn = self._connect()
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                obj = json.loads(data) if data else None
                if resp.status >= 400:
                    msg = obj.get("error", data.decode()) if isinstance(
                        obj, dict) else data.decode()
                    _raise_for_status(resp, resp.status, msg)
                return obj
            finally:
                conn.close()

        return self._retry_connect(attempt)

    def _request_stream(self, method: str, path: str, body: Any = None,
                        stream_timeout=_UNSET):
        payload = None if body is None else json.dumps(body)
        headers = {"Content-Type": "application/json"}
        # streams join the same trace as one-shot requests: the server
        # wraps every route in a joined per-request span
        from corrosion_tpu_torch.utils.tracing import inject_traceparent

        tp = inject_traceparent()
        if tp:
            headers["traceparent"] = tp

        def attempt():
            conn = self._connect(timeout=stream_timeout)
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
            except BaseException:
                conn.close()
                raise
            if resp.status >= 400:
                data = resp.read()
                conn.close()
                try:
                    msg = json.loads(data).get("error", data.decode())
                except Exception:  # noqa: BLE001
                    msg = data.decode()
                _raise_for_status(resp, resp.status, msg)
            return conn, resp

        return self._retry_connect(attempt)

    @staticmethod
    def _stmts(statements: Sequence) -> list:
        out = []
        for s in statements:
            if isinstance(s, str):
                out.append(s)
            elif isinstance(s, (list, tuple)):
                sql = s[0]
                params = _encode_params(s[1]) if len(s) > 1 else None
                out.append([sql, params] if params is not None else sql)
            else:
                raise TypeError(f"bad statement: {s!r}")
        return out

    # --- API surface -----------------------------------------------------
    def execute(self, statements: Sequence, node: int = 0) -> List[dict]:
        """``POST /v1/transactions``."""
        obj = self._request_json(
            "POST", f"/v1/transactions?node={node}", self._stmts(statements)
        )
        return obj["results"]

    def query(self, sql: str, params: Any = None, node: int = 0
              ) -> Tuple[List[str], List[List[Any]]]:
        """``POST /v1/queries`` — returns (columns, rows), fully drained."""
        cols: List[str] = []
        rows: List[List[Any]] = []
        for event in self.query_stream(sql, params, node):
            if "columns" in event:
                cols = event["columns"]
            elif "row" in event:
                rows.append([_decode_value(v) for v in event["row"][1]])
            elif "error" in event:
                raise ApiError(500, event["error"])
        return cols, rows

    def query_stream(self, sql: str, params: Any = None, node: int = 0
                     ) -> _NdjsonStream:
        body = [sql, _encode_params(params)] if params is not None else sql
        conn, resp = self._request_stream(
            "POST", f"/v1/queries?node={node}", body)
        return _NdjsonStream(conn, resp)

    def subscribe(self, sql: str, params: Any = None, node: int = 0,
                  from_change_id: Optional[int] = None,
                  stream_timeout: Optional[float] = None
                  ) -> SubscriptionStream:
        """``POST /v1/subscriptions`` — an endless NDJSON event stream.

        ``stream_timeout`` bounds each socket read (None = wait
        forever): harness/test subscribers use it so a stalled stream
        surfaces as ``TimeoutError`` instead of a hung thread."""
        body = [sql, _encode_params(params)] if params is not None else sql
        path = f"/v1/subscriptions?node={node}"
        if from_change_id is not None:
            path += f"&from={from_change_id}"
        conn, resp = self._request_stream("POST", path, body,
                                          stream_timeout=stream_timeout)
        sub_id = resp.headers.get("corro-query-id", "")
        return SubscriptionStream(conn, resp, sub_id, from_change_id)

    def resubscribe(self, stream: SubscriptionStream) -> SubscriptionStream:
        """``GET /v1/subscriptions/{id}?from=`` — resume after disconnect."""
        path = f"/v1/subscriptions/{stream.id}"
        if stream.last_change_id is not None:
            path += f"?from={stream.last_change_id}"
        conn, resp = self._request_stream("GET", path, stream_timeout=None)
        return SubscriptionStream(conn, resp, stream.id,
                                  stream.last_change_id)

    def updates(self, table: str) -> _NdjsonStream:
        """``GET /v1/updates/{table}``."""
        conn, resp = self._request_stream(
            "GET", f"/v1/updates/{urllib.parse.quote(table)}",
            stream_timeout=None)
        return _NdjsonStream(conn, resp)

    def schema(self, schema_sql: Sequence[str]) -> List[list]:
        """``POST /v1/migrations``."""
        obj = self._request_json("POST", "/v1/migrations", list(schema_sql))
        return obj["results"]

    def table_stats(self, node: int = 0) -> dict:
        return self._request_json("GET", f"/v1/table_stats?node={node}")

    def members(self) -> list:
        return self._request_json("GET", "/v1/members")

    def sync_state(self, node: int = 0) -> dict:
        return self._request_json("GET", f"/v1/sync?node={node}")

    def metrics(self) -> str:
        conn = self._connect()
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            return resp.read().decode()
        finally:
            conn.close()
