"""Tracing: spans, slow-span warnings, W3C trace-context propagation.

The reference runs ``tracing`` everywhere with an optional OpenTelemetry
OTLP pipeline (``crates/corrosion/src/main.rs:57-150``) and propagates
trace context **across nodes inside the sync protocol** —
``SyncTraceContextV1 {traceparent, tracestate}`` implements the otel
Injector/Extractor (``crates/corro-types/src/sync.rs:33-67``), injected by
the sync client (``api/peer/mod.rs:1017-1020``) and extracted by the
server (``peer/mod.rs:1414-1416``).

Here: a dependency-free span implementation logging through ``logging``,
a W3C ``traceparent`` codec for the same cross-agent propagation (the
host sync harness passes it peer to peer), an **OTLP/JSON file
exporter** (the OTLP pipeline analog in a zero-egress environment:
spans serialize in the OpenTelemetry OTLP-JSON ``resourceSpans`` shape,
one export batch per line, consumable by any OTLP tooling), and a
dynamic level filter reloadable at runtime through the admin socket
(the reference's ``LogCommand``, ``corro-admin/src/lib.rs:129-132``).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import secrets
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

logger = logging.getLogger("corrosion_tpu_torch")

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "corro_span", default=None
)


@dataclass
class SpanContext:
    """W3C trace-context ids (``SyncTraceContextV1`` analog)."""

    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    parent_span_id: str = ""  # 16 hex chars, "" at the trace root

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @staticmethod
    def from_traceparent(tp: Optional[str]) -> Optional["SpanContext"]:
        if not tp:
            return None
        parts = tp.split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        try:  # ids must be hex or they would poison strict OTLP consumers
            int(parts[1], 16), int(parts[2], 16)
        except ValueError:
            return None
        return SpanContext(trace_id=parts[1], span_id=parts[2])


# --- OTLP/JSON file exporter ---------------------------------------------

class OtlpFileExporter:
    """Buffers finished spans and appends OTLP-JSON export batches
    (``resourceSpans`` shape) to a file — the agent's OpenTelemetry
    pipeline (``corrosion/src/main.rs:57-150``) pointed at a file
    instead of a collector socket."""

    def __init__(self, path: str, service_name: str = "corrosion-tpu",
                 flush_every: int = 64):
        self.path = path
        self.service_name = service_name
        self.flush_every = flush_every
        self._mu = threading.Lock()
        self._buf: List[dict] = []

    def export(self, span_record: dict) -> None:
        with self._mu:
            self._buf.append(span_record)
            ready = len(self._buf) >= self.flush_every
        if ready:
            self.flush()

    MAX_BUFFERED = 4096  # retained spans across failed flushes

    def flush(self) -> None:
        # detach the pending batch under the lock, write it OUTSIDE —
        # exporting threads must never stall behind a slow disk
        # (lock-discipline: no IO under self._mu). Concurrent flushes
        # may interleave batches in the file; span order within a batch
        # is preserved, which is all OTLP consumers assume.
        with self._mu:
            pending, self._buf = self._buf, []
        if not pending:
            return
        batch = {
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name},
                }]},
                "scopeSpans": [{
                    "scope": {"name": "corrosion_tpu_torch"},
                    "spans": pending,
                }],
            }]
        }
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(batch) + "\n")
        except OSError:
            # keep the batch for the next flush attempt (bounded so a
            # permanently broken path cannot grow without limit)
            logger.exception("OTLP file export failed; retaining batch")
            with self._mu:
                self._buf = (pending + self._buf)[-self.MAX_BUFFERED:]


_exporter: Optional[OtlpFileExporter] = None


def configure_otlp_file(path: Optional[str], service_name: str = "corrosion-tpu"):
    """Install (or, with ``None``, remove) the OTLP file exporter."""
    global _exporter
    if _exporter is not None:
        _exporter.flush()
    _exporter = OtlpFileExporter(path, service_name) if path else None
    return _exporter


def flush_otlp() -> None:
    if _exporter is not None:
        _exporter.flush()


def current_span() -> Optional[SpanContext]:
    return _current_span.get()


def inject_traceparent() -> Optional[str]:
    """For the sync client: current context -> wire field."""
    ctx = current_span()
    return ctx.to_traceparent() if ctx else None


@contextlib.contextmanager
def span(name: str, traceparent: Optional[str] = None, warn_seconds: float = 1.0,
         **attrs):
    """A timed span; nests under the current one or under an extracted
    remote parent (the sync server path)."""
    parent = SpanContext.from_traceparent(traceparent) or current_span()
    ctx = SpanContext(
        trace_id=parent.trace_id if parent else secrets.token_hex(16),
        span_id=secrets.token_hex(8),
        parent_span_id=parent.span_id if parent else "",
    )
    token = _current_span.set(ctx)
    start_ns = time.time_ns()
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        dt = time.perf_counter() - t0
        _current_span.reset(token)
        level = logging.WARNING if dt > warn_seconds else logging.DEBUG
        logger.log(
            level,
            "span %s took %.3fs trace=%s span=%s %s",
            name, dt, ctx.trace_id[:8], ctx.span_id,
            " ".join(f"{k}={v}" for k, v in attrs.items()),
        )
        if _exporter is not None:
            _exporter.export({
                "traceId": ctx.trace_id,
                "spanId": ctx.span_id,
                **({"parentSpanId": ctx.parent_span_id}
                   if ctx.parent_span_id else {}),
                "name": name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(start_ns + int(dt * 1e9)),
                "attributes": [
                    {"key": k, "value": {"stringValue": str(v)}}
                    for k, v in attrs.items()
                ],
            })


def set_level(level: str):
    """Dynamic log filter reload (admin ``LogCommand`` analog)."""
    logger.setLevel(getattr(logging, level.upper()))
