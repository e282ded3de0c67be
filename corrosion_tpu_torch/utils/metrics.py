"""Metrics registry with Prometheus text exposition.

The reference records ~100 series through the ``metrics`` crate facade and
exposes them via a Prometheus HTTP exporter with curated buckets
(``crates/corrosion/src/command/agent.rs:114-139``; series documented in
``doc/telemetry/prometheus.md``). Here the same facade: counters, gauges,
and histograms keyed by name + sorted labels, a global registry, and a
text-format renderer; the host agent serves it at ``/metrics``.

The simulator's round ``info`` dicts map onto ``corro.*`` names via
``record_round_info`` — the analog of the metrics calls sprinkled through
the reference's loops (gossip ``broadcast/mod.rs:296-312``, changes-queue
``handlers.rs:636-638``, sync ``api/peer/mod.rs:975-987``).
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Latency-appropriate default ladder: log-spaced 1/2.5/5 per
# decade from 100 µs to 10 s. The serving plane observes sub-millisecond
# host operations (a PG catalog probe, a cached read) next to multi-
# second streams — the old 1 ms floor folded everything fast into one
# bucket and made the quantile estimator blind below it.
_DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)
# public alias for callers that override per histogram and want the
# standard ladder as a base
LATENCY_BUCKETS = _DEFAULT_BUCKETS


def _key(name: str, labels: Optional[dict]) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return name, tuple(sorted((labels or {}).items()))


def _escape_label_value(v) -> str:
    """Exposition-format label escaping: a raw ``"``, ``\\`` or newline
    in a label value corrupts the whole scrape (the parser sees a torn
    line), so they must be escaped exactly per the text format v0.0.4
    spec: ``\\`` -> ``\\\\``, ``"`` -> ``\\"``, LF -> ``\\n``."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_le(b) -> str:
    """Canonical ``le`` bucket-bound rendering: raw ``str(float)`` emits
    forms like ``1.0`` where the canonical exposition (and every
    upstream client library) writes ``1``. Shortest ROUND-TRIP form
    (``repr``), not ``%g`` — ``%g``'s 6-significant-digit truncation
    could collide two distinct bounds into duplicate ``le`` labels."""
    s = repr(float(b))
    return s[:-2] if s.endswith(".0") else s


class Registry:
    """Thread-safe metrics store (one per agent; a global default)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict = {}
        self._gauges: Dict = {}
        self._histograms: Dict = {}
        # bucket ladder per histogram NAME (not per label set): every
        # label combination of one metric family must share one `le`
        # ladder or the exposition is unqueryable (and strict parsers
        # reject the family) — see histogram() below
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}

    def counter(self, name: str, value: float = 1.0, labels: Optional[dict] = None):
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge(self, name: str, value: float, labels: Optional[dict] = None):
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def gauge_add(self, name: str, delta: float, labels: Optional[dict] = None):
        """Additive gauge update (in-flight request counts and other
        up/down levels; Prometheus gauges support both set and add)."""
        k = _key(name, labels)
        with self._lock:
            self._gauges[k] = self._gauges.get(k, 0.0) + float(delta)

    def histogram(
        self,
        name: str,
        value: float,
        labels: Optional[dict] = None,
        buckets: Tuple[float, ...] = _DEFAULT_BUCKETS,
    ):
        """Observe ``value``. ``buckets`` overrides the default ladder —
        but the FIRST observation of a name fixes the ladder for every
        label set of that family: per-{route,method,code} histograms
        create label sets lazily, and mixing ladders within
        one family would render inconsistent ``le`` label sets for the
        same metric (the latent exposition gap the render-roundtrip test
        pins)."""
        k = _key(name, labels)
        with self._lock:
            eff = self._hist_buckets.setdefault(name, tuple(buckets))
            h = self._histograms.get(k)
            if h is None:
                h = {"buckets": eff, "counts": [0] * (len(eff) + 1),
                     "sum": 0.0, "count": 0}
                self._histograms[k] = h
            h["counts"][bisect.bisect_left(h["buckets"], value)] += 1
            h["sum"] += value
            h["count"] += 1

    def get_counter(self, name: str, labels: Optional[dict] = None) -> float:
        return self._counters.get(_key(name, labels), 0.0)

    def get_gauge(self, name: str, labels: Optional[dict] = None) -> Optional[float]:
        return self._gauges.get(_key(name, labels))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: dict(v, counts=list(v["counts"]))
                    for k, v in self._histograms.items()
                },
            }

    # --- Prometheus text format v0.0.4 ----------------------------------
    def render(self) -> str:
        def fmt_labels(lab, extra=()):
            items = list(lab) + list(extra)
            if not items:
                return ""
            inner = ",".join(
                f'{k}="{_escape_label_value(v)}"' for k, v in items
            )
            return "{" + inner + "}"

        out = []
        # ONE TYPE line per metric name: labeled samples of the same
        # metric (e.g. the per-table corro.mem.table.bytes gauges) share
        # it — a repeated TYPE line makes strict expfmt parsers reject
        # the whole scrape
        typed: set = set()

        def type_line(pname: str, kind: str) -> None:
            if pname not in typed:
                typed.add(pname)
                out.append(f"# TYPE {pname} {kind}")

        snap = self.snapshot()
        for (name, lab), v in sorted(snap["counters"].items()):
            pname = name.replace(".", "_")
            type_line(pname, "counter")
            out.append(f"{pname}{fmt_labels(lab)} {v}")
        for (name, lab), v in sorted(snap["gauges"].items()):
            pname = name.replace(".", "_")
            type_line(pname, "gauge")
            out.append(f"{pname}{fmt_labels(lab)} {v}")
        for (name, lab), h in sorted(snap["histograms"].items()):
            pname = name.replace(".", "_")
            type_line(pname, "histogram")
            acc = 0
            for b, c in zip(h["buckets"], h["counts"]):
                acc += c
                out.append(
                    f"{pname}_bucket"
                    f"{fmt_labels(lab, [('le', _fmt_le(b))])} {acc}"
                )
            out.append(f"{pname}_bucket{fmt_labels(lab, [('le', '+Inf')])} {h['count']}")
            out.append(f"{pname}_sum{fmt_labels(lab)} {h['sum']}")
            out.append(f"{pname}_count{fmt_labels(lab)} {h['count']}")
        return "\n".join(out) + "\n"


REGISTRY = Registry()


# --- snapshot-side quantile estimation ------------------------
def histogram_quantile(h: dict, q: float) -> float:
    """Estimate the ``q``-quantile (0 < q <= 1) of one snapshot
    histogram dict (``{"buckets", "counts", "count", ...}``) by linear
    interpolation inside the owning bucket — the same model PromQL's
    ``histogram_quantile`` applies server-side. Values in the overflow
    bucket clamp to the top bound (the ladder cannot see past it).
    Returns 0.0 for an empty histogram."""
    count = h.get("count", 0)
    if count <= 0:
        return 0.0
    target = q * count
    acc = 0.0
    lo = 0.0
    for b, c in zip(h["buckets"], h["counts"]):
        if c and acc + c >= target:
            return lo + (float(b) - lo) * (target - acc) / c
        acc += c
        lo = float(b)
    # remaining mass sits in the overflow bucket: clamp to the top bound
    return float(h["buckets"][-1]) if h["buckets"] else lo


def aggregate_histograms(snap: dict, name: str) -> dict:
    """Fold every label set of one histogram family in a snapshot (or a
    ``parse_exposition`` result) into a single histogram dict. All label
    sets of a family share one bucket ladder by construction
    (:meth:`Registry.histogram` pins the ladder on first observation),
    so the per-bucket counts sum directly. Returns an empty histogram
    when the family has no samples — ``histogram_quantile`` of the
    result is then 0.0. The admission controller derives live
    Retry-After hints through this (docs/overload.md)."""
    agg = {"buckets": (), "counts": [], "sum": 0.0, "count": 0}
    for (n, _lab), h in snap.get("histograms", {}).items():
        if n != name:
            continue
        if not agg["buckets"]:
            agg["buckets"] = tuple(h["buckets"])
            agg["counts"] = [0] * len(h["counts"])
        for i, c in enumerate(h["counts"]):
            agg["counts"][i] += c
        agg["sum"] += h["sum"]
        agg["count"] += h["count"]
    return agg


def quantiles_from_histogram(
    h: dict, qs: Sequence[float] = (0.5, 0.95, 0.99)
) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` from one snapshot
    histogram — the server-side half of the load-harness report."""
    out = {}
    for q in qs:
        out[f"p{int(round(q * 100))}"] = histogram_quantile(h, q)
    return out


# --- Prometheus text-format parsing --------------------------------------
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label_value(v: str) -> str:
    return (
        v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text format v0.0.4 (as :meth:`Registry.render`
    emits it) back into a snapshot-shaped dict.

    Names come back in exposition form (dots already folded to
    underscores — the fold is lossy, so the original dotted name is not
    recoverable); histogram cumulative ``_bucket`` samples are
    de-accumulated back into per-bucket counts. The load harness scrapes
    ``/metrics`` through this to compare server-side request counts with
    its own client-side tallies, and the render-roundtrip test pins
    ``parse_exposition(reg.render())`` == ``reg.snapshot()`` (modulo the
    name fold)."""
    kinds: Dict[str, str] = {}
    counters: Dict = {}
    gauges: Dict = {}
    hist_raw: Dict = {}  # (name, labels) -> {"le": [...], "sum":, "count":}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name = m.group("name")
        raw_labels = m.group("labels") or ""
        labels = [
            (k, _unescape_label_value(v))
            for k, v in _LABEL_RE.findall(raw_labels)
        ]
        value = float(m.group("value"))
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and kinds.get(
                    name[: -len(suffix)]) == "histogram":
                base = name[: -len(suffix)]
                break
        if base is not None:
            plain = tuple(kv for kv in labels if kv[0] != "le")
            h = hist_raw.setdefault(
                (base, plain), {"le": [], "sum": 0.0, "count": 0})
            if name.endswith("_bucket"):
                le = dict(labels).get("le", "+Inf")
                bound = float("inf") if le == "+Inf" else float(le)
                h["le"].append((bound, value))
            elif name.endswith("_sum"):
                h["sum"] = value
            else:
                h["count"] = int(value)
        elif kinds.get(name) == "gauge":
            gauges[(name, tuple(labels))] = value
        else:
            counters[(name, tuple(labels))] = value
    histograms: Dict = {}
    for key, h in hist_raw.items():
        les = sorted(h["le"])
        buckets = tuple(b for b, _ in les if b != float("inf"))
        counts: List[int] = []
        prev = 0.0
        for _, cum in les:
            counts.append(int(cum - prev))
            prev = cum
        if len(counts) == len(buckets):  # no +Inf sample seen
            counts.append(int(h["count"] - prev))
        histograms[key] = {"buckets": buckets, "counts": counts,
                           "sum": h["sum"], "count": h["count"]}
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}

# round-info key -> corro.* series (reference names where one exists).
# MUST cover every key ``sim_step``/``scale_sim_step`` emit — an
# unmapped key silently vanishes from /metrics; the drift guard
# (tests/test_obs.py::test_info_map_covers_every_emitted_key) diffs
# this table against the live info dicts so a new sim counter cannot
# disappear unnoticed.
_INFO_MAP = {
    "acked": ("corro.gossip.probe.acked", "counter"),
    "failed_probes": ("corro.gossip.probe.failed", "counter"),
    "refutes": ("corro.gossip.refutes", "counter"),
    "sent": ("corro.broadcast.sent", "counter"),
    "delivered": ("corro.broadcast.recv.count", "counter"),
    "fresh": ("corro.broadcast.processed.count", "counter"),
    "queued": ("corro.broadcast.pending.count", "gauge"),
    "tx_completed": ("corro.broadcast.tx.completed", "counter"),
    "clock_drift_rejects": ("corro.broadcast.drift.rejects", "counter"),
    "syncs": ("corro.sync.client.count", "counter"),
    "cells_pulled": ("corro.sync.changes.recv", "counter"),
    "versions_granted": ("corro.sync.chunk.sent.versions", "counter"),
    "serve_rejects": ("corro.sync.server.rejects", "counter"),
    # per-shard activity occupancy: node counts of the
    # device-computed masks the active-set round variant will gate on
    # (sim/scale_step.activity_masks) — gauges, they are occupancy
    # levels, not monotone totals
    "active_bcast": ("corro.activity.bcast.nodes", "gauge"),
    "active_partials": ("corro.activity.partials.nodes", "gauge"),
    "active_sync": ("corro.activity.sync.nodes", "gauge"),
    "active_probes": ("corro.activity.swim.nodes", "gauge"),
    # corroquiet active-set rounds: emitted by the quiet
    # step only (``scale_sim_step_quiet``); a dense round emits none of
    # these, and the segmented runner zero-fills mixed soaks
    "quiet_round": ("corro.quiet.rounds.cheap", "counter"),
    "quiet_backstop": ("corro.quiet.backstop.fires", "counter"),
    "quiet_shards_skipped": ("corro.quiet.shards.skipped", "counter"),
    "quiet_shards_quiet": ("corro.quiet.shards.quiet", "gauge"),
    "quiet_nodes_active": ("corro.quiet.nodes.active", "gauge"),
}


def info_series() -> dict:
    """The info-key -> (series, kind) table (read-only copy) — the obs
    metrics bridge folds per-segment info sums/lasts through it."""
    return dict(_INFO_MAP)


def record_round_info(info: dict, registry: Registry = REGISTRY):
    """Map one round's info dict onto the corro.* series."""
    for k, v in info.items():
        mapped = _INFO_MAP.get(k)
        if mapped is None:
            continue
        name, kind = mapped
        v = float(v)
        if kind == "counter":
            registry.counter(name, v)
        else:
            registry.gauge(name, v)


class RoundTimer:
    """Slow-turn watchdog: the reference warns when a runtime-loop turn
    exceeds 1 s (``broadcast/mod.rs:319-323``) and profiles statements
    slower than 1 s (``sqlite.rs:51-61``). Use as a context manager around
    host-side round dispatch."""

    def __init__(self, name: str, warn_seconds: float = 1.0,
                 registry: Registry = REGISTRY, logger=None):
        self.name = name
        self.warn_seconds = warn_seconds
        self.registry = registry
        self.logger = logger

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.registry.histogram(f"corro.{self.name}.seconds", dt)
        if dt > self.warn_seconds:
            self.registry.counter(f"corro.{self.name}.slow", 1)
            if self.logger is not None:
                self.logger.warning(
                    "%s turn took %.3fs (> %.1fs)", self.name, dt, self.warn_seconds
                )
        return False


def start_prometheus_listener(registry: Registry, addr: str = "127.0.0.1",
                              port: int = 9090):
    """Standalone Prometheus exposition listener (the reference serves
    metrics on a dedicated telemetry address, ``command/agent.rs:114-139``).

    ``port=0`` binds an ephemeral port; the actually-bound port is on
    the returned server as ``bound_port`` (tests and the obs soak
    observer scrape it without racing for a fixed port). Returns the
    HTTPServer; ``.shutdown()`` stops the loop, JOINS the counted
    ``corro-prometheus`` thread (so the leak gate sees it exit), and
    closes the listening socket."""
    import http.server

    from corrosion_tpu_torch.utils.lifecycle import spawn_counted

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            data = registry.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer((addr, port), Handler)
    httpd.daemon_threads = True
    httpd.bound_port = httpd.server_address[1]
    # counted + corro- named: .shutdown() drains serve_forever, so the
    # lifecycle barrier sees it finish, and leak reports name the owner
    thread = spawn_counted(httpd.serve_forever, name="corro-prometheus")
    orig_shutdown = httpd.shutdown

    def _shutdown():
        orig_shutdown()
        thread.join(timeout=10)
        httpd.server_close()

    httpd.shutdown = _shutdown
    return httpd
