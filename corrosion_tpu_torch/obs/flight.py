"""FlightRecorder: crash-safe NDJSON telemetry and the per-run observer
(port of ``corrosion_tpu/obs/flight.py``).

A long soak that dies mid-run would otherwise leave nothing: infos and
stats live in the ``SoakResult`` that never materializes. The flight
recorder is the black box: one JSON object per line, appended to an
``O_APPEND`` descriptor with one ``write`` per record (line-atomic: a
crash can tear at most the final line, and :func:`replay_flight_record`
skips an unparseable tail), so whatever survives a crash is a complete,
parseable prefix of the run. The files are the JAX package's (schema
``FLIGHT_SCHEMA_VERSION``, the same record kinds):

- ``header``: one per run: mode, shapes, workload span, the pipeline's
  options, the fused mode and the port's kernel route, the
  config-identity digest, the starting carry's bytes;
- ``segment``: one per completed segment: absolute round window, wall
  seconds, rounds/s, per-segment info sums and last-round levels, the
  cumulative pipeline stats, and the carry's bytes;
- ``end``: the run's final stats, completed rounds, aborted and crashed
  flags, newest checkpoint.

Appends are staged under a lock and drained by a counted
``corro-obs-flight`` thread (the hot loop never waits on the disk);
:meth:`FlightRecorder.close` drains and joins it.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import List, Optional

import numpy as np

from corrosion_tpu_torch.utils.tracing import logger

FLIGHT_SCHEMA_VERSION = 1

#: keys of ``SoakResult.stats`` that accumulate (sums and counts): the
#: bridge takes their per-segment deltas
_STATS_SUM_KEYS = (
    "segments", "donated_segments", "carry_reuploads", "ckpt_stall_s",
    "ckpt_io_s", "ckpt_written", "ckpt_overlapped_segments",
    "ckpt_drain_bytes", "quiet_segments",
)


def serve_snapshot(registry) -> dict:
    """The serving plane's shed story as one flat JSON-safe dict: every
    ``corro.admission.*`` counter and gauge plus ``corro.subs.shed_total``
    from ``registry`` (label sets flattened into the key,
    ``name{k=v,...}``). Segment and end records embed it, so a replay of
    an overloaded soak shows when admission started rejecting."""
    if registry is None:
        return {}
    snap = registry.snapshot()
    out = {}
    for section in ("counters", "gauges"):
        for (name, labels), value in snap.get(section, {}).items():
            if not (name.split(".")[:2] == ["corro", "admission"]
                    or name == "corro.subs.shed_total"):
                continue
            key = name
            if labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            out[key] = value
    return out


def config_digest(cfg) -> str:
    """Stable digest of the checkpoint-identity view of a sim config: a
    replay can tell which run a flight record belongs to (equal to the
    JAX package's digest of the same config)."""
    from corrosion_tpu_torch.checkpoint import config_identity

    blob = json.dumps(config_identity(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class FlightRecorder:
    """Append-only, line-atomic NDJSON recorder.

    ``record`` stages the encoded line under ``_mu`` and wakes the flush
    thread; all file IO happens on the flush thread, outside the lock. An
    IO error drops the batch with a logged exception: telemetry must never
    kill the soak it observes."""

    def __init__(self, path: str):
        self.path = path
        self._mu = threading.Lock()
        self._buf: List[str] = []
        self._closed = False
        self._wake = threading.Event()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        from corrosion_tpu_torch.utils.lifecycle import spawn_counted

        self._thread = spawn_counted(self._run, name="corro-obs-flight")

    def record(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "ts": round(time.time(), 3), **fields}
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._mu:
            if self._closed:
                return
            self._buf.append(line)
        self._wake.set()

    def _drain(self):
        with self._mu:
            # clear before detaching, under the lock: a producer's set()
            # lands either before the clear (its record is in this batch)
            # or after it (the next wait wakes at once)
            self._wake.clear()
            batch, self._buf = self._buf, []
            closed = self._closed
        return batch, closed

    def _run(self) -> None:
        fd = None
        try:
            while True:
                self._wake.wait(timeout=0.2)
                batch, closed = self._drain()
                if batch:
                    try:
                        if fd is None:
                            fd = os.open(
                                self.path,
                                os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                                0o644,
                            )
                        for line in batch:
                            # one write per record: the line is the unit
                            # a crash can tear
                            os.write(fd, line.encode())
                    except OSError:
                        logger.exception(
                            "flight-record append to %s failed; dropped "
                            "%d record(s)", self.path, len(batch),
                        )
                if closed and not batch:
                    return
        finally:
            if fd is not None:
                os.close(fd)

    def close(self) -> None:
        """Drain pending records and join the flush thread."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        self._thread.join(timeout=10)


def replay_flight_record(path: str) -> dict:
    """Parse a flight-record NDJSON file into a run summary.

    Torn or garbage lines (a crash's tail) are counted in
    ``skipped_lines`` and skipped; everything before them replays.
    ``stats`` is the newest cumulative pipeline-stats snapshot (the
    ``end`` record's when the run closed cleanly, else the last
    segment's)."""
    headers: List[dict] = []
    segments: List[dict] = []
    end: Optional[dict] = None
    skipped = 0
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except json.JSONDecodeError:
                skipped += 1
                continue
            kind = rec.get("kind")
            if kind == "header":
                headers.append(rec)
            elif kind == "segment":
                segments.append(rec)
            elif kind == "end":
                end = rec
    rounds = sum(int(s.get("rounds", 0)) for s in segments)
    seconds = sum(float(s.get("seconds", 0.0)) for s in segments)
    info_sum: dict = {}
    for s in segments:
        for k, v in (s.get("info_sum") or {}).items():
            info_sum[k] = info_sum.get(k, 0.0) + float(v)
    stats = dict((end or {}).get("stats")
                 or (segments[-1].get("stats") if segments else {}) or {})
    serve: dict = {}
    if end is not None and "serve" in end:
        serve = dict(end.get("serve") or {})
    else:
        for s in reversed(segments):
            if "serve" in s:
                serve = dict(s.get("serve") or {})
                break
    completed = (
        int(end["completed_rounds"]) if end is not None
        else int(segments[-1]["hi"]) if segments
        else int(headers[-1]["start_round"]) if headers
        else 0
    )
    return {
        "schema": max((int(h.get("schema", 0)) for h in headers), default=0),
        "runs": len(headers),
        "header": headers[-1] if headers else None,
        "segments": len(segments),
        "completed_rounds": completed,
        "rounds": rounds,
        "seconds": round(seconds, 6),
        "rounds_per_s": round(rounds / seconds, 3) if seconds > 0 else 0.0,
        "info_sum": info_sum,
        "stats": stats,
        "serve": serve,
        "hbm_bytes": (int(segments[-1].get("hbm_bytes", 0)) if segments
                      else int(headers[-1].get("hbm_bytes", 0))
                      if headers else 0),
        "ended": end is not None,
        "aborted": bool(end.get("aborted")) if end is not None else None,
        "crashed": bool(end.get("crashed")) if end is not None else None,
        "checkpoint": (end or {}).get("checkpoint"),
        "skipped_lines": skipped,
    }


def _json_safe_stats(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if isinstance(v, (bool, int, float, str)) or v is None}


def _host_info(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def info_sums(infos) -> dict:
    """Per-key float sums of stacked round infos, summed by numpy as the
    JAX package sums them (one host read per key)."""
    return {k: float(_host_info(v).sum()) for k, v in (infos or {}).items()}


class SoakObserver:
    """One soak run's telemetry: flight recorder, metrics bridge, an
    optional standalone Prometheus listener, and the span/profiler switch.

    ``run_segmented`` drives the ``open_run``/``on_segment``/``end_run``
    hooks; the owner (``Agent.soak``, the CLI, a test) creates and
    :meth:`close`\\ s the observer. One observer may span a run and its
    resume (each appends its own header)."""

    def __init__(self, flight: Optional[FlightRecorder] = None,
                 registry=None, listener=None, jax_profile: bool = False,
                 serve_registry=None):
        self.flight = flight
        self.registry = registry
        self.listener = listener  # start_prometheus_listener's server
        self.jax_profile = bool(jax_profile)
        # the serving plane's registry (the agent's): segment and end
        # records then carry its admission/shed snapshot
        self.serve_registry = serve_registry
        from corrosion_tpu_torch.obs.bridge import MetricsBridge

        self.bridge = MetricsBridge(registry) if registry is not None else None
        self._prev_stats: dict = {}
        self._seg_t0 = 0.0

    # --- run_segmented hooks --------------------------------------------
    def open_run(self, *, cfg, mode: str, total_rounds: int,
                 start_round: int, segment_rounds: int, stats: dict,
                 state) -> None:
        from corrosion_tpu_torch.obs.memory import (
            memory_report,
            publish_memory_gauges,
            state_bytes,
        )

        self._prev_stats = dict(stats)
        self._seg_t0 = time.perf_counter()
        if self.registry is not None:
            publish_memory_gauges(
                memory_report(state, getattr(cfg, "n_nodes", None)),
                self.registry,
            )
        if self.flight is not None:
            self.flight.record(
                "header",
                schema=FLIGHT_SCHEMA_VERSION,
                mode=mode,
                n_nodes=int(getattr(cfg, "n_nodes", 0)),
                start_round=int(start_round),
                total_rounds=int(total_rounds),
                segment_rounds=int(segment_rounds),
                donate=bool(stats.get("donate")),
                async_checkpoint=bool(stats.get("async_checkpoint")),
                fused_mode=stats.get("fused_mode"),
                kernel_route=stats.get("kernel_route"),
                quiet_mode=stats.get("quiet_mode"),
                config_digest=config_digest(cfg),
                hbm_bytes=state_bytes(state),
            )

    def on_segment(self, *, seg_index: int, lo: int, hi: int, infos,
                   stats: dict, state) -> None:
        from corrosion_tpu_torch.obs.memory import state_bytes

        now = time.perf_counter()
        seconds = now - self._seg_t0
        self._seg_t0 = now
        rounds = hi - lo
        host = {k: _host_info(v) for k, v in (infos or {}).items()}
        info_sum = info_sums(host)
        info_last = {k: float(v[-1]) for k, v in host.items()}
        delta = {k: stats.get(k, 0) - self._prev_stats.get(k, 0)
                 for k in _STATS_SUM_KEYS}
        self._prev_stats = dict(stats)
        if self.bridge is not None:
            self.bridge.on_segment(
                completed_rounds=hi, rounds=rounds, seconds=seconds,
                info_sum=info_sum, info_last=info_last, stats_delta=delta,
            )
        if self.flight is not None:
            extra = {}
            if self.serve_registry is not None:
                extra["serve"] = serve_snapshot(self.serve_registry)
            self.flight.record(
                "segment",
                seg=int(seg_index),
                lo=int(lo),
                hi=int(hi),
                rounds=int(rounds),
                seconds=round(seconds, 6),
                rounds_per_s=(round(rounds / seconds, 3)
                              if seconds > 0 else 0.0),
                donated=False,
                info_sum=info_sum,
                info_last=info_last,
                stats=_json_safe_stats(stats),
                hbm_bytes=state_bytes(state),
                **extra,
            )

    def end_run(self, *, stats: dict, completed_rounds: int,
                aborted: bool, crashed: bool = False,
                checkpoint: Optional[str] = None) -> None:
        if self.bridge is not None:
            self.bridge.on_end(completed_rounds=completed_rounds,
                               aborted=aborted)
        if self.flight is not None:
            extra = {}
            if self.serve_registry is not None:
                extra["serve"] = serve_snapshot(self.serve_registry)
            self.flight.record(
                "end",
                completed_rounds=int(completed_rounds),
                aborted=bool(aborted),
                crashed=bool(crashed),
                checkpoint=checkpoint,
                stats=_json_safe_stats(stats),
                **extra,
            )

    # --- lifecycle ------------------------------------------------------
    def close(self) -> None:
        if self.flight is not None:
            self.flight.close()
        if self.listener is not None:
            self.listener.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def make_observer(obs_cfg, registry=None,
                  serve_registry=None) -> Optional[SoakObserver]:
    """A :class:`SoakObserver` from a ``config.ObsConfig``, or None when
    the section asks for nothing (no flight path, listener off, profiling
    off), so callers pass ``obs=make_observer(cfg.obs, ...)`` always.

    ``registry=None`` with a listener or a flight path uses a fresh
    private registry; pass the agent's to show the soak on its
    ``/metrics`` route too."""
    flight_path = getattr(obs_cfg, "flight_path", "") or ""
    prom_port = int(getattr(obs_cfg, "prometheus_port", -1))
    jax_profile = bool(getattr(obs_cfg, "jax_profile", False))
    if not flight_path and prom_port < 0 and not jax_profile:
        return None
    from corrosion_tpu_torch.utils.metrics import (
        Registry,
        start_prometheus_listener,
    )

    if registry is None:
        registry = Registry()
    # the recorder before the listener: an unwritable flight path must not
    # strand a bound listener with no handle to shut it down
    flight = FlightRecorder(flight_path) if flight_path else None
    listener = None
    if prom_port >= 0:
        try:
            listener = start_prometheus_listener(registry, port=prom_port)
        except BaseException:
            if flight is not None:
                flight.close()
            raise
    return SoakObserver(flight=flight, registry=registry,
                        listener=listener, jax_profile=jax_profile,
                        serve_registry=serve_registry)
