"""corrochaos host-plane scenario: ``serve-overload`` (port of
``corrosion_tpu/resilience/serve_overload.py``; docs/chaos.md).

The device-plane scenarios in :mod:`corrosion_tpu_torch.resilience.chaos`
replay compiled fault traces against the segmented soak pipeline; this
scenario instead drives the SERVING plane — a devcluster rig (Agent +
Database + ApiServer) under corroguard admission (docs/overload.md) —
through a seeded overload ramp while a mid-run ``restore_state`` of the
agent's own captured state makes ``/v1/ready`` flap, and judges it by
two oracles:

- **no lost committed write**: every key's final row is the LAST write
  the serving plane acked for it — never a 503-rejected write's value,
  never a silently vanished ack. The one tolerated exception is an ack
  landing inside the capture->apply window of the injected restore
  (restore IS a rollback to the captured snapshot; an ack racing that
  window may legitimately be superseded by the pre-capture value).
- **delivered or shed, never silently gapped**: each subscriber either
  replayed every accepted write into a replica that matches the final
  table (fast consumer), or was explicitly shed — resync marker(s) on
  the stream — and a post-stream re-query matches the final table
  (slow consumer catch-up path).

The verdict is shaped like a chaos-engine record (``name`` / ``seed`` /
``ok`` / ``problems`` / ``faults_injected`` ...) with
``host_plane: True`` so sweep artifacts can carry both families; the op
stream is pure in ``seed`` (``plan_digest`` pins it). The rig's agent runs
on ``device`` (default ``"cuda"``, which raises without a card).
"""

from __future__ import annotations

import hashlib
import json
import random
import socket
import threading
import time
from typing import Any, Dict, List, Optional

SCENARIO_NAME = "serve-overload"

#: the verdict's fields that are pure in ``(seed, writers, ops, keys)``; the
#: rest (acks, rejects, sheds, resyncs, the flap observed, and so ``ok`` and
#: ``problems``) depend on how fast rounds commit against the slow consumer
SEED_PURE_FIELDS = ("name", "seed", "n_nodes", "host_plane", "plan_digest",
                    "faults_injected", "resumes", "remeshes",
                    "corruptions_detected", "checkpoints_validated",
                    "checkpoints_refused")

_SCHEMA = (
    "CREATE TABLE ovl_kv (k TEXT PRIMARY KEY, v INTEGER, who TEXT);"
)
_STOP_KEY = "__stop__"


def plan_serve_overload(seed: int, writers: int, ops: int,
                        keys: int) -> dict:
    """Seeded op plan. Each writer OWNS the keys ``k % writers == w``
    (single-owner keys make per-key ack order total, which is what lets
    the lost-write oracle demand exact final values)."""
    plan: Dict[str, Any] = {
        "writers": [
            [
                w + writers * random.Random(
                    seed * 6151 + 13 * w + j).randrange(
                        max(1, (keys - w + writers - 1) // writers))
                for j in range(ops)
            ]
            for w in range(writers)
        ],
    }
    digest = hashlib.sha256(
        json.dumps(plan, sort_keys=True).encode()
    ).hexdigest()[:16]
    plan["digest"] = digest
    return plan


def run_serve_overload(seed: int = 0, writers: int = 4, ops: int = 40,
                       keys: int = 12, n_nodes: int = 8,
                       slow_ms: float = 25.0, pad_bytes: int = 1024,
                       warm_rounds: int = 8, deadline_s: float = 240.0,
                       workdir: Optional[str] = None,
                       flight_path: Optional[str] = None,
                       device="cuda") -> dict:
    """Run the scenario; -> a chaos-shaped verdict record (pure op plan
    in ``seed``; ``workdir`` is accepted for registry-signature parity
    and unused — this scenario touches no disk unless ``flight_path``
    asks for the NDJSON flight record, whose header/end pair carries
    the admission/shed snapshot so the replay shows the shed story —
    docs/observability.md)."""
    from corrosion_tpu_torch.agent import Agent
    from corrosion_tpu_torch.api.admission import AdmissionController
    from corrosion_tpu_torch.api.http import ApiServer
    from corrosion_tpu_torch.client import ApiError, CorrosionApiClient
    from corrosion_tpu_torch.config import ServeConfig
    from corrosion_tpu_torch.db import Database
    from corrosion_tpu_torch.obs.flight import (
        FLIGHT_SCHEMA_VERSION,
        FlightRecorder,
        serve_snapshot,
    )
    from corrosion_tpu_torch.testing import cluster_config
    from corrosion_tpu_torch.utils.lifecycle import spawn_counted
    from corrosion_tpu_torch.utils.metrics import parse_exposition

    plan = plan_serve_overload(seed, writers, ops, keys)
    pad = "x" * max(0, pad_bytes)
    problems: List[str] = []
    rec: Dict[str, Any] = {
        "name": SCENARIO_NAME,
        "seed": int(seed),
        "n_nodes": n_nodes,
        "host_plane": True,
        "plan_digest": plan["digest"],
        "faults_injected": 0,
        "resumes": 0,
        "remeshes": 0,
        "corruptions_detected": 0,
        "checkpoints_validated": 0,
        "checkpoints_refused": 0,
    }
    serve = ServeConfig(
        max_inflight=3, max_queue=3, queue_wait=0.05, max_streams=16,
        retry_after_cap=5.0, shed_policy="shed-oldest",
        sub_queue=16, sub_shed_threshold=1 << 30, stream_sndbuf=4608,
    )
    cfg = cluster_config(n_nodes=n_nodes, n_rows=keys + 4)

    # per-key ack journal: key -> [(monotonic ack time, stamp)], owner
    # writers append in their own program order under one lock
    acks: Dict[str, List[tuple]] = {}
    acks_mu = threading.Lock()
    rejected: set = set()  # stamps of 503-shed writes (never committed)
    flap = {"t0": None, "t1": None, "applied": False, "observed": 0}
    sub_out: List[Optional[dict]] = [None, None]  # fast, slow

    flight = FlightRecorder(flight_path) if flight_path else None
    with Agent(cfg, device=device) as agent:
        agent.wait_rounds(warm_rounds, timeout=deadline_s)
        db = Database(agent)
        admission = AdmissionController(serve, registry=agent.metrics)
        if flight is not None:
            flight.record(
                "header", schema=FLIGHT_SCHEMA_VERSION,
                mode="serve-overload", n_nodes=int(n_nodes),
                start_round=0, total_rounds=0, segment_rounds=0,
                seed=int(seed), plan_digest=plan["digest"],
            )
        with ApiServer(db, port=0, serve=serve,
                       admission=admission) as api:
            setup = CorrosionApiClient(api.addr, api.port)
            setup.schema([_SCHEMA])
            setup.execute([
                ("INSERT INTO ovl_kv (k, v, who) VALUES (?, ?, ?)",
                 [f"k{i}", 0, "seed"])
                for i in range(keys)
            ])
            agent.wait_rounds(2, timeout=deadline_s)

            def subscriber(i: int, slow: bool) -> None:
                out = {"replica": {}, "errors": 0, "resyncs": 0,
                       "dropped": 0, "ready": False, "slow": slow}
                sub_out[i] = out
                c = CorrosionApiClient(api.addr, api.port)
                try:
                    stream = c.subscribe("SELECT k, v, who FROM ovl_kv",
                                         stream_timeout=deadline_s)
                    if slow:
                        try:
                            stream._conn.sock.setsockopt(
                                socket.SOL_SOCKET, socket.SO_RCVBUF,
                                4096)
                        except (OSError, AttributeError):
                            pass
                    for ev in stream:
                        if "eoq" in ev:
                            out["ready"] = True
                        if "row" in ev:
                            key, row = ev["row"]
                            out["replica"][key] = row[1]
                        ch = ev.get("change")
                        if ch is None:
                            continue
                        if slow:
                            time.sleep(slow_ms / 1e3)
                        _kind, key, row, _cid = ch
                        if key == _STOP_KEY:
                            break
                        if row is not None:
                            out["replica"][key] = row[1]
                    out["resyncs"] = stream.resyncs
                    out["dropped"] = stream.dropped
                except (TimeoutError, OSError, ApiError):
                    out["errors"] += 1

            def writer(w: int) -> None:
                # closed-loop: 503s retry per the server's Retry-After
                # hint, so (almost) every planned op eventually acks
                c = CorrosionApiClient(api.addr, api.port, retry_503=16,
                                       retry_503_max_wait=0.25)
                for key_idx in plan["writers"][w]:
                    stamp = time.time_ns()
                    try:
                        c.execute([(
                            "UPDATE ovl_kv SET v = ?, who = ? "
                            "WHERE k = ?",
                            [stamp, f"w{w}" + pad, f"k{key_idx}"],
                        )])
                        with acks_mu:
                            acks.setdefault(f"k{key_idx}", []).append(
                                (time.monotonic(), stamp))
                    except ApiError as e:
                        if e.status == 503:
                            rejected.add(stamp)
                        # non-503 errors surface through the oracle:
                        # the key's final value simply won't advance
                    except OSError:
                        pass

            def ready_prober(stop: threading.Event) -> None:
                # watches /v1/ready flap to "restoring" during the
                # injected restore (observational: the window is one
                # round boundary wide, so seeing it is best-effort)
                c = CorrosionApiClient(api.addr, api.port)
                while not stop.is_set():
                    try:
                        c._request_json("GET", "/v1/ready")
                    except ApiError as e:
                        if e.status == 503:
                            flap["observed"] += 1
                    except OSError:
                        pass
                    time.sleep(0.002)

            subs = [
                spawn_counted(lambda: subscriber(0, slow=False),
                              name="corro-sovl-sub-fast"),
                spawn_counted(lambda: subscriber(1, slow=True),
                              name="corro-sovl-sub-slow"),
            ]
            deadline = time.monotonic() + deadline_s
            while not all(s and (s["ready"] or s["errors"])
                          for s in sub_out):
                if time.monotonic() > deadline:
                    problems.append("subscribers never reached eoq")
                    break
                time.sleep(0.01)

            wthreads = [
                spawn_counted(lambda w=w: writer(w),
                              name=f"corro-sovl-w{w}")
                for w in range(writers)
            ]

            # the fault: once roughly half the planned acks landed,
            # restore the agent's own captured state — /v1/ready flaps
            # to "restoring" until the round thread applies it
            half = writers * ops // 2
            while time.monotonic() < deadline:
                with acks_mu:
                    landed = sum(len(v) for v in acks.values())
                if landed >= half or not any(
                        t.is_alive() for t in wthreads):
                    break
                time.sleep(0.005)
            stop_probe = threading.Event()
            probe = spawn_counted(lambda: ready_prober(stop_probe),
                                  name="corro-sovl-probe")
            flap["t0"] = time.monotonic()
            state = agent.device_state()
            flap["applied"] = agent.restore_state(state,
                                                  timeout=deadline_s)
            flap["t1"] = time.monotonic()
            rec["faults_injected"] += 1
            rec["resumes"] += 1
            if not flap["applied"]:
                problems.append("injected restore was never applied")
            time.sleep(0.05)
            stop_probe.set()
            probe.join(timeout=deadline_s)

            for t in wthreads:
                t.join(timeout=deadline_s)
            if any(t.is_alive() for t in wthreads):
                problems.append("writers did not finish")

            try:
                setup.execute([(
                    "INSERT INTO ovl_kv (k, v, who) VALUES (?, ?, ?)",
                    [_STOP_KEY, 0, "stop"],
                )])
            except ApiError:
                problems.append("stop-marker write failed")
            agent.wait_rounds(3, timeout=deadline_s)
            for t in subs:
                t.join(timeout=deadline_s)
            if any(t.is_alive() for t in subs):
                problems.append("subscriber legs did not finish")

            # final plane state, read through the same serving plane
            _cols, rows = setup.query("SELECT k, v FROM ovl_kv")
            final = {r[0]: r[1] for r in rows if r[0] != _STOP_KEY}
            scrape = parse_exposition(setup.metrics())
            shed_total = sum(
                v for (n, _l), v in scrape["counters"].items()
                if n == "corro_subs_shed_total")
            rejected_total = sum(
                v for (n, _l), v in scrape["counters"].items()
                if n == "corro_admission_rejected_total")

            # --- oracle 1: no lost committed write ---------------------
            lost = []
            for i in range(keys):
                k = f"k{i}"
                got = final.get(k)
                journal = acks.get(k, [])
                if not journal:
                    if got != 0:
                        lost.append(f"{k}: never acked a write but "
                                    f"final v={got!r}")
                    continue
                t_last, expect = journal[-1]
                allowed = {expect}
                if (flap["t0"] is not None
                        and flap["t0"] <= t_last <= flap["t1"]):
                    # acks inside the restore's capture->apply window
                    # may be rolled back to the newest pre-window ack
                    pre = [s for t, s in journal if t < flap["t0"]]
                    allowed.update(
                        s for t, s in journal if t >= flap["t0"])
                    allowed.add(pre[-1] if pre else 0)
                if got not in allowed:
                    lost.append(
                        f"{k}: final v={got!r} not in the acked set "
                        f"{sorted(allowed)[-3:]}")
                if got in rejected:
                    lost.append(f"{k}: final v={got!r} is a 503-shed "
                                f"write's stamp — rejects must not "
                                f"commit")
            if lost:
                problems.append("lost committed writes: "
                                + "; ".join(lost[:4]))

            # --- oracle 2: delivered or explicitly shed ----------------
            for out in sub_out:
                if out is None or out["errors"]:
                    problems.append("subscriber leg errored")
                    continue
                tag = "slow" if out["slow"] else "fast"
                if out["dropped"] == 0:
                    diverged = {
                        k: (out["replica"].get(k), v)
                        for k, v in final.items()
                        if out["replica"].get(k) != v
                    }
                    if diverged:
                        problems.append(
                            f"{tag} subscriber saw no shed yet its "
                            f"replica diverged: "
                            f"{dict(list(diverged.items())[:3])}")
                else:
                    if out["resyncs"] == 0:
                        problems.append(
                            f"{tag} subscriber lost frames without a "
                            f"resync marker")
                    # the catch-up contract: after an announced gap, a
                    # fresh re-query must converge with the plane
                    _c2, rows2 = setup.query("SELECT k, v FROM ovl_kv")
                    requeried = {r[0]: r[1] for r in rows2
                                 if r[0] != _STOP_KEY}
                    if requeried != final:
                        problems.append(
                            f"{tag} subscriber post-resync re-query "
                            f"diverged from the final table")
            if shed_total <= 0:
                problems.append(
                    "the slow subscriber was never shed — the ramp did "
                    "not overload the fanout (raise writers/ops)")

            rec["acked_writes"] = sum(len(v) for v in acks.values())
            rec["rejected_writes"] = len(rejected)
            rec["admission_rejected_total"] = rejected_total
            rec["subs_shed_total"] = shed_total
            rec["resyncs"] = sum(
                s["resyncs"] for s in sub_out if s)
            rec["frames_dropped"] = sum(
                s["dropped"] for s in sub_out if s)
            rec["ready_flap_applied"] = bool(flap["applied"])
            rec["ready_503_observed"] = flap["observed"]
            if flight is not None:
                # the shed story, replayable: corro.admission.* +
                # corro.subs.shed_total ride the end record
                flight.record(
                    "end", completed_rounds=0, aborted=False,
                    crashed=False, checkpoint=None,
                    stats={
                        "acked_writes": rec["acked_writes"],
                        "rejected_writes": rec["rejected_writes"],
                        "subs_shed_total": rec["subs_shed_total"],
                    },
                    serve=serve_snapshot(agent.metrics),
                )
    if flight is not None:
        flight.close()

    leaked = sorted(
        t.name for t in threading.enumerate()
        if t.name.startswith(("corro-http-conn", "corro-pg-conn")))
    if leaked:
        problems.append(f"leaked serving threads: {leaked}")
    rec["ok"] = not problems
    if problems:
        rec["problems"] = problems
    return rec
