"""Admin socket: JSON-framed command server on a Unix domain socket.

Mirrors ``crates/corro-admin``: a UDS server running inside the agent
(``start_server``, ``lib.rs:49``) speaking newline-delimited JSON frames
(the reference uses tokio-serde length-delimited JSON), with the same
command set (``Command`` enum, ``lib.rs:102-148``):

- ``ping``;
- ``sync`` — per-node sync-state dump (used by the Antithesis
  ``check_bookkeeping`` convergence check);
- ``locks`` — top-N held locks from the lock registry;
- ``cluster members`` / ``cluster set-id`` / ``cluster rejoin``;
- ``actor version`` — probe one (node, origin) head;
- ``log`` — dynamic log filter reload.

Plus the fault-injection surface the reference gets externally from
Antithesis (SURVEY §4): ``kill`` / ``revive`` / ``partition`` / ``heal``,
and ``checkpoint`` / ``restore`` hooks.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
from typing import Optional

import numpy as np

from corrosion_tpu_torch.utils.tracing import logger, set_level


class AdminServer:
    def __init__(self, agent, uds_path: str, db=None):
        self.agent = agent
        self.db = db
        self.uds_path = uds_path
        self.cluster_id = 0
        if os.path.exists(uds_path):
            os.unlink(uds_path)
        handler = _make_handler(self)
        self.server = socketserver.ThreadingUnixStreamServer(uds_path, handler)
        self.server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AdminServer":
        from corrosion_tpu_torch.utils.lifecycle import spawn_counted

        self._thread = spawn_counted(
            self.server.serve_forever, name="corro-admin-uds"
        )
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if os.path.exists(self.uds_path):
            os.unlink(self.uds_path)
        if self._thread:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # --- command dispatch -------------------------------------------------
    def handle(self, cmd: dict) -> dict:
        agent = self.agent
        name = cmd.get("command")
        if name == "ping":
            return {"ok": "pong"}
        if name == "sync":
            # cross-process trace propagation: the caller's traceparent
            # rides the command and parents our serving span — the
            # SyncTraceContextV1 inject/extract seam (sync.rs:33-67,
            # peer/mod.rs:1017-1020,1414-1416)
            from corrosion_tpu_torch.utils.tracing import span

            from corrosion_tpu_torch.utils.tracing import inject_traceparent

            node = cmd.get("node")
            with span("admin.sync_state", traceparent=cmd.get("traceparent"),
                      node=node if node is not None else "all"):
                if node is not None:
                    state = agent.sync_state(int(node))
                    # return the serving span so the caller can link
                    # both sides (SyncTraceContextV1 round-trip)
                    state["traceparent"] = inject_traceparent()
                    return {"ok": state}
                return {
                    "ok": [agent.sync_state(i) for i in range(agent.n_nodes)]
                }
        if name == "locks":
            top = int(cmd.get("top", 10))
            snap = sorted(
                agent.locks.snapshot(),
                key=lambda e: e.get("held_seconds", 0), reverse=True,
            )
            return {"ok": snap[:top]}
        if name == "cluster_members":
            return {"ok": agent.members()}
        if name == "cluster_set_id":
            # live ClusterId change (corro-admin/src/lib.rs:135-140): the
            # id gates payload delivery — nodes on a different id stop
            # exchanging traffic until ids agree again
            new_id = int(cmd["cluster_id"])
            nodes = cmd.get("nodes")  # None = whole cluster
            agent.set_cluster_id(new_id, nodes=nodes)
            if nodes is None:  # the server-wide id only moves wholesale
                self.cluster_id = new_id
            return {"ok": new_id}
        if name == "cluster_rejoin":
            agent.revive_node(int(cmd["node"]))
            return {"ok": True}
        if name == "actor_version":
            snap = agent.snapshot()
            node, origin = int(cmd["node"]), int(cmd["origin"])
            return {"ok": {
                "head": int(snap["head"][node, origin]),
                "known_max": int(snap["known_max"][node, origin]),
            }}
        if name == "log":
            set_level(cmd.get("level", "info"))
            return {"ok": cmd.get("level", "info")}
        if name == "assertions":
            from corrosion_tpu_torch.utils.assertions import REGISTRY

            return {"ok": {**REGISTRY.snapshot(),
                           "liveness": REGISTRY.liveness_report()}}
        if name == "reload":
            # `corrosion reload` analog: re-apply schema files + log level
            # from the (possibly edited) config file (command/reload.rs)
            from corrosion_tpu_torch.config import load_config

            cfg = load_config(cmd["config"])
            applied = []
            if self.db is not None:
                for path in cfg.db.schema_paths:
                    with open(path) as f:
                        applied.extend(self.db.apply_schema_sql(f.read()))
            set_level(cfg.log.level)
            return {"ok": {"schema_changes": [list(c) for c in applied],
                           "log_level": cfg.log.level}}
        # --- fault injection (Antithesis harness analog) ------------------
        if name == "kill":
            agent.kill_node(int(cmd["node"]))
            return {"ok": True}
        if name == "revive":
            agent.revive_node(int(cmd["node"]))
            return {"ok": True}
        if name == "partition":
            groups = np.asarray(cmd["groups"], np.int32)
            agent.set_partition(groups)
            return {"ok": True}
        if name == "heal":
            agent.heal_partition()
            return {"ok": True}
        # --- durability ---------------------------------------------------
        if name == "checkpoint":
            from corrosion_tpu_torch.checkpoint import save_checkpoint

            path = save_checkpoint(agent, db=self.db,
                                   path=cmd.get("path", "./checkpoint"))
            return {"ok": path}
        if name == "restore":
            from corrosion_tpu_torch.checkpoint import restore_checkpoint

            man = restore_checkpoint(agent, cmd["path"], db=self.db)
            return {"ok": {"round": man["round"]}}
        if name == "backup":
            from corrosion_tpu_torch.checkpoint import backup_node

            path = backup_node(agent, int(cmd.get("node", 0)), db=self.db,
                               path=cmd.get("path", "./backup.npz"))
            return {"ok": path}
        if name == "restore_backup":
            from corrosion_tpu_torch.checkpoint import restore_backup

            node = restore_backup(
                agent, cmd["path"],
                node=int(cmd["node"]) if "node" in cmd else None,
                db=self.db, repivot=bool(cmd.get("repivot", True)),
            )
            return {"ok": {"node": node}}
        if name == "compact":
            # operator-triggered heap compaction (the vacuum_db analog;
            # the maintenance loop also runs it on cadence)
            if self.db is None:
                return {"error": "no database attached"}
            # floor the grace on a LIVE agent: ids interned by writes
            # not yet applied to device state are protected only by
            # this window (values.py lookup contract); 0/negative would
            # free them mid-flight. Tests hit Database.compact_heap
            # directly when they need an immediate pass.
            grace = max(5.0, float(cmd.get("grace_seconds", 300.0)))
            freed = self.db.compact_heap(grace_seconds=grace)
            return {"ok": {"freed": freed,
                           "live": self.db.heap.live_count,
                           "len": len(self.db.heap)}}
        return {"error": f"unknown command {name!r}"}


def _make_handler(server: AdminServer):
    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    cmd = json.loads(raw)
                    resp = server.handle(cmd)
                except Exception as e:  # noqa: BLE001
                    logger.exception("admin command failed")
                    resp = {"error": str(e)}
                try:
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return

    return Handler


class AdminClient:
    """Line-framed JSON client (the CLI's admin transport)."""

    def __init__(self, uds_path: str, timeout: float = 30.0):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(uds_path)
        self._file = self.sock.makefile("rwb")

    def call(self, command: str, **kw) -> dict:
        # inject the current trace context (the sync client's
        # traceparent injection, peer/mod.rs:1017-1020)
        from corrosion_tpu_torch.utils.tracing import inject_traceparent

        tp = inject_traceparent()
        if tp and "traceparent" not in kw:
            kw["traceparent"] = tp
        self._file.write(json.dumps({"command": command, **kw}).encode() + b"\n")
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("admin socket closed")
        resp = json.loads(line)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp["ok"]

    def close(self) -> None:
        try:
            self._file.close()
        finally:
            self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
