"""Consul bridge: mirror a Consul agent's services/checks into cluster
tables (port of ``corrosion_tpu/consul.py``).

Mirrors ``crates/consul-client`` (minimal agent HTTP client,
``consul-client/src/lib.rs``) and ``corrosion consul sync``
(``crates/corrosion/src/command/consul/sync.rs:23-983``): poll the local
Consul agent every second, hash each service/check, and upsert only the
diffs into the ``consul_services`` / ``consul_checks`` tables in a single
transaction, tracking applied hashes in a local cache (the reference's
``__corro_consul_*`` tables).

Rows carry the full object as JSON (``data``) plus the hash — the
reference stores parsed columns; the JSON payload keeps the bridge
schema-independent of the grid's column budget.
"""

from __future__ import annotations

import hashlib
import json
import threading
import urllib.error
import urllib.request
from typing import Dict, Optional, Tuple

from corrosion_tpu_torch.utils.backoff import Backoff, retry_call
from corrosion_tpu_torch.utils.tracing import logger

CONSUL_SCHEMA = """
CREATE TABLE consul_services (id TEXT PRIMARY KEY, data TEXT, hash TEXT);
CREATE TABLE consul_checks (id TEXT PRIMARY KEY, data TEXT, hash TEXT);
"""


class ConsulClient:
    """Minimal Consul agent HTTP client (services + checks)."""

    def __init__(self, addr: str = "127.0.0.1:8500", timeout: float = 10.0):
        self.base = f"http://{addr}"
        self.timeout = timeout

    def _get(self, path: str):
        req = urllib.request.Request(self.base + path)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:  # noqa: S310 — operator-configured local agent addr
            return json.loads(resp.read())

    def agent_services(self) -> Dict[str, dict]:
        return self._get("/v1/agent/services")

    def agent_checks(self) -> Dict[str, dict]:
        return self._get("/v1/agent/checks")


def _hash(obj: dict) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True).encode()
    ).hexdigest()[:16]


class ConsulSync:
    """The sync loop: diff-and-upsert services/checks each poll."""

    def __init__(self, consul: ConsulClient, execute, node: int = 0):
        """``execute(statements, node)`` — the write path (HTTP client's
        ``execute`` or ``Database.execute`` adapted)."""
        self.consul = consul
        self.execute = execute
        self.node = node
        # applied-hash caches (the reference's __corro_consul_* tables)
        self._svc_hashes: Dict[str, str] = {}
        self._chk_hashes: Dict[str, str] = {}
        self._stop = threading.Event()

    def sync_once(self) -> Tuple[int, int]:
        """One poll: returns (services_changed, checks_changed). The
        applied-hash caches only advance after the write succeeds, so a
        failed transaction is retried on the next poll."""
        services = self.consul.agent_services()
        checks = self.consul.agent_checks()
        stmts: list = []
        svc_updates = self._diff("consul_services", services,
                                 self._svc_hashes, stmts)
        chk_updates = self._diff("consul_checks", checks,
                                 self._chk_hashes, stmts)
        if stmts:
            self.execute(stmts, self.node)
        for cache, updates in ((self._svc_hashes, svc_updates),
                               (self._chk_hashes, chk_updates)):
            for cid, h in updates.items():
                if h is None:
                    cache.pop(cid, None)
                else:
                    cache[cid] = h
        return len(svc_updates), len(chk_updates)

    def _diff(self, table: str, fresh: Dict[str, dict],
              cache: Dict[str, str], stmts: list) -> Dict[str, Optional[str]]:
        """-> proposed cache updates (id -> hash, None = removal); applied
        by the caller only after the statements commit."""
        updates: Dict[str, Optional[str]] = {}
        for cid, obj in fresh.items():
            h = _hash(obj)
            if cache.get(cid) == h:
                continue
            stmts.append((
                f"INSERT INTO {table} (id, data, hash) VALUES (?, ?, ?)",
                [cid, json.dumps(obj, sort_keys=True), h],
            ))
            updates[cid] = h
        for cid in cache:
            if cid not in fresh:
                stmts.append((f"DELETE FROM {table} WHERE id = ?", [cid]))
                updates[cid] = None
        return updates

    def run(self, poll_seconds: float = 1.0) -> None:
        """Poll forever (the reference polls every 1 s,
        ``command/consul/sync.rs``); consul errors retry through the
        shared :func:`retry_call` policy (1 s -> 30 s jittered, no retry
        cap — the bridge outlives any consul outage), with waits
        interruptible by :meth:`stop`."""
        while not self._stop.is_set():
            try:
                n_svc, n_chk = retry_call(
                    self.sync_once,
                    backoff=Backoff(min_wait=1.0, max_wait=30.0),
                    retry_on=(urllib.error.URLError, ConnectionError,
                              OSError),
                    sleep=self._stop.wait,
                    abort=self._stop.is_set,
                    on_retry=lambda e, delay, n: logger.warning(
                        "consul poll failed (%s); retry in %.1fs", e, delay
                    ),
                )
            except (urllib.error.URLError, ConnectionError, OSError):
                break  # stop() tripped mid-backoff
            if n_svc or n_chk:
                logger.info("consul sync: %d services, %d checks changed",
                            n_svc, n_chk)
            self._stop.wait(poll_seconds)

    def stop(self) -> None:
        self._stop.set()


def consul_sync_cli(args) -> int:
    from corrosion_tpu_torch.client import CorrosionApiClient

    api = CorrosionApiClient(args.api_addr, args.api_port)
    try:
        api.schema([CONSUL_SCHEMA])
    except Exception as e:  # noqa: BLE001 — tables may already exist
        logger.debug("consul schema apply: %s", e)
    sync = ConsulSync(
        ConsulClient(args.consul_addr),
        execute=lambda stmts, node: api.execute(stmts, node=node),
        node=args.node,
    )
    if args.once:
        n_svc, n_chk = sync.sync_once()
        print(json.dumps({"services": n_svc, "checks": n_chk}))
        return 0
    try:
        sync.run()
    except KeyboardInterrupt:
        sync.stop()
    return 0
