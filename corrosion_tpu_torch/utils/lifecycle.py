"""Lifecycle utilities: graceful shutdown and counted spawns.

The reference's layer-9 crates (SURVEY §1): ``tripwire`` — a shutdown
future tripped by SIGTERM/SIGINT or programmatically
(``crates/tripwire/src/tripwire.rs:21``); ``spawn`` — ``spawn_counted``
tracks pending tasks so shutdown can wait for all of them
(``crates/spawn/src/lib.rs:14-28``). Threads play the role of tokio
tasks in the host agent. The ``backoff`` crate's analog is
:mod:`corrosion_tpu_torch.utils.backoff`.
"""

from __future__ import annotations

import signal
import socket
import threading
import time
import weakref
from typing import Optional


class Tripwire:
    """Shutdown signal: ``tripped`` flips once; waiters unblock."""

    def __init__(self):
        self._event = threading.Event()

    def trip(self):
        self._event.set()

    @property
    def tripped(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def hook_signals(self):
        """SIGTERM/SIGINT -> trip (main thread only)."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self.trip())
        return self


_pending = 0
_pending_mu = threading.Lock()
_pending_zero = threading.Condition(_pending_mu)


def spawn_counted(target, *args, name: Optional[str] = None, **kwargs) -> threading.Thread:
    """Spawn a thread counted toward ``wait_for_all_pending``."""
    global _pending
    with _pending_mu:
        _pending += 1

    def run():
        global _pending
        try:
            target(*args, **kwargs)
        finally:
            with _pending_mu:
                _pending -= 1
                if _pending == 0:
                    _pending_zero.notify_all()

    t = threading.Thread(target=run, daemon=True, name=name)
    t.start()
    return t


def pending_count() -> int:
    with _pending_mu:
        return _pending


def wait_for_all_pending(timeout: Optional[float] = None) -> bool:
    """Block until every counted spawn finished (shutdown barrier)."""
    with _pending_mu:
        return _pending_zero.wait_for(lambda: _pending == 0, timeout)


class DrainingConnMixin:
    """``socketserver.ThreadingMixIn`` companion for the serving-plane
    listeners: per-connection threads are corro- named, counted, and
    drained by the owning listener's ``stop()``.

    stdlib ``ThreadingMixIn`` with ``daemon_threads`` never tracks its
    handler threads, so ``server_close()`` joins nothing and a handler
    parked on a quiet socket (an NDJSON stream whose client went away,
    a PG connection that never sent Terminate) outlives the listener —
    exactly the leak the corrosan gate flags. Here the threads stay
    daemonic (a stuck peer cannot wedge interpreter exit) but
    ``drain_connections()`` makes shutdown deterministic: a grace join
    for handlers that exit on their own, then a socket shutdown to
    unblock any still parked in ``recv``, then a final join.
    """

    _conn_name = "corro-conn"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conns_mu = threading.Lock()
        self._conn_threads: "weakref.WeakSet[threading.Thread]" = (
            weakref.WeakSet())
        self._conn_socks: "weakref.WeakSet[socket.socket]" = (
            weakref.WeakSet())

    def process_request(self, request, client_address):
        global _pending
        with _pending_mu:
            _pending += 1

        def run():
            global _pending
            try:
                self.process_request_thread(request, client_address)
            finally:
                with _pending_mu:
                    _pending -= 1
                    if _pending == 0:
                        _pending_zero.notify_all()

        t = threading.Thread(target=run, daemon=True, name=self._conn_name)
        with self._conns_mu:
            self._conn_threads.add(t)
            self._conn_socks.add(request)
        t.start()

    def drain_connections(self, grace: float = 2.0,
                          timeout: float = 10.0) -> bool:
        """Join handler threads; force-close sockets of any that
        outlive ``grace``. True iff everything exited in time."""
        deadline = time.monotonic() + timeout
        grace_end = time.monotonic() + grace
        with self._conns_mu:
            threads = list(self._conn_threads)
        for t in threads:
            t.join(timeout=max(0.0, grace_end - time.monotonic()))
        if any(t.is_alive() for t in threads):
            with self._conns_mu:
                socks = list(self._conn_socks)
            for s in socks:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass  # already closed by its handler
            for t in threads:
                if t.is_alive():
                    t.join(timeout=max(0.1, deadline - time.monotonic()))
        return not any(t.is_alive() for t in threads)

