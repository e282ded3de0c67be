"""Lock registry + watchdog — the race-detection analog.

The reference has no TSan/loom; its guard is a **LockRegistry** that
labels every Bookie/Booked RwLock acquisition with label/kind/state/start
time plus a watchdog that warns (and Antithesis-asserts) on locks held
longer than 10 s / 60 s (``crates/corro-types/src/agent.rs:839-1063``,
``setup.rs:183-241``). Same design here for the host agent's locks: a
registry of instrumented locks, a snapshot of who holds/waits what (the
admin socket's ``lock dump`` uses it), and a watchdog thread.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class LockEvent:
    label: str
    kind: str  # "acquire" | "held"
    started: float = field(default_factory=time.monotonic)


class TrackedLock:
    """An RLock whose acquisitions are visible to the registry."""

    def __init__(self, registry: "LockRegistry", label: str):
        self._lock = threading.RLock()
        self._registry = registry
        self._label = label

    def __enter__(self):
        tid = threading.get_ident()
        ev = LockEvent(self._label, "acquire")
        self._registry._note(tid, ev)
        self._lock.acquire()
        ev.kind = "held"
        ev.started = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        self._registry._clear(threading.get_ident(), self._label)
        return False


class LockRegistry:
    """Registry + watchdog over every TrackedLock it creates."""

    def __init__(self, warn_seconds: float = 10.0, logger=None):
        self.warn_seconds = warn_seconds
        self.logger = logger
        self._mu = threading.Lock()
        self._events: Dict[tuple, LockEvent] = {}
        self.slow_count = 0

    def lock(self, label: str) -> TrackedLock:
        return TrackedLock(self, label)

    def _note(self, tid: int, ev: LockEvent):
        with self._mu:
            self._events[(tid, ev.label)] = ev

    def _clear(self, tid: int, label: str):
        with self._mu:
            self._events.pop((tid, label), None)

    def snapshot(self) -> List[dict]:
        """Current registry state, longest-held first (admin lock dump)."""
        now = time.monotonic()
        with self._mu:
            rows = [
                {
                    "label": ev.label,
                    "kind": ev.kind,
                    "held_seconds": round(now - ev.started, 3),
                    "thread": tid,
                }
                for (tid, _), ev in self._events.items()
            ]
        rows.sort(key=lambda r: -r["held_seconds"])
        return rows

    def check(self) -> List[dict]:
        """One watchdog pass: warn on locks held/waited too long
        (the reference's 10 s warn, ``setup.rs:183-241``)."""
        slow = [r for r in self.snapshot() if r["held_seconds"] > self.warn_seconds]
        for r in slow:
            self.slow_count += 1
            if self.logger is not None:
                self.logger.warning(
                    "lock %s %s for %.1fs by thread %d",
                    r["label"], r["kind"], r["held_seconds"], r["thread"],
                )
        return slow

    def start_watchdog(self, interval: float = 1.0, stop: Optional[threading.Event] = None):
        stop = stop or threading.Event()

        def loop():
            while not stop.wait(interval):
                self.check()

        t = threading.Thread(target=loop, daemon=True,
                             name="corro-lock-watchdog")
        t.start()
        return stop
