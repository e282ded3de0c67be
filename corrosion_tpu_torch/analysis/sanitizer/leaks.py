"""Thread / executor leak gate (port of
``corrosion_tpu/analysis/sanitizer/leaks.py``).

The reference's shutdown story is ``spawn_counted`` + tripwire: every
task is counted and shutdown waits for all of them. The leak gate is
the test-time enforcement of that story — anything spawned inside the
sanitized window that still runs at the gate either carries an
allow-listed name (``corro-supervised-*``: orphaned-by-design deadline
dispatches) or is a leak. Registrations hold only weakrefs: the gate
must never keep a thread or executor alive itself.
"""

from __future__ import annotations

import weakref
from typing import List, Tuple

from corrosion_tpu_torch.analysis.sanitizer.allowlist import ALLOWED_LEAK_PREFIXES
from corrosion_tpu_torch.analysis.sanitizer.report import SanFinding


class LeakRegistry:
    def __init__(self):
        self._threads: List[Tuple[weakref.ref, str]] = []
        self._executors: List[Tuple[weakref.ref, str]] = []

    def on_thread_start(self, thread, site: str) -> None:
        self._threads.append((weakref.ref(thread), site))

    def on_executor(self, executor, site: str) -> None:
        self._executors.append((weakref.ref(executor), site))

    def spawned_count(self) -> int:
        return len(self._threads)

    def check(self) -> List[SanFinding]:
        findings: List[SanFinding] = []
        for ref, site in self._threads:
            t = ref()
            if t is None or not t.is_alive():
                continue
            name = t.name or "<unnamed>"
            if any(name.startswith(p) for p in ALLOWED_LEAK_PREFIXES):
                continue
            findings.append(SanFinding(
                kind="thread-leak", subject=name,
                message=(
                    "thread spawned in the sanitized window is still "
                    f"alive at the gate (daemon={t.daemon}) — its owner "
                    "never joined/stopped it"
                ),
                site=site,
            ))
        for ref, site in self._executors:
            ex = ref()
            if ex is None:
                continue
            if not getattr(ex, "_shutdown", True):
                findings.append(SanFinding(
                    kind="executor-leak",
                    subject=type(ex).__name__,
                    message="ThreadPoolExecutor was never shut down",
                    site=site,
                ))
        return findings
