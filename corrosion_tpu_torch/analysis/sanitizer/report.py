"""corrosan findings + the machine-readable report (port of
``corrosion_tpu/analysis/sanitizer/report.py``).

A sanitizer finding is deliberately NOT a corrolint
:class:`~corrosion_tpu_torch.analysis.base.Finding`: corrolint findings are
(path, line) facts about source text; sanitizer findings are facts
about one *execution* (threads, witnessed orders, surviving handles)
and carry that context instead.

Report layout (one file, independently-written sections so the fixture
replay CLI and the sanitized pytest run can both land in it)::

    {
      "version": 1,
      "tool": "corrosan",
      "sections": {
        "fixtures": {...},   # san: per-fixture verdicts
        "pytest":   {...}    # sanitized run: edges, races, leaks
      }
    }
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

#: finding kind -> one-line description — the catalog of record
#: (docs/corrosan.md must list every id; a tier-1 meta-test enforces it)
KINDS: Dict[str, str] = {
    "attr-race": (
        "two threads accessed the same shared attribute (>=1 write) "
        "with no happens-before ordering between them"
    ),
    "lock-edge-unknown": (
        "a witnessed lock-acquisition edge falls outside corrolint's "
        "static lock-order graph (and is not allow-listed)"
    ),
    "lock-cycle": (
        "witnessed acquisitions complete a cycle (alone or with the "
        "static edges) — a deadlock two threads can reach"
    ),
    "fs-resurrect": (
        "a watched file survives teardown via a write that another "
        "thread's delete should have killed (manifest-resurrection "
        "shape, the pubsub unsubscribe-vs-persist race)"
    ),
    "thread-leak": (
        "a thread spawned during the sanitized window is still alive "
        "at the gate"
    ),
    "executor-leak": (
        "a ThreadPoolExecutor created during the window was never "
        "shut down"
    ),
    "fd-leak": (
        "a file opened under a watched root is still open at the gate"
    ),
}


@dataclasses.dataclass(frozen=True, order=True)
class SanFinding:
    kind: str
    subject: str  # "Class.attr", "nodeA -> nodeB", thread/file name
    message: str
    site: str = ""  # "path:line" of the flagged access, when known
    thread: str = ""

    def render(self) -> str:
        where = f" at {self.site}" if self.site else ""
        who = f" [{self.thread}]" if self.thread else ""
        return f"{self.kind}: {self.subject}: {self.message}{where}{who}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def write_section(path: str, section: str, payload: dict) -> None:
    """Read-modify-write one section of the report file (creating it
    and its directory on first write). Corrupt/legacy content is
    replaced rather than crashing the gate that is trying to report."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    doc: dict = {"version": 1, "tool": "corrosan", "sections": {}}
    if os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and isinstance(
                    loaded.get("sections"), dict):
                doc = loaded
        except (OSError, ValueError):
            pass
    doc["sections"][section] = payload
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load_section(path: str, section: str) -> Optional[dict]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)["sections"].get(section)
    except (OSError, ValueError, KeyError):
        return None


def findings_payload(findings: List[SanFinding]) -> dict:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.kind] = counts.get(f.kind, 0) + 1
    return {
        "findings": [f.to_json() for f in sorted(findings)],
        "kind_counts": counts,
        "clean": not findings,
    }
