"""Filesystem witness: happens-before over watched paths (port of
``corrosion_tpu/analysis/sanitizer/fsops.py``).

The pubsub bug class: a background writer's ``open(path, "w")``
racing another thread's ``os.unlink(path)`` resurrects a manifest the
unsubscribe just killed. Attribute-level shadow state cannot see it (the
shared resource is a *path*, not an attribute), so corrosan records
write/delete operations on paths under registered watch roots, each
stamped with the acting thread's full vector clock.

Gate rule (``fs-resurrect``): a path that still EXISTS at the gate,
whose final recorded operation is a write, where some delete by a
*different* thread is ordered before or concurrent with that write. The
fixed persist worker ends every such interleaving with its own
re-check-and-unlink — final op a delete, path gone, clean — while the
pre-fix worker ends on the resurrecting write and is flagged. Same-path
delete-then-rewrite by ONE thread (checkpoint side rotation) is the
normal case and never flags.

File handles opened under a watch root are also tracked (weakly) for
the ``fd-leak`` gate.
"""

from __future__ import annotations

import _thread
import dataclasses
import os
import weakref
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.analysis.sanitizer import vc as _vc
from corrosion_tpu_torch.analysis.sanitizer.frames import call_site, realpath_cached
from corrosion_tpu_torch.analysis.sanitizer.report import SanFinding


@dataclasses.dataclass
class _Op:
    kind: str  # "write" | "delete"
    tid: int
    clock: Dict[int, int]
    thread: str
    site: str


class FsWitness:
    def __init__(self, san):
        self._san = san
        self._ilock = _thread.allocate_lock()
        self._roots: List[str] = []
        self._log: Dict[str, List[_Op]] = {}
        self._files: List[Tuple[weakref.ref, str]] = []

    def watch(self, root: str) -> None:
        """Track write/delete/open ops on every path under ``root``."""
        real = realpath_cached(str(root))
        with self._ilock:
            if real not in self._roots:
                self._roots.append(real)

    def _watched(self, path) -> Optional[str]:
        if not self._roots or not isinstance(path, (str, bytes, os.PathLike)):
            return None
        real = realpath_cached(os.fspath(path))
        if not isinstance(real, str):
            return None
        for root in self._roots:
            if real == root or real.startswith(root + os.sep):
                return real
        return None

    def _record(self, path, kind: str) -> None:
        real = self._watched(path)
        if real is None:
            return
        st = self._san.thread_state()
        if st.busy:
            return
        name = self._san.thread_display_name(st)
        st.busy = True
        try:
            op = _Op(kind=kind, tid=st.tid, clock=dict(st.vc),
                     thread=name, site=call_site())
            with self._ilock:
                self._log.setdefault(real, []).append(op)
        finally:
            st.busy = False

    # --- hook surface (runtime.py patches route here) --------------------
    def on_open(self, path, mode: str, fobj) -> None:
        if self._watched(path) is None:
            return
        if any(c in mode for c in "wax+"):
            self._record(path, "write")
        try:
            ref = weakref.ref(fobj)
        except TypeError:
            return
        with self._ilock:
            self._files.append((ref, os.fspath(path)))

    def on_delete(self, path) -> None:
        self._record(path, "delete")

    def on_replace(self, src, dst) -> None:
        self.on_delete(src)
        self._record(dst, "write")

    # --- gate -------------------------------------------------------------
    def ops_payload(self) -> dict:
        with self._ilock:
            return {
                path: [(o.kind, o.thread, o.site) for o in ops]
                for path, ops in sorted(self._log.items())
            }

    def check(self) -> List[SanFinding]:
        findings: List[SanFinding] = []
        with self._ilock:
            log = {p: list(ops) for p, ops in self._log.items()}
            files = list(self._files)
        for path, ops in sorted(log.items()):
            last = ops[-1]
            if last.kind != "write" or not os.path.exists(path):
                continue
            for op in ops[:-1]:
                if op.kind != "delete" or op.tid == last.tid:
                    continue
                if _vc.clock_before(last.clock, op.clock):
                    continue  # the delete is strictly after this write
                findings.append(SanFinding(
                    kind="fs-resurrect", subject=path,
                    message=(
                        f"file survives the gate through a write by "
                        f"{last.thread} that {op.thread}'s delete "
                        "(ordered before or concurrent) should have "
                        "killed — unsubscribe-vs-persist resurrection "
                        "shape"
                    ),
                    site=last.site, thread=last.thread,
                ))
                break
        for ref, path in files:
            f = ref()
            if f is not None and not f.closed:
                findings.append(SanFinding(
                    kind="fd-leak", subject=path,
                    message="file opened under a watch root is still "
                            "open at the gate",
                ))
        return findings
