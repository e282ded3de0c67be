"""Runtime lock-order witness, cross-checked against corrolint (port of
``corrosion_tpu/analysis/sanitizer/witness.py``).

Every instrumented lock acquisition that happens while other
instrumented locks are held records an edge ``held -> acquired``. Locks
are *named* by creation site: when a lock is constructed, the creation
stack is matched against the static lock graph's creation-site map
(``lockorder.build_lock_graph``) — a lock born on the
``self._mu = threading.Lock()`` line of ``pubsub.Matcher`` IS the
static node ``corrosion_tpu_torch.pubsub.Matcher._mu``, so the witnessed
graph and corrolint's static graph share one namespace by construction.
Locks born anywhere else (stdlib queue mutexes, fixture locks) are
anonymous, keyed per-instance.

Gate:

- **subset**: every witnessed edge between two NAMED locks must be an
  edge of the static graph (or carry an ``ALLOWED_LOCK_EDGES`` entry
  with a reason) — a dynamically-created edge static call resolution
  provably cannot see must be argued in, never silently absorbed;
- **cycles**: the union of witnessed edges and static edges must stay
  acyclic (anonymous locks participate per-instance: a witnessed ABBA
  on fixture locks is a cycle even though the subset check cannot see
  it).
"""

from __future__ import annotations

import _thread
import dataclasses
import os
from typing import Dict, Iterator, List, Set, Tuple

from corrosion_tpu_torch.analysis.sanitizer.allowlist import ALLOWED_LOCK_EDGES
from corrosion_tpu_torch.analysis.sanitizer.frames import (
    call_site,
    iter_call_frames,
    realpath_cached,
)
from corrosion_tpu_torch.analysis.sanitizer.report import SanFinding

_GRAPH_CACHE = None


def static_lock_graph():
    """The package's static lock graph (parsed once per process)."""
    global _GRAPH_CACHE
    if _GRAPH_CACHE is None:
        import ast

        import corrosion_tpu_torch
        from corrosion_tpu_torch.analysis.callgraph import (
            ModuleInfo,
            Project,
            module_name_for,
        )
        from corrosion_tpu_torch.analysis.lockorder import build_lock_graph
        from corrosion_tpu_torch.analysis.runner import iter_python_files

        pkg = os.path.dirname(os.path.abspath(corrosion_tpu_torch.__file__))
        modules = []
        for path in iter_python_files([pkg]):
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            try:
                tree = ast.parse(source)
            except SyntaxError:
                continue  # the lint gate owns reporting unparseable files
            modules.append(ModuleInfo(
                path=path, name=module_name_for(path), tree=tree,
                source=source, suppressions={}, bad_suppressions=[],
            ))
        _GRAPH_CACHE = build_lock_graph(Project(modules))
    return _GRAPH_CACHE


@dataclasses.dataclass
class _EdgeRec:
    frm: str
    to: str
    named: bool  # both endpoints are static nodes
    same_node: bool  # same static node, distinct instances
    site: str
    thread: str
    count: int = 1
    # strong refs to anonymous endpoints: their graph key is id(), and
    # letting one die would free its address for a NEW lock to reuse —
    # aliasing a dead lock's edges into phantom cycles. Bounded by the
    # (small) count of distinct witnessed edges.
    anchors: tuple = ()


class LockWitness:
    def __init__(self, san):
        self._san = san
        self._ilock = _thread.allocate_lock()
        self.graph = None  # static LockGraph, set by prepare()
        self._site_map: Dict[Tuple[str, int], object] = {}
        self._edges: Dict[Tuple[object, object], _EdgeRec] = {}

    def prepare(self) -> None:
        self.graph = static_lock_graph()
        for node, (path, line) in self.graph.creation_sites.items():
            self._site_map[(realpath_cached(path), line)] = node

    # --- naming -----------------------------------------------------------
    def name_new_lock(self, lock, kind: str) -> None:
        """Match the creation stack against the static creation-site
        map; first hit names the lock (the ``TrackedLock`` wrapper's
        inner RLock matches the wrapper's own creation line, exactly as
        the static model sees it)."""
        for filename, lineno in iter_call_frames(skip=2):
            node = self._site_map.get((realpath_cached(filename), lineno))
            if node is not None:
                lock.san_node = node
                return
        lock.san_node = None
        lock.san_site = call_site()

    @staticmethod
    def _key(lock):
        node = getattr(lock, "san_node", None)
        if node is not None:
            return node.name
        return id(lock)

    @staticmethod
    def _label(lock) -> str:
        node = getattr(lock, "san_node", None)
        if node is not None:
            return node.name
        site = getattr(lock, "san_site", "") or "?"
        return f"anon:{site}"

    # --- recording --------------------------------------------------------
    def on_edge(self, held: list, lock, st) -> None:
        kb = self._key(lock)
        thread_name = self._san.thread_display_name(st)
        for h in held:
            if h is lock:
                continue
            ka = self._key(h)
            ek = (ka, kb)
            with self._ilock:
                rec = self._edges.get(ek)
                if rec is not None:
                    rec.count += 1
                    continue
                h_named = getattr(h, "san_node", None) is not None
                l_named = getattr(lock, "san_node", None) is not None
                self._edges[ek] = _EdgeRec(
                    frm=self._label(h), to=self._label(lock),
                    named=h_named and l_named,
                    same_node=(ka == kb),
                    site=call_site(), thread=thread_name,
                    anchors=tuple(
                        obj for obj, named in ((h, h_named), (lock, l_named))
                        if not named
                    ),
                )

    # --- gate -------------------------------------------------------------
    def named_edges(self) -> Set[Tuple[str, str]]:
        with self._ilock:
            return {(r.frm, r.to) for r in self._edges.values()
                    if r.named and not r.same_node}

    def edges_payload(self) -> List[dict]:
        static_names = self.graph.edge_names() if self.graph else set()
        with self._ilock:
            return [
                {
                    "from": r.frm, "to": r.to, "count": r.count,
                    "named": r.named, "site": r.site, "thread": r.thread,
                    "in_static": r.named and (r.frm, r.to) in static_names,
                }
                for r in sorted(self._edges.values(),
                                key=lambda r: (r.frm, r.to))
            ]

    def check(self) -> List[SanFinding]:
        findings: List[SanFinding] = []
        static_names = self.graph.edge_names() if self.graph else set()
        with self._ilock:
            recs = list(self._edges.items())
        graph: Dict[object, Set[object]] = {}
        for (ka, kb), rec in recs:
            graph.setdefault(ka, set()).add(kb)
            graph.setdefault(kb, set())
            if not rec.named:
                continue
            if ((rec.frm, rec.to) in static_names
                    or (rec.frm, rec.to) in ALLOWED_LOCK_EDGES):
                continue
            if rec.same_node:
                findings.append(SanFinding(
                    kind="lock-edge-unknown",
                    subject=f"{rec.frm} -> {rec.to}",
                    message=(
                        "two distinct instances of the same lock node "
                        "nested — instance-level ordering the static "
                        "model cannot express; pick an order and "
                        "allow-list it with the argument"
                    ),
                    site=rec.site, thread=rec.thread,
                ))
                continue
            findings.append(SanFinding(
                kind="lock-edge-unknown",
                subject=f"{rec.frm} -> {rec.to}",
                message=(
                    f"witnessed {rec.count}x but absent from "
                    "corrolint's static lock-order graph — a "
                    "dynamically-created edge the static model cannot "
                    "see; teach lockorder.py the path or allow-list "
                    "it with a reason"
                ),
                site=rec.site, thread=rec.thread,
            ))
        # static edges join the cycle search: a witnessed edge that
        # closes a loop AGAINST a static edge is a real ABBA even when
        # each edge alone looks fine
        for (a, b) in static_names:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        for cycle in _find_cycles(graph):
            labels = [self._node_label(k) for k in cycle]
            ring = " -> ".join(labels + [labels[0]])
            findings.append(SanFinding(
                kind="lock-cycle", subject=ring,
                message=(
                    "witnessed acquisitions complete a lock cycle — "
                    "two threads taking opposite paths deadlock"
                ),
            ))
        return findings

    def _node_label(self, key) -> str:
        if isinstance(key, str):
            return key
        with self._ilock:
            for (ka, kb), rec in self._edges.items():
                if ka == key:
                    return rec.frm
                if kb == key:
                    return rec.to
        return f"anon:{key}"


def _find_cycles(graph: Dict[object, Set[object]]
                 ) -> Iterator[List[object]]:
    """Elementary cycles of length >= 2, each reported once. Self-loops
    are excluded here — the subset check reports same-node nesting with
    better context."""
    seen: Set[frozenset] = set()
    max_len = len(graph)
    order = sorted(graph, key=repr)

    def dfs(start, node, path):
        for nxt in sorted(graph.get(node, ()), key=repr):
            if nxt == start and len(path) >= 2:
                key = frozenset(path)
                if key not in seen:
                    seen.add(key)
                    yield list(path)
            elif nxt != start and nxt not in path and len(path) < max_len:
                yield from dfs(start, nxt, path + [nxt])

    for node in order:
        yield from dfs(node, node, [node])
