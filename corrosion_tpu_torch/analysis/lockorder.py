"""lock-order: deadlock freedom as a graph property (port of
``corrosion_tpu/analysis/lockorder.py``).

The lock-discipline checker deliberately scopes itself to single-lock
classes — which lock guards which attribute is not inferable for
multi-lock classes, and cross-class nesting is invisible to a
per-function pass. This checker lifts both limits for the one property
that IS inferable mechanically: the **acquisition order**. It builds a
directed graph over every lock in the linted set
(``self.<attr> = threading.Lock()/RLock()`` per class, module-level
``_mu = threading.Lock()``) with an edge A -> B wherever B is acquired
while A is held — through direct ``with`` nesting AND through calls
(``Supervisor.call`` taking its lock inside a method that already
holds the writer's, a ``*_locked`` helper acquiring someone else's
lock), resolved over the project call graph with per-function
"acquires transitively" summaries run to a fixed point.

Two rules fall out of the graph:

- **lock-cycle** — a non-reentrant ``threading.Lock`` re-acquired
  while already held (a self-edge): certain single-thread deadlock.
  RLocks are exempt from self-edges by construction.
- **lock-inversion** — two locks acquired in opposite orders on two
  code paths (a 2-cycle), or any longer cycle: the classic ABBA
  deadlock, needing two threads and the right interleaving — exactly
  the bug class runtime tests only catch on the path they happen to
  take.

Unresolvable acquisitions (``other_obj._mu`` where the receiver's
class is unknown) grow NO edge: with every lock in this repo named
``_mu``, guessing by attribute name would invent cycles that don't
exist. Precision over recall, as with every checker here.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from corrosion_tpu_torch.analysis.base import Finding, dotted_name, walk_shallow
from corrosion_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    Project,
    fixpoint,
)

RULE_CYCLE = "lock-cycle"
RULE_INVERSION = "lock-inversion"

_LOCK_CTORS = {
    "threading.Lock": "Lock", "threading.RLock": "RLock",
    "Lock": "Lock", "RLock": "RLock",
}


@dataclasses.dataclass(frozen=True)
class LockNode:
    name: str  # "mod.Class._mu" or "mod._lock"
    kind: str  # "Lock" | "RLock"

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Site:
    path: str
    line: int
    where: str  # human context: "Class.method" or "func"


def _self_attr(node) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _collect_locks(project: Project) -> Tuple[
        Dict[Tuple[str, str, str], LockNode],
        Dict[Tuple[str, str], LockNode],
        Dict[LockNode, Tuple[str, int]]]:
    """(class locks keyed by (module, class name, attr) — two
    same-named classes in different modules own DIFFERENT locks —
    module locks keyed by (module name, var), creation sites keyed by
    node). The creation site is the line of the ``threading.Lock()``
    call itself — the runtime sanitizer names live lock objects by
    matching the frame that executes that line, so the dynamic witness
    and this static graph share one node namespace."""
    class_locks: Dict[Tuple[str, str, str], LockNode] = {}
    module_locks: Dict[Tuple[str, str], LockNode] = {}
    sites: Dict[LockNode, Tuple[str, int]] = {}
    for mod in project.modules:
        for top in mod.tree.body:
            if isinstance(top, ast.Assign) and isinstance(
                    top.value, ast.Call):
                kind = _LOCK_CTORS.get(dotted_name(top.value.func))
                if kind:
                    for tgt in top.targets:
                        if isinstance(tgt, ast.Name):
                            lock = LockNode(
                                f"{mod.name}.{tgt.id}", kind)
                            module_locks[(mod.name, tgt.id)] = lock
                            sites[lock] = (mod.path, top.value.lineno)
            if not isinstance(top, ast.ClassDef):
                continue
            # walk the class's own body without descending into nested
            # classes — their locks belong to THEIR instances
            stack: List[ast.AST] = list(top.body)
            while stack:
                node = stack.pop()
                if isinstance(node, ast.ClassDef):
                    continue
                stack.extend(ast.iter_child_nodes(node))
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                kind = _LOCK_CTORS.get(dotted_name(node.value.func))
                if not kind:
                    continue
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr:
                        lock = LockNode(
                            f"{mod.name}.{top.name}.{attr}", kind)
                        class_locks[(mod.name, top.name, attr)] = lock
                        sites[lock] = (mod.path, node.value.lineno)
    return class_locks, module_locks, sites


class _Edges:
    def __init__(self):
        self.edges: Dict[Tuple[LockNode, LockNode], List[Site]] = {}

    def add(self, held: LockNode, acquired: LockNode, site: Site) -> None:
        self.edges.setdefault((held, acquired), []).append(site)


class _FnScan:
    """One function: held-set tracking + (acquire, call) events.

    ``summaries`` maps qualname -> frozenset[LockNode] acquired
    transitively. With ``edges`` given, A->B edges are recorded."""

    def __init__(self, fn: FunctionInfo, project: Project,
                 class_locks, module_locks,
                 summaries: Dict[str, FrozenSet[LockNode]],
                 edges: Optional[_Edges]):
        self.fn = fn
        self.project = project
        self.class_locks = class_locks
        self.module_locks = module_locks
        self.summaries = summaries
        self.edges = edges
        self.acquired: Set[LockNode] = set()
        self._own = [
            lock for (m, c, _), lock in class_locks.items()
            if fn.cls is not None and c == fn.cls.name
            and m == fn.module.name
        ]

    def _where(self) -> str:
        return (f"{self.fn.cls.name}.{self.fn.name}" if self.fn.cls
                else self.fn.name)

    def _entry_held(self) -> FrozenSet[LockNode]:
        # the *_locked convention: the (single) class lock is held by
        # the caller on entry; with several class locks the convention
        # is ambiguous and we assume nothing
        if self.fn.name.endswith("_locked") and len(self._own) == 1:
            return frozenset(self._own)
        return frozenset()

    def _resolve_lock(self, expr: ast.AST) -> Optional[LockNode]:
        attr = _self_attr(expr)
        if attr is not None and self.fn.cls is not None:
            return self.class_locks.get(
                (self.fn.module.name, self.fn.cls.name, attr))
        if isinstance(expr, ast.Name):
            return self.module_locks.get(
                (self.fn.module.name, expr.id))
        return None

    def _note_acquire(self, lock: LockNode, held: FrozenSet[LockNode],
                      node: ast.AST) -> None:
        self.acquired.add(lock)
        if self.edges is None:
            return
        site = Site(self.fn.path, node.lineno, self._where())
        for h in held:
            if h == lock and lock.kind == "RLock":
                continue  # reentrant by design
            self.edges.add(h, lock, site)

    def _note_call(self, call: ast.Call, held: FrozenSet[LockNode]
                   ) -> None:
        callee = self.project.resolve_call(call, self.fn)
        if callee is None:
            return
        acq = self.summaries.get(callee.qualname) or frozenset()
        self.acquired |= acq
        if self.edges is None or not held:
            return
        site = Site(self.fn.path, call.lineno,
                    f"{self._where()} -> {callee.name}()")
        for h in held:
            for lock in acq:
                if h == lock and lock.kind == "RLock":
                    continue
                self.edges.add(h, lock, site)

    def run(self) -> FrozenSet[LockNode]:
        self._scan(list(self.fn.node.body), self._entry_held())
        return frozenset(self.acquired)

    def _scan_expr(self, node: Optional[ast.AST],
                   held: FrozenSet[LockNode]) -> None:
        # lambda bodies run LATER, lock long released — calls inside
        # them must not grow held->acquired edges. walk_shallow skips
        # nested lambdas; the root-is-a-lambda case needs its own guard
        if node is None or isinstance(node, ast.Lambda):
            return
        for sub in walk_shallow(node):
            if isinstance(sub, ast.Call):
                self._note_call(sub, held)

    def _scan(self, body: List[ast.stmt],
              held: FrozenSet[LockNode]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # closures run with no lock held, later
            if isinstance(stmt, ast.With):
                inner = held
                for item in stmt.items:
                    self._scan_expr(item.context_expr, held)
                    lock = self._resolve_lock(item.context_expr)
                    if lock is not None:
                        self._note_acquire(lock, inner, stmt)
                        inner = inner | {lock}
                self._scan(stmt.body, inner)
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._scan(sub, held)
            for handler in getattr(stmt, "handlers", []):
                self._scan(handler.body, held)
            for attr in ("value", "test", "iter", "exc", "targets"):
                sub = getattr(stmt, attr, None)
                if isinstance(sub, ast.AST):
                    self._scan_expr(sub, held)
                elif isinstance(sub, list):
                    for s in sub:
                        self._scan_expr(s, held)


def _find_cycles(edges: Dict[Tuple[LockNode, LockNode], List[Site]]
                 ) -> List[List[LockNode]]:
    """Elementary cycles, shortest-first, each reported once (the graph
    here has a handful of nodes — simple DFS is plenty)."""
    graph: Dict[LockNode, Set[LockNode]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    seen: Set[FrozenSet[LockNode]] = set()
    cycles: List[List[LockNode]] = []

    max_len = len(graph)  # elementary cycles can't exceed the node count

    def dfs(start: LockNode, node: LockNode, path: List[LockNode]):
        for nxt in sorted(graph.get(node, ()), key=repr):
            if nxt == start and len(path) >= 1:
                key = frozenset(path)
                if key not in seen:
                    seen.add(key)
                    cycles.append(list(path))
            elif nxt not in path and len(path) < max_len:
                dfs(start, nxt, path + [nxt])

    for node in sorted(graph, key=repr):
        dfs(node, node, [node])
    cycles.sort(key=len)
    return cycles


@dataclasses.dataclass
class LockGraph:
    """The static lock model: every lock in the walked set plus the
    acquisition-order edges derived over the call graph. Consumed by
    :func:`check_project` below AND by the runtime sanitizer
    (``analysis/sanitizer``), whose witnessed edges must stay a subset
    of ``edges`` — the static/dynamic cross-check."""

    class_locks: Dict[Tuple[str, str, str], LockNode]
    module_locks: Dict[Tuple[str, str], LockNode]
    #: LockNode -> (path, line) of the ``threading.Lock()`` call
    creation_sites: Dict[LockNode, Tuple[str, int]]
    edges: Dict[Tuple[LockNode, LockNode], List[Site]]

    def edge_names(self) -> Set[Tuple[str, str]]:
        return {(a.name, b.name) for (a, b) in self.edges}


def build_lock_graph(project: Project) -> LockGraph:
    """Collect every lock and every statically-derivable acquisition
    edge (direct ``with`` nesting + transitive-acquire call summaries
    run to a fixed point)."""
    class_locks, module_locks, sites = _collect_locks(project)

    def summarize(fn: FunctionInfo, summaries):
        return _FnScan(fn, project, class_locks, module_locks,
                       summaries, edges=None).run()

    summaries = fixpoint(project, summarize)
    edges = _Edges()
    for fn in project.iter_functions():
        _FnScan(fn, project, class_locks, module_locks, summaries,
                edges).run()
    return LockGraph(class_locks=class_locks, module_locks=module_locks,
                     creation_sites=sites, edges=edges.edges)


def check_project(project: Project) -> List[Finding]:
    edges = _Edges()
    edges.edges = build_lock_graph(project).edges

    findings: List[Finding] = []
    # self-edges: non-reentrant re-acquisition (RLocks filtered above)
    for (a, b), sites in sorted(edges.edges.items(), key=repr):
        if a == b:
            site = sites[0]
            findings.append(Finding(
                path=site.path, line=site.line, rule=RULE_CYCLE,
                message=f"non-reentrant {a.name} re-acquired while "
                        f"already held (in {site.where}) — "
                        "single-thread deadlock",
                hint="split a *_locked helper, or make the lock an "
                     "RLock if re-entry is genuinely intended",
            ))
    # multi-lock cycles: inversion (len 2) and longer cycles
    for cycle in _find_cycles(edges.edges):
        if len(cycle) < 2:
            continue  # self-edges already reported
        ring = cycle + [cycle[0]]
        sites = [
            edges.edges[(ring[i], ring[i + 1])][0]
            for i in range(len(cycle))
            if (ring[i], ring[i + 1]) in edges.edges
        ]
        order = " -> ".join(n.name for n in ring)
        rule = RULE_INVERSION if len(cycle) == 2 else RULE_CYCLE
        detail = "; ".join(
            f"{s.path}:{s.line} ({s.where})" for s in sites[:4])
        findings.append(Finding(
            path=sites[0].path, line=sites[0].line, rule=rule,
            message=f"lock acquisition cycle {order} — opposite-order "
                    f"paths can deadlock; acquisition sites: {detail}",
            hint="pick one global order for these locks and re-nest "
                 "the odd path out (or stage data and call unlocked)",
        ))
    return sorted(findings)
