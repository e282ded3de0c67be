"""Module-level call graph over the linted file set (port of
``corrosion_tpu/analysis/callgraph.py``).

The per-file checkers are single-function: a property that crosses a
call boundary (a lock taken inside a callee, a ``*_locked`` helper
acquiring someone else's lock) is invisible to them. This module builds
the shared substrate the interprocedural lock-order pass
(``lockorder.py``) runs on:

- :class:`Project` — every parsed module plus an index of every
  function/method by qualified name;
- :meth:`Project.resolve_call` — best-effort, *precision-over-recall*
  callee resolution (see below);
- :func:`fixpoint` — a worklist driver for computing per-function
  summaries (acquired locks) to a fixed point over the graph.

Resolution rules — deliberately conservative, an unresolved call simply
grows no edge (never a wrong one):

- ``name(...)``       -> abstain if the name is bound locally (param,
  store, nested def — Python scoping shadows everything else); else a
  function in the SAME module; else the unique function with that bare
  name across the project (bare names reach other modules through
  imports, so a project-unique match is the imported function); else
  unresolved;
- ``self.m(...)``     -> method ``m`` of the enclosing class, else the
  unique method named ``m`` project-wide, else unresolved;
- ``obj.m(...)``      -> exactly one candidate named ``m`` in the
  CALLER'S OWN module, else unresolved. External receivers share
  method names (``.submit``, ``.get``, ``.put``), so project-wide
  resolution here would mint wrong facts for every stdlib call that
  collides; cross-module object calls deliberately grow no facts.

Names that are ambiguous at the applicable scope (two helpers both
called ``check``) therefore never carry interprocedural facts; the
per-file lexical checkers still cover them.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from corrosion_tpu_torch.analysis.base import Finding, dotted_name

#: the package whose path component starts a module name
PACKAGE = "corrosion_tpu_torch"


@dataclasses.dataclass
class ModuleInfo:
    path: str
    name: str  # dotted module name derived from the path
    tree: ast.Module
    source: str
    suppressions: Dict[int, set]
    bad_suppressions: List[Finding]


@dataclasses.dataclass
class FunctionInfo:
    qualname: str  # "pkg.mod.Class.method" / "pkg.mod.func"
    name: str  # bare name
    module: ModuleInfo
    cls: Optional[ast.ClassDef]
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    _local_names: Optional[frozenset] = None

    @property
    def path(self) -> str:
        return self.module.path

    def param_names(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args]

    def local_names(self) -> frozenset:
        """Names bound inside this function (params, stores, nested
        defs): a call to one of these is a LOCAL binding — Python
        scoping shadows any same-named module function, so resolution
        must abstain rather than attribute someone else's facts."""
        if self._local_names is None:
            a = self.node.args
            names = {p.arg for p in (a.posonlyargs + a.args
                                     + a.kwonlyargs)}
            for extra in (a.vararg, a.kwarg):
                if extra is not None:
                    names.add(extra.arg)
            for sub in ast.walk(self.node):
                if isinstance(sub, ast.Name) and isinstance(
                        sub.ctx, ast.Store):
                    names.add(sub.id)
                elif isinstance(sub, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) and (
                        sub is not self.node):
                    names.add(sub.name)
            self._local_names = frozenset(names)
        return self._local_names


def module_name_for(path: str) -> str:
    """Dotted module name from a file path: everything from the LAST
    ``corrosion_tpu_torch`` component down, or the full path dotted for
    out-of-package files (``chip_smoke.py``) — two distinct files must
    never share a module name (qualnames would collide and the lock
    graph would merge two modules' locks)."""
    norm = os.path.normpath(path)
    parts = [p for p in norm.split(os.sep) if p and p != "."]
    if PACKAGE in parts:
        last = len(parts) - 1 - parts[::-1].index(PACKAGE)
        parts = parts[last:]
    else:
        parts = [p if p != ".." else "__up__" for p in parts]
    if parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts = parts[:-1] or ["__init__"]
    return ".".join(parts)


class Project:
    """The linted file set, indexed for interprocedural passes."""

    def __init__(self, modules: Iterable[ModuleInfo]):
        self.modules: List[ModuleInfo] = list(modules)
        self.functions: Dict[str, FunctionInfo] = {}
        #: bare name -> every function carrying it (resolution fodder)
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        #: (class name, method name) -> FunctionInfo list
        self.methods: Dict[Tuple[str, str], List[FunctionInfo]] = {}
        for mod in self.modules:
            self._index_module(mod)

    def _index_module(self, mod: ModuleInfo) -> None:
        def add(node, cls: Optional[ast.ClassDef]) -> None:
            qual = (f"{mod.name}.{cls.name}.{node.name}" if cls
                    else f"{mod.name}.{node.name}")
            info = FunctionInfo(
                qualname=qual, name=node.name, module=mod, cls=cls,
                node=node,
            )
            self.functions[qual] = info
            self.by_name.setdefault(node.name, []).append(info)
            if cls is not None:
                self.methods.setdefault((cls.name, node.name), []).append(
                    info)

        for top in mod.tree.body:
            if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(top, None)
            elif isinstance(top, ast.ClassDef):
                for sub in top.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        add(sub, top)

    # -- resolution --------------------------------------------------------

    def _unique(self, name: str) -> Optional[FunctionInfo]:
        cands = self.by_name.get(name, [])
        return cands[0] if len(cands) == 1 else None

    def resolve_call(self, call: ast.Call,
                     caller: FunctionInfo) -> Optional[FunctionInfo]:
        """The callee FunctionInfo, or None when it cannot be pinned
        down without guessing."""
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in caller.local_names():
                return None  # locally bound (closure/param/rebind):
                # the local binding shadows any module-level function
            mod_qual = f"{caller.module.name}.{func.id}"
            if mod_qual in self.functions:
                return self.functions[mod_qual]
            return self._unique(func.id)
        if isinstance(func, ast.Attribute):
            base = dotted_name(func.value)
            if base == "self" and caller.cls is not None:
                own = self.methods.get((caller.cls.name, func.attr), [])
                for cand in own:
                    if cand.module is caller.module:
                        return cand
                if len(own) == 1:
                    return own[0]
            # unknown receiver: external types share method names
            # (.submit, .get, .put...) — resolving to a project-unique
            # function regardless of receiver would mint wrong facts
            # for every stdlib/third-party call that happens to
            # collide. Resolve only when exactly ONE candidate lives
            # in the CALLER'S OWN module (cross-module object calls
            # grow no facts; the registries cover the hot surfaces).
            local = [
                cand for cand in self.by_name.get(func.attr, [])
                if cand.module is caller.module
            ]
            return local[0] if len(local) == 1 else None
        return None

    def iter_functions(self) -> Iterable[FunctionInfo]:
        return self.functions.values()


def fixpoint(
    project: Project,
    summarize: Callable[[FunctionInfo, Dict[str, object]], object],
    max_rounds: int = 12,
) -> Dict[str, object]:
    """Compute per-function summaries to a fixed point.

    ``summarize(fn, summaries)`` returns fn's summary given the current
    (possibly incomplete) summaries of everyone else, keyed by qualname;
    the driver iterates until nothing changes. ``max_rounds`` bounds
    pathological ping-pong (the repo's call graph converges in 2-3) —
    the summaries are monotone in every checker here, so a truncated
    run only loses findings, never invents them.
    """
    summaries: Dict[str, object] = {}
    for _ in range(max_rounds):
        changed = False
        for fn in project.iter_functions():
            new = summarize(fn, summaries)
            if summaries.get(fn.qualname) != new:
                summaries[fn.qualname] = new
                changed = True
        if not changed:
            break
    return summaries
