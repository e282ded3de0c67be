"""lock-discipline: one lock, one discipline, checked mechanically (port
of ``corrosion_tpu/analysis/locks.py``).

The threaded hosts in this repo (checkpoint writers, supervisors, the
assertion registry, pubsub matchers) follow one convention: a class
creates a single ``threading.Lock``/``RLock`` attribute in ``__init__``
and every mutation of its private (``self._*``) shared state happens
inside ``with self.<lock>:``. This checker enforces the convention for
exactly that shape:

- **unlocked-mutation** — a method assigns / aug-assigns / subscript-
  stores / calls a known mutator (``append``, ``pop``, ``update``, ...)
  on a private instance attribute outside the lock.
- **blocking-under-lock** — file IO (``open``), future ``.result()``,
  ``time.sleep``, a device sync (``torch.cuda.synchronize``, a stream's
  or event's ``.synchronize()``), subprocess or ``os.replace``-style
  filesystem calls made while the lock is held: the reference's
  LockRegistry watchdog catches these at runtime as 10s-held locks; here
  they are caught at review time.

Scope rules (precision over recall):

- classes owning **more than one** lock are skipped — which lock guards
  which attribute is a design fact AST cannot recover;
- ``__init__`` is exempt (the object is not shared yet);
- a method named ``*_locked`` is treated as called with the lock held
  (the ``_flush_locked`` convention);
- a nested ``def`` resets the held-lock context: a closure defined
  under ``with`` runs later, when the lock is long released;
- ``self._cv = threading.Condition(self.<lock>)`` makes ``self._cv``
  an ALIAS of the lock (a Condition shares the mutex it wraps), so
  ``with self._cv:`` counts as holding it — the admission-controller
  idiom. A Condition wrapping anything else stays out of scope.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from corrosion_tpu_torch.analysis.base import Finding, dotted_name

RULE_MUTATION = "unlocked-mutation"
RULE_BLOCKING = "blocking-under-lock"

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}
_CONDITION_CTORS = {"threading.Condition", "Condition"}

#: container methods that mutate their receiver
_MUTATORS = {
    "append", "extend", "add", "insert", "remove", "discard", "clear",
    "pop", "popleft", "popitem", "update", "setdefault", "appendleft",
}

#: calls that block (or do IO) and must not run under the instance lock
_BLOCKING_NAMES = {"open", "sleep", "synchronize"}
_BLOCKING_DOTTED = {
    "time.sleep", "torch.cuda.synchronize",
    "subprocess.run", "subprocess.check_call", "subprocess.check_output",
    "subprocess.Popen", "os.replace", "os.rename", "os.remove",
    "os.unlink", "os.makedirs", "shutil.rmtree", "shutil.copy",
    "shutil.copytree",
}
#: fut.result() waits on another thread; .synchronize() on the card
_BLOCKING_METHODS = {"result", "synchronize"}


def _self_attr(node) -> Optional[str]:
    """'x' for ``self.x``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _walk_own_class(cls: ast.ClassDef):
    """Walk a class's own body without descending into nested classes —
    an inner class's lock belongs to ITS instances, and counting it
    here would wrongly flip the outer class to 'multi-lock, skipped'."""
    stack: list = list(cls.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    attrs: Set[str] = set()
    for node in _walk_own_class(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if dotted_name(node.value.func) in _LOCK_CTORS:
                for tgt in node.targets:
                    name = _self_attr(tgt)
                    if name:
                        attrs.add(name)
    return attrs


def _cv_aliases(cls: ast.ClassDef, lock_attr: str) -> Set[str]:
    """Attrs bound to ``threading.Condition(self.<lock>)``: the
    Condition shares the class's own mutex, so entering it IS entering
    the lock."""
    aliases: Set[str] = set()
    for node in _walk_own_class(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            if (dotted_name(call.func) in _CONDITION_CTORS
                    and len(call.args) == 1
                    and _self_attr(call.args[0]) == lock_attr):
                for tgt in node.targets:
                    name = _self_attr(tgt)
                    if name:
                        aliases.add(name)
    return aliases


def _is_lock_with(item: ast.withitem, lock_names: Set[str]) -> bool:
    return _self_attr(item.context_expr) in lock_names


class _MethodScan:
    def __init__(self, cls_name: str, method: ast.FunctionDef,
                 lock_attr: str, lock_names: Set[str], path: str,
                 findings: List[Finding]):
        self.cls_name = cls_name
        self.method = method
        self.lock_attr = lock_attr
        self.lock_names = lock_names  # the lock + its Condition aliases
        self.path = path
        self.findings = findings

    def run(self) -> None:
        held = self.method.name.endswith("_locked")
        for stmt in self.method.body:
            self._scan(stmt, held)

    # --- helpers ---------------------------------------------------------
    def _mutated_attrs(self, target) -> List[str]:
        """Private self attrs mutated by an assignment target."""
        if isinstance(target, (ast.Tuple, ast.List)):
            return [a for t in target.elts for a in self._mutated_attrs(t)]
        name = _self_attr(target)
        if name is None and isinstance(target, ast.Subscript):
            name = _self_attr(target.value)
        if name and name.startswith("_") and name not in self.lock_names:
            return [name]
        return []

    def _flag_mutation(self, node, attr: str) -> None:
        self.findings.append(Finding(
            path=self.path, line=node.lineno, rule=RULE_MUTATION,
            message=f"{self.cls_name}.{self.method.name} mutates "
                    f"self.{attr} outside `with self.{self.lock_attr}:`",
            hint=f"move the mutation under the lock, or rename the "
                 f"method `*_locked` if callers hold self.{self.lock_attr}",
        ))

    def _flag_blocking(self, node, what: str) -> None:
        self.findings.append(Finding(
            path=self.path, line=node.lineno, rule=RULE_BLOCKING,
            message=f"{self.cls_name}.{self.method.name} calls {what} "
                    f"while holding self.{self.lock_attr}",
            hint="stage the data under the lock, do the blocking call "
                 "after releasing it",
        ))

    def _check_call(self, node: ast.Call, held: bool) -> None:
        if not held:
            return
        name = dotted_name(node.func)
        if name in _BLOCKING_DOTTED or name in _BLOCKING_NAMES:
            self._flag_blocking(node, f"{name}()")
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _BLOCKING_METHODS):
            self._flag_blocking(node, f".{node.func.attr}()")

    def _mutator_call_attr(self, node: ast.Call) -> Optional[str]:
        """'x' for ``self._x.append(...)``-style mutator calls."""
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS):
            name = _self_attr(node.func.value)
            if (name and name.startswith("_")
                    and name not in self.lock_names):
                return name
        return None

    # --- the walk --------------------------------------------------------
    def _scan_expr(self, node, held: bool) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._check_call(sub, held)
                if not held:
                    attr = self._mutator_call_attr(sub)
                    if attr:
                        self._flag_mutation(sub, attr)

    def _scan(self, stmt, held: bool) -> None:
        if isinstance(stmt, ast.ClassDef):
            return  # a nested class's `self` is not this instance
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a closure runs later; the lock is not held then
            for inner in stmt.body:
                self._scan(inner, False)
            return
        if isinstance(stmt, ast.With):
            inner_held = held or any(
                _is_lock_with(it, self.lock_names) for it in stmt.items
            )
            for it in stmt.items:
                self._scan_expr(it.context_expr, held)
            for inner in stmt.body:
                self._scan(inner, inner_held)
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if not held:
                for tgt in targets:
                    for attr in self._mutated_attrs(tgt):
                        self._flag_mutation(stmt, attr)
            if stmt.value is not None:
                self._scan_expr(stmt.value, held)
            return
        if isinstance(stmt, ast.Delete) and not held:
            for tgt in stmt.targets:
                for attr in self._mutated_attrs(tgt):
                    self._flag_mutation(stmt, attr)
            return
        # compound statements: recurse into bodies, scan embedded exprs
        for field in ("body", "orelse", "finalbody"):
            for inner in getattr(stmt, field, []):
                self._scan(inner, held)
        for handler in getattr(stmt, "handlers", []):
            for inner in handler.body:
                self._scan(inner, held)
        for attr_name in ("test", "iter", "value", "exc"):
            sub = getattr(stmt, attr_name, None)
            if sub is not None and isinstance(sub, ast.AST):
                self._scan_expr(sub, held)


def check(tree: ast.AST, source: str, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if len(locks) != 1:
            continue  # no lock, or multi-lock: ownership is not inferable
        lock_attr = locks.pop()
        lock_names = {lock_attr} | _cv_aliases(cls, lock_attr)
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef):
                continue
            if method.name == "__init__":
                continue  # the object is not shared during construction
            _MethodScan(cls.name, method, lock_attr, lock_names, path,
                        findings).run()
    return findings
