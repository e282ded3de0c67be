"""Forward dataflow over function bodies: the interprocedural checker
substrate (port of ``corrosion_tpu/analysis/dataflow.py``).

A checker subclasses :class:`ForwardAnalysis`, defines what its
abstract values are (a taint bit, an abstract dtype, anything
joinable), and gets for free the structural plumbing every pass was
otherwise going to reimplement:

- environments (variable -> abstract value) threaded through
  assignments in program order;
- tuple packing/unpacking (``(st, key), infos = f(...)`` distributes a
  :class:`TupleVal` across the target pattern — the pytree-ish shape
  all the sim carries use);
- branch joins: ``if``/``else`` evaluate from the same pre-state and
  merge by :meth:`join`, so a fact true on either path survives;
- loops: the body runs twice so loop-carried values reach their own
  uses (the carries here are small tuples — two passes reach the
  fixed point the checkers care about);
- ``with``/``try`` bodies in sequence, headers first.

Subclasses override the ``eval_*`` hooks to give calls/attributes/
operators meaning and the ``on_*`` hooks to flag sinks. Everything
unknown evaluates to ``None`` (bottom), which every hook must treat as
"no information" — the precision-over-recall contract: the engine never
guesses, so a checker built on it never flags what it cannot prove.

Nested ``def``/``lambda`` bodies are NOT walked (they run at call
time); :meth:`on_nested_def` lets a checker record them (a closure
that reads a variable its definer later changes).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional

from corrosion_tpu_torch.analysis.base import Finding
from corrosion_tpu_torch.analysis.callgraph import FunctionInfo


class TupleVal:
    """Abstract tuple: element values positionally, joinable."""

    __slots__ = ("elements",)

    def __init__(self, elements):
        self.elements = tuple(elements)

    def __eq__(self, other):
        return (isinstance(other, TupleVal)
                and self.elements == other.elements)

    def __hash__(self):
        return hash(self.elements)

    def __repr__(self):
        return f"TupleVal{self.elements}"


Env = Dict[str, Any]


class ForwardAnalysis:
    """One function body, walked forward with an abstract environment."""

    def __init__(self, fn: Optional[FunctionInfo], path: str,
                 findings: Optional[List[Finding]] = None):
        self.fn = fn
        self.path = path
        self.findings = findings if findings is not None else []
        #: join of every `return` expression's abstract value
        self.return_value: Any = None

    # -- overridable hooks -------------------------------------------------

    def join(self, a: Any, b: Any) -> Any:
        """Merge two abstract values (control-flow join). Default: keep
        the common value, drop to bottom on disagreement; tuples join
        element-wise."""
        if a == b:
            return a
        if isinstance(a, TupleVal) and isinstance(b, TupleVal) and (
                len(a.elements) == len(b.elements)):
            return TupleVal(
                self.join(x, y) for x, y in zip(a.elements, b.elements)
            )
        return None

    def initial_env(self) -> Env:
        """Starting environment (parameter values). Default: bottom."""
        return {}

    def eval_call(self, node: ast.Call, env: Env, args: List[Any],
                  keywords: Dict[str, Any]) -> Any:
        """Abstract value of a call, given the already-evaluated
        positional/keyword argument values (sink checks live here)."""
        return None

    def eval_attr(self, node: ast.Attribute, base: Any, env: Env) -> Any:
        """Abstract value of ``base.attr`` given base's value."""
        return None

    def eval_binop(self, node: ast.AST, left: Any, right: Any,
                   env: Env) -> Any:
        return None

    def eval_subscript(self, node: ast.Subscript, base: Any,
                       env: Env) -> Any:
        """Default: indexing an abstract tuple by a constant selects the
        element; anything else is bottom."""
        if isinstance(base, TupleVal) and isinstance(node.slice,
                                                     ast.Constant):
            idx = node.slice.value
            if isinstance(idx, int) and -len(base.elements) <= idx < len(
                    base.elements):
                return base.elements[idx]
        return None

    def eval_constant(self, node: ast.Constant, env: Env) -> Any:
        return None

    def on_store(self, name: str, value: Any, node: ast.AST,
                 env: Env) -> None:
        """A variable was (re)bound. Sink hook for store-side checks."""

    def on_nested_def(self, node: ast.AST, env: Env) -> None:
        """A nested def/lambda was encountered (its body is NOT walked)."""

    # -- expression evaluation ---------------------------------------------

    def eval_expr(self, node: Optional[ast.AST], env: Env) -> Any:
        if node is None:
            return None
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, (ast.Tuple, ast.List)):
            return TupleVal(self.eval_expr(e, env) for e in node.elts)
        if isinstance(node, ast.Constant):
            return self.eval_constant(node, env)
        if isinstance(node, ast.Call):
            args = [self.eval_expr(arg, env) for arg in node.args]
            keywords = {
                kw.arg: self.eval_expr(kw.value, env)
                for kw in node.keywords if kw.arg is not None
            }
            for kw in node.keywords:
                if kw.arg is None:  # **kwargs
                    self.eval_expr(kw.value, env)
            return self.eval_call(node, env, args, keywords)
        if isinstance(node, ast.Attribute):
            return self.eval_attr(node, self.eval_expr(node.value, env),
                                  env)
        if isinstance(node, ast.Subscript):
            base = self.eval_expr(node.value, env)
            self.eval_expr(node.slice, env)
            return self.eval_subscript(node, base, env)
        if isinstance(node, ast.BinOp):
            return self.eval_binop(
                node, self.eval_expr(node.left, env),
                self.eval_expr(node.right, env), env)
        if isinstance(node, ast.UnaryOp):
            return self.eval_expr(node.operand, env)
        if isinstance(node, ast.BoolOp):
            vals = [self.eval_expr(v, env) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = self.join(out, v)
            return out
        if isinstance(node, ast.IfExp):
            self.eval_expr(node.test, env)
            return self.join(self.eval_expr(node.body, env),
                             self.eval_expr(node.orelse, env))
        if isinstance(node, ast.Compare):
            self.eval_expr(node.left, env)
            for comp in node.comparators:
                self.eval_expr(comp, env)
            return None
        if isinstance(node, ast.Starred):
            return self.eval_expr(node.value, env)
        if isinstance(node, (ast.Lambda,)):
            self.on_nested_def(node, env)
            return None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            # comprehension bodies see their own scope; evaluate the
            # iterables (data flows in through them) and stop there
            for gen in node.generators:
                self.eval_expr(gen.iter, env)
            return None
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                self.eval_expr(v, env)
            return None
        if isinstance(node, ast.FormattedValue):
            return self.eval_expr(node.value, env)
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                self.eval_expr(k, env)
                self.eval_expr(v, env)
            return None
        if isinstance(node, (ast.Slice,)):
            for part in (node.lower, node.upper, node.step):
                self.eval_expr(part, env)
            return None
        return None

    # -- statement walk ----------------------------------------------------

    def _bind(self, target: ast.AST, value: Any, env: Env,
              node: ast.AST) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = value
            self.on_store(target.id, value, node, env)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            if (isinstance(value, TupleVal)
                    and len(value.elements) == len(elts)
                    and not any(isinstance(e, ast.Starred) for e in elts)):
                for elt, v in zip(elts, value.elements):
                    self._bind(elt, v, env, node)
            else:
                # unknown/starred unpack: each element inherits the
                # JOIN of the whole value's facts (taint still flows
                # through `st, *rest = ...` — conservatively smeared)
                if isinstance(value, TupleVal):
                    spread = None
                    for el in value.elements:
                        spread = self.join(spread, el) if (
                            spread is not None) else el
                else:
                    spread = value
                for elt in elts:
                    self._bind(
                        elt.value if isinstance(elt, ast.Starred) else elt,
                        spread, env, node)
            return
        if isinstance(target, (ast.Attribute, ast.Subscript)):
            # a store through an attribute/subscript: evaluate the
            # receiver (sinks may fire) but bind nothing
            self.eval_expr(target.value, env)
            self.on_store_into(target, value, node, env)

    def on_store_into(self, target: ast.AST, value: Any, node: ast.AST,
                      env: Env) -> None:
        """``x.attr = v`` / ``x[i] = v`` — sink hook for ref stores."""

    def _join_envs(self, a: Env, b: Env) -> Env:
        out: Env = {}
        for k in set(a) | set(b):
            out[k] = self.join(a.get(k), b.get(k))
        return out

    def run(self, body: List[ast.stmt], env: Optional[Env] = None) -> Env:
        if env is None:
            env = self.initial_env()
        for stmt in body:
            env = self._stmt(stmt, env)
        return env

    def _stmt(self, stmt: ast.stmt, env: Env) -> Env:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.on_nested_def(stmt, env)
            env[stmt.name] = None
            return env
        if isinstance(stmt, ast.ClassDef):
            return env
        if isinstance(stmt, ast.Assign):
            value = self.eval_expr(stmt.value, env)
            for target in stmt.targets:
                self._bind(target, value, env, stmt)
            return env
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.eval_expr(stmt.value, env),
                           env, stmt)
            return env
        if isinstance(stmt, ast.AugAssign):
            cur = self.eval_expr(stmt.target, env) if isinstance(
                stmt.target, ast.Name) else None
            value = self.eval_binop(
                stmt, cur, self.eval_expr(stmt.value, env), env)
            self._bind(stmt.target, value, env, stmt)
            return env
        if isinstance(stmt, ast.Return):
            val = self.eval_expr(stmt.value, env)
            self.return_value = (val if self.return_value is None
                                 else self.join(self.return_value, val))
            return env
        if isinstance(stmt, (ast.Expr, ast.Assert)):
            self.eval_expr(getattr(stmt, "value", None)
                           or getattr(stmt, "test", None), env)
            return env
        if isinstance(stmt, ast.If):
            self.eval_expr(stmt.test, env)
            then_env = self.run(stmt.body, dict(env))
            else_env = self.run(stmt.orelse, dict(env))
            return self._join_envs(then_env, else_env)
        if isinstance(stmt, (ast.While,)):
            self.eval_expr(stmt.test, env)
            once = self.run(stmt.body, dict(env))
            joined = self._join_envs(env, once)
            twice = self.run(stmt.body, dict(joined))
            return self._join_envs(joined, twice)
        if isinstance(stmt, ast.For):
            self.eval_expr(stmt.iter, env)
            loop_env = dict(env)
            self._bind(stmt.target, None, loop_env, stmt)
            once = self.run(stmt.body, loop_env)
            joined = self._join_envs(env, once)
            self._bind(stmt.target, None, joined, stmt)
            twice = self.run(stmt.body, dict(joined))
            out = self._join_envs(joined, twice)
            return self.run(stmt.orelse, out)
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                ctx = self.eval_expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, ctx, env, stmt)
            return self.run(stmt.body, env)
        if isinstance(stmt, ast.Try):
            env = self.run(stmt.body, env)
            for handler in stmt.handlers:
                env = self._join_envs(env, self.run(handler.body,
                                                    dict(env)))
            env = self.run(stmt.orelse, env)
            return self.run(stmt.finalbody, env)
        if isinstance(stmt, (ast.Raise,)):
            self.eval_expr(stmt.exc, env)
            return env
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                if isinstance(target, ast.Name):
                    env.pop(target.id, None)
            return env
        return env

    # -- entry point -------------------------------------------------------

    def analyze(self) -> Any:
        """Walk self.fn's body; returns the joined return value (for
        summary passes)."""
        if self.fn is None:
            raise ValueError("analyze() needs a FunctionInfo")
        self.run(list(self.fn.node.body))
        return self.return_value
