"""dtype-flow: the narrow planes stay narrow at their boundaries (port of
``corrosion_tpu/analysis/dtypes.py``, with torch's promotion rules).

The small-range planes of the state (``mem_timer``, ``mem_tx``,
``q_cell``, ``q_seq``, ``q_nseq``, ``q_tx``, ``last_sync``) live as
int16 or int8 (``ScaleSimConfig.timer_dtype``/``tx_dtype``/``q_dtype``).
One silent upcast on a carry leaf doubles (or quadruples) that plane's
bytes, and the CUDA wrappers refuse the plane at run time, on the card
only (``ops/megakernel.py``'s dtype checks). torch makes the upcast easy
to write.

**dtype-widen** follows torch's promotion through the ``sim``/``ops``
modules (on the :mod:`dataflow` engine). A read of a narrow leaf seeds
its declared width; every operation that promotes asks the installed
torch what it gives (:func:`promote`: ``torch.result_type`` on one
representative operand of each kind), so the rule cannot drift from the
torch it runs on. The three kinds of operand are a tensor with dims, a
0-dim tensor and a Python scalar:

===============================================  =========  ===========
expression (``a16``: an int16 tensor with dims)  torch      jnp
===============================================  =========  ===========
``a16 + 1`` (Python scalar)                      int16      int16
``a16 + torch.tensor(1, dtype=int32)`` (0-dim)   int16      int32
``a16 + i32`` (an int32 tensor with dims)        int32      int32
``torch.where(m, a16, 0)``                       int16      int16
``torch.where(m, a16, i32)``                     int32      int32
``torch.clamp(a16, lo16, i32)``                  int32      int32
``torch.arange(n)``                              int64      int32
``torch.sum(a16)`` (0-dim)                       int64      int32
``a16 * 0 + torch.sum(a16)``                     int16      int32
``torch.sum(a16, dim=1, keepdim=True)``          int64      int32
``torch.cumsum(a16, 0)``                         int64      int16
``a16.amax(dim=1)``, ``torch.max(a16)``          int16      int16
===============================================  =========  ===========

So torch differs from jnp in three ways: a 0-dim tensor never widens a
tensor with dims of the same kind (integer, float), where jnp promotes
any concrete array; ``sum``/``prod``/``cumsum``/``cumprod`` of an integer
or bool tensor give int64 unless ``dtype=`` says otherwise (jnp: int32,
and ``cumsum`` keeps the width); ``arange`` and integer fills default to
int64 (jnp: int32). ``amax``/``amin``/``max``/``min`` keep the dtype in
both.

The rule fires only at the declared-narrow **boundaries**, as JAX's does:
a narrow keyword (``_replace(mem_timer=...)``, constructor keywords) or a
subscript store into a registered ref (``o_timer[:] = ...``) receiving a
provably wider integer. Compute in between may widen (the round computes
wide and casts back on the carry). A literal ``.to(torch.int16)``,
``.type(...)``, ``.short()`` or ``dtype=`` resets the dtype; a dynamic
``.to(x.dtype)`` evaluates to unknown and never flags; ``.to(device)``
keeps it. A tensor whose rank (dims or 0-dim) is not known promotes only
where both answers agree.
"""

from __future__ import annotations

import ast
import functools
from typing import Any, Dict, List, NamedTuple, Optional

from corrosion_tpu_torch.analysis.base import Finding, dotted_name
from corrosion_tpu_torch.analysis.callgraph import FunctionInfo, Project
from corrosion_tpu_torch.analysis.dataflow import Env, ForwardAnalysis, TupleVal
from corrosion_tpu_torch.analysis.shapes import _CAST_METHODS, _DTYPE_SIZES, canon_dtype

RULE = "dtype-widen"

#: declared-narrow state leaves -> bit width (seeded from
#: ``sim/scale_step.py``'s dtype properties and the kernel boundaries of
#: ``ops/megakernel.py``; the same seven leaves at the same widths as the
#: JAX package's registry). ``mem_tx`` is 8 (``narrow_int8``) and ``q_tx``/
#: ``q_seq``/``q_nseq`` are 8 (``narrow_q_int8``): their boundaries never
#: receive a concretely wider store, which is also why the int16 default
#: config needs no code of its own. A test runs one round under each knob
#: set and holds every name here to the carry's real width.
NARROW_LEAVES: Dict[str, int] = {
    "mem_timer": 16,
    "mem_tx": 8,
    "q_cell": 16,
    "q_seq": 8,
    "q_nseq": 8,
    "q_tx": 8,
    "last_sync": 16,
}

#: kernel out-ref spellings of the same planes: the swim kernel's
#: timer/budget outputs (``o_timer``/``o_tx``, read as ``m_timer``/
#: ``m_tx``) and the ingest kernel's narrowed queue planes
#: (``o_q_cell``/``o_q_tx``; the seq/nseq planes stay at their constant
#: 0/1 on the single-cell kernel path and are never stored again).
NARROW_REFS: Dict[str, int] = {
    "o_timer": 16, "o_tx": 8, "m_timer": 16, "m_tx": 8,
    "o_q_cell": 16, "o_q_tx": 8,
}
NARROW_REFS.update(NARROW_LEAVES)

_INTS = {"int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
         "uint64"}

#: operand kinds, in torch's order of precedence within one category
TENSOR, ZERODIM, SCALAR = "tensor", "zerodim", "scalar"


class Dtype(NamedTuple):
    #: a torch dtype name ("int16"), or for a Python scalar its type
    #: ("int", "float", "bool")
    name: str
    #: TENSOR (dims > 0), ZERODIM, SCALAR, or None (a tensor of unknown rank)
    kind: Optional[str] = TENSOR
    origin: Optional[str] = None  # narrow leaf this value derives from

    @property
    def bits(self) -> int:
        return 8 * _DTYPE_SIZES.get(self.name, 0)


def _literal_dtype(node: Optional[ast.AST]) -> Optional[str]:
    """``torch.int16`` / ``np.int32`` / ``"int16"`` -> ``"int16"``; dynamic
    expressions (``ref.dtype``) -> None (unknown, never flags)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return canon_dtype(node.value)
    if isinstance(node, ast.Name) and node.id == "bool":
        return "bool"
    dotted = dotted_name(node)
    if "." not in dotted or dotted.split(".", 1)[0] not in ("torch", "np",
                                                             "numpy"):
        return None
    return canon_dtype(dotted.rsplit(".", 1)[-1])


@functools.lru_cache(maxsize=None)
def _result_type(a: str, a_kind: str, b: str, b_kind: str) -> Optional[str]:
    """What torch gives for ``a op b``: ``torch.result_type`` of one
    representative operand of each kind (None where torch refuses)."""
    import torch

    def rep(name, kind):
        if kind == SCALAR:
            return {"bool": True, "int": 1, "float": 1.0}[name]
        return torch.empty((1,) if kind == TENSOR else (),
                           dtype=getattr(torch, name))

    try:
        out = torch.result_type(rep(a, a_kind), rep(b, b_kind))
    except (RuntimeError, TypeError):
        return None
    return str(out).removeprefix("torch.")


def _scalar_join(a: str, b: str) -> str:
    order = ("bool", "int", "float")
    return order[max(order.index(a), order.index(b))]


def _kind_join(kinds) -> Optional[str]:
    """The kind of an elementwise result: a tensor with dims if any
    operand has dims, else 0-dim if any is a tensor, else a scalar;
    unknown where an operand of unknown rank could decide it."""
    kinds = list(kinds)
    if TENSOR in kinds:
        return TENSOR
    if None in kinds:
        return None
    return ZERODIM if ZERODIM in kinds else SCALAR


def promote(a: Optional[Dtype], b: Optional[Dtype]) -> Optional[Dtype]:
    """torch's promotion of two operands; anything involving unknown is
    unknown, and an operand of unknown rank counts only where a tensor with
    dims and a 0-dim tensor would give the same."""
    if a is None or b is None:
        return None
    origin = a.origin or b.origin
    kind = _kind_join((a.kind, b.kind))
    if a.kind == SCALAR and b.kind == SCALAR:
        return Dtype(_scalar_join(a.name, b.name), SCALAR, origin)
    answers = set()
    for ak in ((TENSOR, ZERODIM) if a.kind is None else (a.kind,)):
        for bk in ((TENSOR, ZERODIM) if b.kind is None else (b.kind,)):
            answers.add(_result_type(a.name, ak, b.name, bk))
    if len(answers) != 1 or None in answers:
        return None
    return Dtype(answers.pop(), kind, origin)


def _promote_all(values) -> Optional[Dtype]:
    out = None
    for i, v in enumerate(values):
        out = v if i == 0 else promote(out, v)
    return out


#: calls that keep the first tensor argument's (or the receiver's) dtype
_PASS_FIRST = {
    "abs", "neg", "negative", "roll", "reshape", "view", "expand",
    "expand_as", "broadcast_to", "squeeze", "unsqueeze", "transpose",
    "permute", "flip", "flatten", "contiguous", "clone", "detach", "cpu",
    "cuda", "repeat", "masked_fill", "gather", "index_select",
    "take_along_dim", "scatter", "scatter_reduce", "scatter_add",
    "index_put", "index_add", "index_fill", "narrow", "select", "t",
    "diagonal",
}
#: calls that promote across their tensor operands (binops' rules)
_PROMOTING = {"minimum", "maximum", "add", "sub", "subtract", "mul",
              "multiply", "remainder", "fmod", "pow", "clamp", "clip",
              "floor_divide", "bitwise_and", "bitwise_or", "bitwise_xor",
              "bitwise_left_shift", "bitwise_right_shift"}
#: integer/bool reductions and scans that give int64 (``dtype=`` aside)
_INT64_REDUCTIONS = {"sum", "prod", "nansum", "cumsum", "cumprod"}
_SCANS = {"cumsum", "cumprod"}
_COMPARES = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and",
             "logical_or", "logical_xor", "logical_not", "isin"}
_CREATION = {"zeros", "ones", "empty", "full", "arange", "tensor",
             "as_tensor", "randint", "zeros_like", "ones_like", "empty_like",
             "full_like", "new_zeros", "new_ones", "new_empty", "new_full",
             "new_tensor"}


def _scalar_literal(node) -> Optional[str]:
    """``"int"``/``"float"``/``"bool"`` for a literal or an arithmetic
    expression of literals (``1 << 14``, ``-1``), else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (bool, int,
                                                                  float)):
        return type(node.value).__name__
    if isinstance(node, ast.UnaryOp):
        return _scalar_literal(node.operand)
    if isinstance(node, ast.BinOp):
        a, b = _scalar_literal(node.left), _scalar_literal(node.right)
        return _scalar_join(a, b) if a and b else None
    return None


def module_constants(project: Project) -> Dict[str, Dtype]:
    """Top-level ``NAME = <literal>`` constants of the walked modules, as
    Python scalars, by name (a name bound to scalars of two types in two
    modules is left out)."""
    found: Dict[str, set] = {}
    for mod in project.modules:
        for top in mod.tree.body:
            if isinstance(top, ast.Assign) and len(top.targets) == 1 and (
                    isinstance(top.targets[0], ast.Name)):
                kind = _scalar_literal(top.value)
                if kind is not None:
                    found.setdefault(top.targets[0].id, set()).add(kind)
    return {name: Dtype(kinds.pop(), SCALAR)
            for name, kinds in found.items() if len(kinds) == 1}


class _Analysis(ForwardAnalysis):
    def __init__(self, fn: FunctionInfo, findings: List[Finding],
                 constants: Optional[Dict[str, Dtype]] = None):
        super().__init__(fn, fn.path, findings)
        self.constants = constants or {}

    def initial_env(self) -> Env:
        # kernel refs and plane arguments arrive as parameters named
        # after their plane
        return {
            name: Dtype(f"int{NARROW_REFS[name]}", TENSOR, origin=name)
            for name in self.fn.param_names() if name in NARROW_REFS
        }

    def join(self, a, b):
        if isinstance(a, Dtype) and isinstance(b, Dtype):
            return a if a == b else None
        return super().join(a, b)

    def eval_constant(self, node, env):
        if isinstance(node.value, bool):
            return Dtype("bool", SCALAR)
        if isinstance(node.value, int):
            return Dtype("int", SCALAR)
        if isinstance(node.value, float):
            return Dtype("float", SCALAR)
        return None

    def eval_expr(self, node, env):
        if isinstance(node, ast.Name) and node.id not in env:
            return self.constants.get(node.id)
        if isinstance(node, ast.Compare):
            vals = [self.eval_expr(node.left, env)] + [
                self.eval_expr(c, env) for c in node.comparators]
            if any(isinstance(v, Dtype) and v.kind != SCALAR for v in vals):
                return Dtype("bool", _kind_join(
                    v.kind if isinstance(v, Dtype) else None for v in vals))
            return None
        return super().eval_expr(node, env)

    def eval_attr(self, node, base, env):
        if node.attr in NARROW_LEAVES:
            return Dtype(f"int{NARROW_LEAVES[node.attr]}", TENSOR,
                         origin=node.attr)
        if isinstance(base, Dtype) and node.attr in ("T", "mT", "real",
                                                     "data"):
            return base
        if isinstance(base, TupleVal) and len(base.elements) == 2 and (
                node.attr in ("values", "indices")):
            return base.elements[node.attr == "indices"]
        return None

    def eval_subscript(self, node, base, env):
        # indexing keeps the dtype; a slice keeps dims, other indexes may
        # drop them all
        if isinstance(base, Dtype):
            elts = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                    else [node.slice])
            kind = TENSOR if base.kind == TENSOR and any(
                isinstance(e, ast.Slice) for e in elts) else None
            return Dtype(base.name, kind, base.origin)
        return super().eval_subscript(node, base, env)

    def eval_binop(self, node, left, right, env):
        out = promote(self._as_dtype(left), self._as_dtype(right))
        if out is not None and isinstance(getattr(node, "op", None),
                                          ast.Div) and (
                out.name in _INTS or out.name in ("bool", "int")):
            # true division of integers gives the default float
            return Dtype("float32" if out.kind != SCALAR else "float",
                         out.kind, out.origin)
        return out

    @staticmethod
    def _as_dtype(v) -> Optional[Dtype]:
        return v if isinstance(v, Dtype) else None

    def _check_boundary(self, node: ast.AST, target: str,
                        value: Any) -> None:
        narrow_bits = NARROW_REFS.get(target)
        if narrow_bits is None or not isinstance(value, Dtype):
            return
        if value.kind != SCALAR and value.name in _INTS and (
                value.bits > narrow_bits):
            came_from = (f" (derives from narrow `{value.origin}`)"
                         if value.origin else "")
            self.findings.append(Finding(
                path=self.path, line=node.lineno, rule=RULE,
                message=f"declared-narrow `{target}` (int{narrow_bits}) "
                        f"receives a silently widened {value.name} "
                        f"value{came_from}: multiplies the plane's bytes and "
                        "fails the kernel wrappers' dtype check on the card",
                hint=f"cast back at the boundary: "
                     f".to(torch.int{narrow_bits}) or .to(<plane>.dtype)",
            ))

    def _cast(self, node: ast.Call, base) -> Optional[Dtype]:
        """``x.to(...)``/``x.type(...)``: a literal dtype resets, a device
        keeps the dtype, anything else is unknown."""
        kind = base.kind if isinstance(base, Dtype) else None
        origin = base.origin if isinstance(base, Dtype) else None
        kw = next((k.value for k in node.keywords if k.arg == "dtype"), None)
        arg = kw if kw is not None else (node.args[0] if node.args else None)
        if arg is None:
            return None
        target = _literal_dtype(arg)
        if target is not None:
            return Dtype(target, kind, origin)
        if kw is None and ((isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str))
                           or dotted_name(arg).rsplit(".", 1)[-1] in (
                               "device", "dev")
                           or (isinstance(arg, ast.Call) and dotted_name(
                               arg.func).endswith("device"))):
            return base if isinstance(base, Dtype) else None
        return None

    def _created(self, node: ast.Call, last: str, args, receiver):
        """A creation call's dtype: ``dtype=`` when it is a literal, else
        torch's default for the call."""
        kw = next((k.value for k in node.keywords if k.arg == "dtype"), None)
        data = node.args[0] if node.args else None
        kind = TENSOR
        if last in ("tensor", "as_tensor", "new_tensor"):
            kind = TENSOR if isinstance(data, (ast.List, ast.Tuple)) else (
                ZERODIM if isinstance(data, ast.Constant) else None)
        elif last.endswith("_like"):
            first = self._as_dtype(args[0]) if args else None
            kind = first.kind if first is not None else None
        elif isinstance(data, ast.Tuple) and not data.elts and (
                last in ("zeros", "ones", "empty", "full")):
            kind = ZERODIM
        if kw is not None:
            name = _literal_dtype(kw)
            return Dtype(name, kind) if name else None
        if last.endswith("_like") or last.startswith("new_"):
            src = self._as_dtype(args[0]) if last.endswith("_like") and args \
                else self._as_dtype(receiver)
            return Dtype(src.name, kind, src.origin) if src else None
        if last == "arange":
            floats = any(isinstance(a, ast.Constant)
                         and isinstance(a.value, float) for a in node.args)
            return Dtype("float32" if floats else "int64", TENSOR)
        fill = None
        if last == "full" and len(args) > 1:
            fill = self._as_dtype(args[1])
        elif last in ("tensor", "as_tensor"):
            fill = self._as_dtype(args[0]) if args else None
        if fill is not None and fill.kind == SCALAR:
            return Dtype({"bool": "bool", "int": "int64",
                          "float": "float32"}[fill.name], kind)
        if last in ("zeros", "ones", "empty"):
            return Dtype("float32", kind)
        return None

    def _reduction(self, node, last, first: Optional[Dtype], method: bool):
        if first is None:
            return None
        kw = next((k.value for k in node.keywords if k.arg == "dtype"), None)
        pos = 0 if method else 1
        has_dim = any(k.arg in ("dim", "axis") for k in node.keywords) or (
            len(node.args) > pos)
        keep = any(k.arg == "keepdim" and isinstance(k.value, ast.Constant)
                   and k.value.value is True for k in node.keywords)
        if last in _SCANS:
            kind = first.kind
        elif not has_dim:
            kind = ZERODIM
        else:
            kind = first.kind if keep else None
        if kw is not None:
            name = _literal_dtype(kw)
            return Dtype(name, kind, first.origin) if name else None
        name = first.name
        if last in _INT64_REDUCTIONS and (name in _INTS or name == "bool"):
            name = "int64"
        return Dtype(name, kind, first.origin)

    def eval_call(self, node, env, args, keywords):
        name = dotted_name(node.func)
        attr = isinstance(node.func, ast.Attribute)
        last = node.func.attr if attr else name
        method = attr and not name.startswith(("torch.", "np.", "numpy."))
        # narrow keyword boundary: _replace(mem_timer=...), ctor kwargs
        for kw in node.keywords:
            if kw.arg in NARROW_LEAVES:
                self._check_boundary(kw.value, kw.arg,
                                     keywords.get(kw.arg))
        receiver = self.eval_expr(node.func.value, env) if attr else None
        if method and last in ("to", "type"):
            return self._cast(node, receiver)
        if method and last in _CAST_METHODS and not node.args:
            base = self._as_dtype(receiver)
            return Dtype(_CAST_METHODS[last], base.kind if base else None,
                         base.origin if base else None)
        if last in _CREATION:
            return self._created(node, last, args, receiver)
        # the operands: the receiver of a tensor method comes first
        operands = ([receiver] if method else []) + list(args)
        first = self._as_dtype(operands[0]) if operands else None
        if last.endswith("_") and method:
            return self._as_dtype(receiver)  # in-place: the receiver's dtype
        if last in _INT64_REDUCTIONS:
            return self._reduction(node, last, first, method)
        if last in ("max", "min") and len(operands) > 1 and isinstance(
                operands[1], Dtype) and operands[1].kind != SCALAR:
            return promote(first, operands[1])  # torch.max(a, b): maximum
        if last in ("max", "min", "amax", "amin"):
            out = self._reduction(node, last, first, method)
            dim_given = any(k.arg == "dim" for k in node.keywords) or len(
                node.args) > (0 if method else 1)
            if out is not None and last in ("max", "min") and dim_given:
                return TupleVal((out, Dtype("int64", out.kind)))
            return out
        if last in ("argmax", "argmin", "count_nonzero"):
            return Dtype("int64", None) if first is not None else None
        if last in ("any", "all") or last in _COMPARES:
            return Dtype("bool", first.kind) if first is not None else None
        if last == "where" and len(operands) == 3:
            out = promote(self._as_dtype(operands[1]),
                          self._as_dtype(operands[2]))
            if out is None:
                return None
            cond = self._as_dtype(operands[0])
            kinds = (cond.kind if cond else None, out.kind)
            return Dtype(out.name, _kind_join(kinds), out.origin)
        if last in _PROMOTING and operands:
            bounds = [keywords.get(k) for k in ("min", "max") if k in keywords]
            return _promote_all([self._as_dtype(v) for v in operands + bounds])
        if last in _PASS_FIRST and first is not None:
            if last in ("unsqueeze", "expand", "repeat", "expand_as",
                        "broadcast_to"):
                return Dtype(first.name, TENSOR, first.origin)
            if last in ("squeeze", "select", "diagonal",
                        "reshape", "view", "flatten"):
                return Dtype(first.name, None, first.origin)
            return first
        return None

    def on_store_into(self, target, value, node, env):
        # kernel out-ref boundary: o_timer[:] = <wider int>
        if isinstance(target, ast.Subscript) and isinstance(
                target.value, ast.Name):
            self._check_boundary(node, target.value.id, value)


def in_scope(path: str) -> bool:
    """Scope on the absolute path, so the CLI (relative paths) and the
    tests (absolute paths) can never disagree about which files the rule
    covers. Paths that do not exist on disk are fixture sources: always
    in scope."""
    import os

    p = os.path.abspath(path)
    if not os.path.exists(p):
        return True  # fixture / bare source blob
    norm = p.replace("\\", "/")
    return "/sim/" in norm or "/ops/" in norm


def check_project(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    constants = module_constants(project)
    for fn in project.iter_functions():
        if not in_scope(fn.path):
            continue
        _Analysis(fn, findings, constants).analyze()
    return findings
