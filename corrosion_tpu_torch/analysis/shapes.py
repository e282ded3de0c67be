"""corrobudget for the port: the state's symbolic shape inventory, two
ways, and the ``densify`` rule (port of ``corrosion_tpu/analysis/shapes.py``).

**From the ``meta`` device** (:func:`static_inventory`, the gate of
record). The port builds the state on ``meta``, where a tensor has a shape
and a dtype and no storage, so a 1M-node state costs nothing. Which config
extent each dim follows is found by rebinding one config field at a time
and building again:

- the extents are JAX's symbols (:data:`SYMBOLS`: ``N`` = ``n_nodes``,
  ``M``, ``Q``, ``O``, ``B``, ``P``, ``K``, and ``C`` = ``n_cells``, which
  ``n_rows`` and ``n_cols`` rebind);
- a dim is attributed to the first expression of :data:`DIM_EXPRESSIONS`
  that gives its size in the base build and in every rebound build, else
  to its constant size where only one rebound extent other than ``N`` and
  ``M`` moved it (that extent flips a branch of the constructor, such as
  the partial buffer's slot count at ``K == 1``, and the dim does not
  follow it on this side of the branch);
- every other integer field of the config is rebound too, and a dim that
  moves with one of them has no expression: its leaf goes into
  ``unresolved`` and is never priced. So does a leaf whose dtype or
  presence changes with ``N`` or ``M``.

The expressions render as JAX's interpreter renders the same source, so
the two inventories agree string for string. :data:`HBM_BUDGET` is JAX's
declared 1M budget and :func:`check_budget` its gate (a test, not a lint
rule).

**From the source** (:func:`build_inventory`, :func:`interpreted_inventory`).
:class:`ShapeAnalysis`, on the :mod:`dataflow` engine, interprets the
state constructors' ASTs with every dim a polynomial (:class:`Poly`) in
the extents, over the port's torch idioms: sizes as varargs or a tuple,
``dtype=``/``device=``, ``*_like`` and ``new_*``, ``arange`` (int64 unless
``dtype=``), reductions with ``dim=``/``keepdim=``, ``[:, None]``,
``unsqueeze``, ``expand``, ``repeat``, gathers (``t[idx]``, ``gather``,
``index_select``, ``take_along_dim``), in-place stores (``t[...] = v``,
``index_put_``, ``scatter_``, ``scatter_reduce_``, ``copy_``: the base
keeps its shape), ``.to``, ``view``/``reshape``, ``stack``/``cat``, nested
``def z(*s)`` factories and the dense helpers of ``ops/dense.py`` and
``ops/select.py`` (:data:`_HELPER_SHAPES`). A test holds its inventory
equal to the ``meta`` one and to JAX's, leaf for leaf.

**densify** (:func:`check_densify`): an intermediate whose N-degree is at
least 2 and above every input's (the N x N pairwise broadcast) in
``sim/`` and ``ops/``, outside the full view's ``sim/step.py`` and
``sim/swim.py``. An operand whose shape is not proven grows no finding.
The analysis imports no torch: it reads ASTs.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

from corrosion_tpu_torch.analysis.base import Finding, dotted_name
from corrosion_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    ModuleInfo,
    Project,
    module_name_for,
)
from corrosion_tpu_torch.analysis.dataflow import Env, ForwardAnalysis, TupleVal
from corrosion_tpu_torch.obs.memory import (
    STORED_DTYPES,
    _walk_leaves,
    classify_leaf,
    leaf_dtype_name,
)

DENSIFY_RULE = "densify"

#: config attr -> shape symbol (the polynomial variables)
SYMBOLS: Dict[str, str] = {
    "n_nodes": "N",
    "m_slots": "M",
    "bcast_queue": "Q",
    "n_origins": "O",
    "buf_slots": "B",
    "partial_slots": "P",
    "tx_max_cells": "K",
}
#: derived properties that get their own symbol, and the fields that move them
PROPERTY_SYMBOLS: Dict[str, str] = {"n_cells": "C"}
_PROPERTY_FIELDS: Dict[str, str] = {"n_rows": "n_cells", "n_cols": "n_cells"}

#: The declared 1M budget: per-complexity-class bytes of one replica of the
#: scale state at N=1M, M=64 under the flagship dtype set (copied from the
#: JAX package; the headroom is smaller than one int32 [N, M] plane, so a
#: new full-width table fails :func:`check_budget` until it is re-priced).
HBM_BUDGET: Dict[str, Any] = {
    "root": "ScaleSimState",
    "point": {"N": 1_000_000, "M": 64},
    "per_class_bytes": {
        "O(N*M)": 3_700_000_000,
        "O(N)": 64_000_000,
        "O(1)": 1_000_000,
    },
}

# --- symbolic integers ----------------------------------------------------


class Poly:
    """Integer polynomial over the config extents: ``{monomial: coeff}``
    with each monomial a sorted tuple of symbol names (with repetition,
    so N·M is ``("M", "N")`` and N² is ``("N", "N")``)."""

    __slots__ = ("terms",)

    def __init__(self, terms: Dict[Tuple[str, ...], int]):
        self.terms = {m: c for m, c in terms.items() if c}

    @staticmethod
    def const(c: int) -> "Poly":
        return Poly({(): int(c)})

    @staticmethod
    def var(name: str) -> "Poly":
        return Poly({(name,): 1})

    def __add__(self, other):
        if isinstance(other, int):
            other = Poly.const(other)
        if not isinstance(other, Poly):
            return SymOp("add", (self, other))
        out = dict(self.terms)
        for m, c in other.terms.items():
            out[m] = out.get(m, 0) + c
        return Poly(out)

    def __neg__(self):
        return Poly({m: -c for m, c in self.terms.items()})

    def __sub__(self, other):
        if isinstance(other, int):
            other = Poly.const(other)
        if not isinstance(other, Poly):
            return SymOp("sub", (self, other))
        return self + (-other)

    def __mul__(self, other):
        if isinstance(other, int):
            other = Poly.const(other)
        if not isinstance(other, Poly):
            return SymOp("mul", (self, other))
        out: Dict[Tuple[str, ...], int] = {}
        for ma, ca in self.terms.items():
            for mb, cb in other.terms.items():
                mono = tuple(sorted(ma + mb))
                out[mono] = out.get(mono, 0) + ca * cb
        return Poly(out)

    def evaluate(self, env: Dict[str, int]) -> int:
        total = 0
        for mono, c in self.terms.items():
            v = c
            for s in mono:
                v *= env[s]  # KeyError = missing binding, caller handles
            total += v
        return total

    def degree(self, name: str) -> int:
        return max((m.count(name) for m in self.terms), default=0)

    def is_const(self) -> bool:
        return all(m == () for m in self.terms)

    def render(self) -> str:
        if not self.terms:
            return "0"
        parts = []
        for mono, c in sorted(self.terms.items(),
                              key=lambda kv: (-len(kv[0]), kv[0])):
            body = "*".join(mono)
            if not mono:
                parts.append(str(c))
            elif c == 1:
                parts.append(body)
            else:
                parts.append(f"{c}*{body}")
        return " + ".join(parts)

    def __eq__(self, other):
        return isinstance(other, Poly) and self.terms == other.terms

    def __hash__(self):
        return hash(frozenset(self.terms.items()))

    def __repr__(self):
        return f"Poly({self.render()})"


_OP_EVAL = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "floordiv": lambda a, b: a // b,
    "mod": lambda a, b: a % b,
    "max": max,
    "min": min,
    "neg": lambda a: -a,
}


class SymOp:
    """Opaque symbolic integer (``max``/``min``/``//``/``%``/mixed
    arithmetic): still evaluable and degree-bounded, just not a
    polynomial normal form."""

    __slots__ = ("op", "args")

    def __init__(self, op: str, args):
        self.op = op
        self.args = tuple(
            Poly.const(a) if isinstance(a, int) else a for a in args
        )

    def evaluate(self, env: Dict[str, int]) -> int:
        return _OP_EVAL[self.op](*(a.evaluate(env) for a in self.args))

    def degree(self, name: str) -> int:
        degs = [a.degree(name) for a in self.args]
        if self.op in ("floordiv", "mod"):
            # //k keeps the numerator's growth; %k is bounded by the
            # divisor, which carries its own degree
            return degs[0] if self.op == "floordiv" else (
                self.args[1].degree(name))
        return max(degs, default=0)

    def render(self) -> str:
        inner = ", ".join(sym_render(a) for a in self.args)
        if self.op in ("max", "min"):
            return f"{self.op}({inner})"
        if self.op == "neg":
            return f"-({sym_render(self.args[0])})"
        sign = {"add": "+", "sub": "-", "mul": "*", "floordiv": "//",
                "mod": "%"}[self.op]
        return f"({sym_render(self.args[0])} {sign} "\
               f"{sym_render(self.args[1])})"

    def __eq__(self, other):
        return (isinstance(other, SymOp) and self.op == other.op
                and self.args == other.args)

    def __hash__(self):
        return hash((self.op, self.args))

    def __repr__(self):
        return f"SymOp({self.render()})"


def is_sym(v) -> bool:
    return isinstance(v, (Poly, SymOp))


def sym_render(v) -> str:
    return v.render() if hasattr(v, "render") else str(v)


def sym_eval(v, env: Dict[str, int]) -> Optional[int]:
    try:
        return int(v.evaluate(env))
    except KeyError:
        return None


def sym_binop(op: str, a, b):
    if isinstance(a, int):
        a = Poly.const(a)
    if isinstance(b, int):
        b = Poly.const(b)
    if not (is_sym(a) and is_sym(b)):
        return None
    if isinstance(a, Poly) and isinstance(b, Poly):
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "mul":
            return a * b
    if op in _OP_EVAL:
        return SymOp(op, (a, b))
    return None


@dataclasses.dataclass(frozen=True)
class Dim:
    """One dim of the ``meta`` inventory: its rendering, its value at a
    binding, and the symbols it grows with (constants grow with none)."""

    text: str
    value: Callable[[Dict[str, int]], int]
    symbols: Tuple[str, ...] = ()

    def evaluate(self, env: Dict[str, int]) -> int:
        return int(self.value(env))

    def degree(self, sym: str) -> int:
        return int(sym in self.symbols)

    def render(self) -> str:
        return self.text


def _sym(s: str) -> Dim:
    return Dim(s, lambda env: env[s], (s,))


def _const(c: int) -> Dim:
    return Dim(str(c), lambda env: c)


#: the dim expressions the state constructors use, as JAX renders them
#: (``max(1, K)`` and the seen window's word count ``max(1, -(-B // 32))``
#: are written so in the source; both are >= 1 on every valid config)
DIM_EXPRESSIONS: Tuple[Dim, ...] = tuple(_sym(s) for s in ("N", "M", "C", "Q", "O", "B", "P")) + (
    Dim("max(1, K)", lambda env: max(1, env["K"]), ("K",)),
    Dim("max(1, -((-1*B // 32)))", lambda env: max(1, -((-env["B"]) // 32)), ("B",)),
)


@dataclasses.dataclass
class LeafShape:
    """One state leaf: its dims (``Dim`` from the ``meta`` build, ``Poly``
    or ``SymOp`` from the interpreter; None = unresolved), its dtype and,
    from the interpreter, its creation site."""

    name: str
    dims: Optional[Tuple]
    dtype: Optional[str]
    path: str = ""
    line: int = 0

    def shape_str(self) -> str:
        if self.dims is None:
            return "?"
        return "[" + ", ".join(sym_render(d) for d in self.dims) + "]"

    def shape_at(self, bindings: Dict[str, int]) -> Optional[Tuple[int, ...]]:
        if self.dims is None:
            return None
        out = tuple(sym_eval(d, bindings) for d in self.dims)
        return None if None in out else out

    def nbytes(self, bindings: Dict[str, int]) -> Optional[int]:
        shape = self.shape_at(bindings)
        if shape is None or self.dtype not in _DTYPE_SIZES:
            return None
        return _DTYPE_SIZES[self.dtype] * math.prod(shape)


_DTYPE_SIZES = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
    "bfloat16": 2, "float16": 2, "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8,
}


@dataclasses.dataclass
class Inventory:
    root: str
    leaves: Dict[str, LeafShape]
    bindings: Dict[str, int]
    flags: Dict[str, bool] = dataclasses.field(default_factory=dict)

    def report(self, overrides: Optional[Dict[str, int]] = None) -> dict:
        """The projection in the runtime audit's schema
        (``obs.memory.memory_report``) plus each leaf's ``symbolic`` shape,
        at the config's extents with ``overrides`` rebound (``{"N":
        1_000_000}``)."""
        bindings = dict(self.bindings)
        bindings.update(overrides or {})
        n_nodes = bindings.get("N")
        tables: Dict[str, dict] = {}
        by_class: Dict[str, int] = {}
        total = 0
        unresolved = []
        for name, leaf in self.leaves.items():
            shape = leaf.shape_at(bindings)
            nbytes = leaf.nbytes(bindings)
            if shape is None or nbytes is None:
                unresolved.append(name)
                continue
            cls = classify_leaf(shape, n_nodes)
            entry = {
                "shape": list(shape),
                "dtype": leaf.dtype,
                "nbytes": nbytes,
                "class": cls,
                "symbolic": leaf.shape_str(),
            }
            if cls != "O(1)" and n_nodes:
                entry["per_node_bytes"] = nbytes // n_nodes
            tables[name] = entry
            by_class[cls] = by_class.get(cls, 0) + nbytes
            total += nbytes
        return {
            "total_bytes": total,
            "n_nodes": n_nodes,
            "tables": tables,
            "by_class": by_class,
            "unresolved": unresolved,
            "source": "static",
            "root": self.root,
        }


def _build_scale(cfg):
    from corrosion_tpu_torch.sim.scale_step import ScaleSimState

    return ScaleSimState.create(cfg, "meta")


def _build_full(cfg):
    from corrosion_tpu_torch.sim.step import SimState

    return SimState.create(cfg, device="meta")


#: mode -> (state root class name, its meta-device constructor)
ROOTS: Dict[str, Tuple[str, Callable]] = {
    "scale": ("ScaleSimState", _build_scale),
    "full": ("SimState", _build_full),
}


def _config_bindings(cfg) -> Dict[str, int]:
    """The symbols' values on a live config."""
    env = {sym: int(getattr(cfg, f)) for f, sym in SYMBOLS.items() if hasattr(cfg, f)}
    for prop, sym in PROPERTY_SYMBOLS.items():
        if hasattr(cfg, prop):
            env[sym] = int(getattr(cfg, prop))
    return env


def _meta_leaves(build, cfg) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    leaves: dict = {}
    _walk_leaves(build(cfg), "", leaves)
    return {name: (tuple(int(s) for s in t.shape), leaf_dtype_name(t, name))
            for name, t in leaves.items()}


def _probes(cfg, build) -> List[Tuple[Optional[str], Dict[str, int], dict]]:
    """``(symbol or None, bindings, leaves)`` for every integer field of
    ``cfg`` rebound alone to the first nearby value the config accepts."""
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, bool) or not isinstance(v, int):
            continue
        sym = SYMBOLS.get(f.name) or PROPERTY_SYMBOLS.get(_PROPERTY_FIELDS.get(f.name, ""))
        for pv in (v + 1, v + 2, 2 * v, v - 1):
            try:
                c2 = dataclasses.replace(cfg, **{f.name: pv})
                c2 = c2.validate() if hasattr(c2, "validate") else c2
                leaves = _meta_leaves(build, c2)
            except (ValueError, RuntimeError):
                continue
            out.append((sym, _config_bindings(c2), leaves))
            break
    return out


def _attribute(name: str, base_shape, dtype, env, probes) -> Optional[Tuple[Dim, ...]]:
    """The symbolic dims of one leaf, or None when it cannot be attributed."""
    seen = []  # (symbol or None, bindings, shape) of the probes that built it
    for sym, penv, pleaves in probes:
        got = pleaves.get(name)
        if sym in ("N", "M") and (got is None or got[1] != dtype):
            return None  # the leaf's presence or dtype moves with N or M
        if got is not None and len(got[0]) == len(base_shape):
            seen.append((sym, penv, got[0]))
        elif sym is None or sym in ("N", "M"):
            return None
    dims = []
    for i, size in enumerate(base_shape):
        def fits(d: Dim) -> bool:
            if not set(d.symbols) <= set(env) or d.evaluate(env) != size:
                return False
            return all(d.evaluate(penv) == shape[i] for _sym, penv, shape in seen)

        moved = {sym for sym, _penv, shape in seen if shape[i] != size}
        pick = next((d for d in DIM_EXPRESSIONS if fits(d)), None)
        if pick is None and (not moved or (len(moved) == 1
                                           and moved.isdisjoint((None, "N", "M")))):
            pick = _const(size)  # constant, or across one extent's branch
        if pick is None:
            return None
        dims.append(pick)
    return tuple(dims)


def static_inventory(cfg=None, mode: str = "scale") -> Inventory:
    """The symbolic inventory of ``cfg``'s state (the flagship
    ``scale_sim_config(100_000)`` when omitted): ``mem-report --project``'s
    backend and :func:`check_budget`'s input. Builds on ``meta`` only."""
    if cfg is None:
        from corrosion_tpu_torch.sim.scale_step import scale_sim_config

        cfg = scale_sim_config(100_000)
    if mode not in ROOTS:
        raise ValueError(f"unknown mode {mode!r}; want one of {sorted(ROOTS)}")
    root, build = ROOTS[mode]
    base = _meta_leaves(build, cfg)
    env = _config_bindings(cfg)
    probes = _probes(cfg, build)
    leaves = {}
    for name, (shape, dtype) in base.items():
        dims = _attribute(name, shape, dtype, env, probes)
        leaves[name] = LeafShape(name, dims, dtype if dims is not None else None)
    return Inventory(root, leaves, env)


def check_budget(inv: Optional[Inventory] = None) -> List[str]:
    """The gate of record: the scale state (the flagship's inventory unless
    ``inv`` is given) priced at :data:`HBM_BUDGET`'s point must fit each
    class's budget, with every leaf resolved and no class undeclared.
    Returns the problems, one line each (empty: the gate passes)."""
    inv = inv if inv is not None else static_inventory(mode="scale")
    point = dict(HBM_BUDGET["point"])
    report = inv.report(point)
    problems = [f"state leaf `{n}` of {inv.root} has no resolvable shape: the "
                "1M budget cannot price it" for n in report["unresolved"]]
    budgets = HBM_BUDGET["per_class_bytes"]
    for cls, budget in budgets.items():
        used = report["by_class"].get(cls, 0)
        if used > budget:
            worst = sorted(((e["nbytes"], n) for n, e in report["tables"].items()
                            if e["class"] == cls), reverse=True)[:3]
            top = ", ".join(f"{n}={b / 1e6:.0f}MB" for b, n in worst)
            problems.append(f"{cls} state footprint at N={point['N']:,} is "
                            f"{used / 1e9:.3f} GB, over the declared "
                            f"{budget / 1e9:.3f} GB budget (worst: {top})")
    for cls in sorted(set(report["by_class"]) - set(budgets)):
        problems.append(f"complexity class {cls} has no declared budget (used "
                        f"{report['by_class'][cls] / 1e9:.3f} GB at the 1M point)")
    return problems


# --- abstract values ------------------------------------------------------

#: torch's (and numpy's) dtype spellings -> the canonical dtype name
_DTYPE_ALIASES = {
    "bool_": "bool", "long": "int64", "int": "int32", "short": "int16",
    "float": "float32", "double": "float64", "half": "float16",
}
#: dotted heads that denote a concrete dtype (``torch.int16``, ``np.int32``)
_DTYPE_BASES = ("torch", "np", "numpy")
#: cast methods -> the dtype they give (``x.long()``)
_CAST_METHODS = {
    "long": "int64", "int": "int32", "short": "int16", "char": "int8",
    "byte": "uint8", "bool": "bool", "float": "float32", "double": "float64",
    "half": "float16", "bfloat16": "bfloat16",
}


def canon_dtype(name: str) -> Optional[str]:
    """``"int16"``, ``"long"``, ``"bool_"`` -> the canonical name, or None."""
    name = _DTYPE_ALIASES.get(name, name)
    return name if name in _DTYPE_SIZES else None


class DtypeVal:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = canon_dtype(name) or name

    def __eq__(self, other):
        return isinstance(other, DtypeVal) and self.name == other.name

    def __hash__(self):
        return hash(("dtype", self.name))

    def __repr__(self):
        return f"DtypeVal({self.name})"


class BoolVal:
    __slots__ = ("value",)

    def __init__(self, value: bool):
        self.value = bool(value)

    def __eq__(self, other):
        return isinstance(other, BoolVal) and self.value == other.value

    def __hash__(self):
        return hash(("bool", self.value))

    def __repr__(self):
        return f"BoolVal({self.value})"


class ArrayVal:
    """Abstract tensor: symbolic dims + dtype + creation site. A dim may be
    ``None`` (unknown): such tensors grow no budget or densify facts."""

    __slots__ = ("dims", "dtype", "site")

    def __init__(self, dims, dtype: Optional[str],
                 site: Optional[Tuple[str, int]] = None):
        self.dims = tuple(dims)
        self.dtype = dtype
        self.site = site

    def known(self) -> bool:
        return all(d is not None for d in self.dims)

    def key(self):
        return (tuple(sym_render(d) if d is not None else "?"
                      for d in self.dims), self.dtype)

    def __eq__(self, other):
        return isinstance(other, ArrayVal) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        dims = ", ".join(sym_render(d) if d is not None else "?"
                         for d in self.dims)
        return f"ArrayVal([{dims}], {self.dtype})"


class StructVal:
    """Abstract NamedTuple state: field name -> abstract value, ordered by
    the class definition (so flattening matches the runtime walk)."""

    __slots__ = ("cls_name", "field_order", "fields")

    def __init__(self, cls_name: str, field_order, fields: Dict[str, Any]):
        self.cls_name = cls_name
        self.field_order = tuple(field_order)
        self.fields = fields

    def replace(self, updates: Dict[str, Any]) -> "StructVal":
        out = dict(self.fields)
        out.update(updates)
        return StructVal(self.cls_name, self.field_order, out)

    def __eq__(self, other):
        return (isinstance(other, StructVal)
                and self.cls_name == other.cls_name
                and self.fields == other.fields)

    def __hash__(self):
        return hash(self.cls_name)

    def __repr__(self):
        return f"StructVal({self.cls_name})"


class LambdaVal:
    """A local ``lambda`` or nested ``def`` with its definition-time
    environment: the ``def z(*s): return torch.zeros(s, ...)`` constructor
    idiom."""

    __slots__ = ("node", "env")

    def __init__(self, node, env: Env):
        self.node = node
        self.env = dict(env)


class NoneVal:
    """The value ``None``: a parameter's ``None`` default or the literal,
    so ``x if rows is None else rows`` picks its arm on the default path."""

    __slots__ = ()

    def __repr__(self):
        return "NoneVal"


NONE = NoneVal()
#: abstract values that are never ``None``
_NOT_NONE = (Poly, SymOp, BoolVal, DtypeVal, ArrayVal, StructVal, TupleVal)


class ClassRef:
    __slots__ = ("info",)

    def __init__(self, info: "ClassInfo"):
        self.info = info


class FnRef:
    __slots__ = ("fn",)

    def __init__(self, fn: FunctionInfo):
        self.fn = fn


# --- config abstraction ---------------------------------------------------

#: the lint gate's template extents: the flagship scale config
#: (``scale_sim_config(100_000)``; a test pins these and the flags below
#: against the port's real dataclass)
DEFAULT_EXTENTS: Dict[str, int] = {
    "N": 100_000, "M": 64, "Q": 32, "O": 16, "B": 32, "P": 8, "K": 1,
    "C": 64,
}
#: flagship structure flags
DEFAULT_FLAGS: Dict[str, bool] = {
    "narrow_dtypes": True,
    "narrow_int8": False,
    "narrow_q_int8": False,
    "any_writer": True,
}


class ConfigVal:
    """Abstract sim config: extent attrs evaluate to their polynomial
    symbols (with a concrete binding for branch decisions and pricing),
    bool fields to concrete :class:`BoolVal`, the dtype properties to the
    dtype the real property picks (``ScaleSimConfig.timer_dtype``,
    ``tx_dtype``, ``q_dtype``: the ``narrow_*`` flags decide)."""

    __slots__ = ("bindings", "flags", "extras", "sync_tracks_sym")

    def __init__(self, bindings: Dict[str, int], flags: Dict[str, bool],
                 extras: Optional[Dict[str, int]] = None,
                 sync_tracks_sym: str = "M"):
        self.bindings = dict(bindings)
        self.flags = dict(flags)
        self.extras = dict(extras or {})
        self.sync_tracks_sym = sync_tracks_sym

    @staticmethod
    def default() -> "ConfigVal":
        return ConfigVal(DEFAULT_EXTENTS, DEFAULT_FLAGS)

    @staticmethod
    def from_config(cfg) -> "ConfigVal":
        """Bindings from a live config (the port's ``ScaleSimConfig`` or
        the full view's ``SimConfig``). ``sync_tracks`` follows the class's
        own property: the full view tracks per peer id (N), the scale
        round per member slot (M)."""
        bindings: Dict[str, int] = {}
        extras: Dict[str, int] = {}
        flags: Dict[str, bool] = {}
        for field in dataclasses.fields(cfg):
            v = getattr(cfg, field.name)
            if isinstance(v, bool):
                flags[field.name] = v
            elif isinstance(v, int):
                if field.name in SYMBOLS:
                    bindings[SYMBOLS[field.name]] = v
                else:
                    extras[field.name] = v
        for prop, symbol in PROPERTY_SYMBOLS.items():
            if hasattr(cfg, prop):
                bindings[symbol] = int(getattr(cfg, prop))
        sync_sym = "N" if type(cfg).__name__ == "SimConfig" else "M"
        flags.setdefault("narrow_dtypes", False)
        flags.setdefault("narrow_int8", False)
        flags.setdefault("narrow_q_int8", False)
        return ConfigVal(bindings, flags, extras, sync_tracks_sym=sync_sym)

    def has(self, name: str) -> bool:
        return (name in SYMBOLS or name in PROPERTY_SYMBOLS
                or name in self.flags or name in self.extras
                or name in ("sync_tracks", "timer_dtype", "tx_dtype",
                            "q_dtype"))

    def attr(self, name: str):
        if name in SYMBOLS:
            return Poly.var(SYMBOLS[name])
        if name in PROPERTY_SYMBOLS:
            return Poly.var(PROPERTY_SYMBOLS[name])
        if name == "sync_tracks":
            return Poly.var(self.sync_tracks_sym)
        if name == "timer_dtype":
            return DtypeVal(
                "int16" if self.flags.get("narrow_dtypes") else "int32")
        if name == "tx_dtype":
            if self.flags.get("narrow_int8"):
                return DtypeVal("int8")
            return self.attr("timer_dtype")
        if name == "q_dtype":
            if self.flags.get("narrow_q_int8"):
                return DtypeVal("int8")
            return self.attr("timer_dtype")
        if name in self.flags:
            return BoolVal(self.flags[name])
        if name in self.extras:
            return Poly.const(self.extras[name])
        return None


# --- class index ----------------------------------------------------------


@dataclasses.dataclass
class ClassInfo:
    name: str
    module: ModuleInfo
    node: ast.ClassDef
    fields: Tuple[str, ...]  # AnnAssign field order (NamedTuple schema)


def _class_has_create(node: ast.ClassDef) -> bool:
    return any(isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
               and b.name == "create" for b in node.body)


def index_classes(project: Project) -> Dict[str, ClassInfo]:
    """Top-level classes with annotated fields, keyed by bare name. A name
    defined in several modules keeps the first *state-like* one (it has a
    ``create``, checked on the class body itself, not the project-wide
    method table, which cannot tell two same-named classes apart)."""
    out: Dict[str, ClassInfo] = {}
    for mod in project.modules:
        for top in mod.tree.body:
            if not isinstance(top, ast.ClassDef):
                continue
            fields = tuple(
                t.target.id for t in top.body
                if isinstance(t, ast.AnnAssign)
                and isinstance(t.target, ast.Name)
            )
            if not fields:
                continue
            if top.name in out:
                if (_class_has_create(out[top.name].node)
                        or not _class_has_create(top)):
                    continue
            out[top.name] = ClassInfo(top.name, mod, top, fields)
    return out


# --- the interpreter ------------------------------------------------------

_CREATION_FNS = {"zeros", "ones", "empty", "full"}
_LIKE_FNS = {"zeros_like", "ones_like", "full_like", "empty_like"}
_NEW_METHODS = {"new_zeros", "new_ones", "new_empty", "new_full"}
_COMPARE_FNS = {"eq", "ne", "lt", "le", "gt", "ge", "not_equal",
                "logical_and", "logical_or", "logical_xor", "logical_not"}
_ELEMENTWISE_FNS = {
    "where", "minimum", "maximum", "add", "sub", "subtract", "mul",
    "multiply", "div", "true_divide", "remainder", "fmod", "pow", "clamp",
    "clip", "floor_divide", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_left_shift", "bitwise_right_shift", "abs",
    "neg", "negative", "sign", "masked_fill",
} | _COMPARE_FNS
#: methods that return their receiver's shape and dtype: copies, device
#: moves, and the in-place stores that take the place of JAX's ``.at[]``
_SELF_METHODS = {
    "clone", "contiguous", "detach", "cpu", "cuda", "flip", "roll",
    "fill_", "zero_", "copy_", "index_put_", "index_put", "scatter_",
    "scatter", "scatter_reduce_", "scatter_reduce", "scatter_add_",
    "scatter_add", "index_add_", "index_add", "index_fill_", "index_fill",
    "masked_fill_", "masked_scatter_", "clamp_", "clip_", "add_", "sub_",
    "mul_", "bitwise_and_", "bitwise_or_", "bitwise_xor_", "neg_", "abs_",
}
_REDUCTION_FNS = {"sum", "prod", "nansum", "max", "min", "amax", "amin",
                  "any", "all", "mean", "argmax", "argmin", "count_nonzero"}
_SCAN_FNS = {"cumsum", "cumprod"}
#: reductions of an integer or bool tensor that give int64 (``dtype=``
#: aside), and those that always give int64 or bool
_INT64_REDUCTIONS = {"sum", "prod", "nansum"}
_INDEX_REDUCTIONS = {"argmax": "int64", "argmin": "int64",
                     "count_nonzero": "int64", "any": "bool", "all": "bool"}

#: shape summaries of the dense helpers the step bodies lean on: a
#: registry, not interpretation (the same names as the JAX package's
#: ``ops/dense.py``, ``ops/select.py`` and ``sim/transport.py``)
_HELPER_SHAPES = {
    # (table, idx, ...) -> idx-shaped gather of table values
    "select_cols": "gather",
    "lookup_cols": "gather",
    # (dest, idx, vals, valid) -> dest-shaped scatter
    "scatter_cols_set": "dest",
    "scatter_cols_max": "dest",
    "scatter_cols_add": "dest",
    "scatter_cols_or": "dest",
    # (mask, k, key) -> ([N, k] int32 slots, [N, k] bool ok)
    "sample_k": "sample_k",
    # (mask, weight, k, key) -> same
    "sample_k_biased": "sample_k_biased",
    # (mask, key) -> ([N] int32, [N] bool)
    "sample_one": "sample_one",
    # (card, idx) / (table, idx) -> idx.shape + card.shape[1:]
    "card_at": "card_at",
    "take_rows": "card_at",
    # (a, b) -> broadcast int32
    "pack_inc_state": "pack_int32",
}

#: the port's draws (``random.py``): (key, shape, ...) -> shape, dtype
_DRAWS = {"uniform": "float32", "randint": "int32", "bits": "int64"}


def _int_const(node) -> Optional[int]:
    """The value of an int literal (``-1`` included), else None."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _int_const(node.operand)
        return -v if v is not None else None
    if (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool)):
        return node.value
    return None


def _kw_node(node: ast.Call, *names):
    return next((kw.value for kw in node.keywords if kw.arg in names), None)


class ShapeContext:
    """Shared interpretation state: project, class index, bindings for
    branch decisions, call stack, per-class inventory cache."""

    def __init__(self, project: Project, config: ConfigVal,
                 interprocedural: bool = True):
        self.project = project
        self.classes = index_classes(project)
        self.config = config
        self.interprocedural = interprocedural
        self.stack: List[str] = []
        self.struct_cache: Dict[str, Any] = {}

    def bindings(self) -> Dict[str, int]:
        return self.config.bindings


class ShapeAnalysis(ForwardAnalysis):
    """Forward shape interpretation of one function body."""

    def __init__(self, ctx: ShapeContext, fn: Optional[FunctionInfo],
                 path: str, findings: Optional[List[Finding]] = None,
                 densify: bool = False, depth: int = 0):
        super().__init__(fn, path, findings)
        self.ctx = ctx
        self.densify = densify
        self.depth = depth

    # -- joins -------------------------------------------------------------

    def join(self, a, b):
        if isinstance(a, ArrayVal) and isinstance(b, ArrayVal):
            return a if a == b else None
        if isinstance(a, StructVal) and isinstance(b, StructVal) and (
                a.cls_name == b.cls_name):
            fields = {
                f: self.join(a.fields.get(f), b.fields.get(f))
                for f in set(a.fields) | set(b.fields)
            }
            return StructVal(a.cls_name, a.field_order, fields)
        if is_sym(a) and is_sym(b):
            return a if sym_render(a) == sym_render(b) else None
        return super().join(a, b)

    # -- leaves ------------------------------------------------------------

    def eval_constant(self, node, env):
        if isinstance(node.value, bool):
            return BoolVal(node.value)
        if isinstance(node.value, int):
            return Poly.const(node.value)
        if isinstance(node.value, str):
            return node.value
        if node.value is None:
            return NONE
        return None

    def eval_expr(self, node, env):
        if isinstance(node, ast.Name) and node.id not in env:
            if node.id == "bool":
                return DtypeVal("bool")
            if node.id in self.ctx.classes:
                return ClassRef(self.ctx.classes[node.id])
            return None
        if isinstance(node, ast.Compare):
            return self._eval_compare(node, env)
        if isinstance(node, ast.IfExp):
            test = self.eval_expr(node.test, env)
            if isinstance(test, BoolVal):
                return self.eval_expr(
                    node.body if test.value else node.orelse, env)
            return self.join(self.eval_expr(node.body, env),
                             self.eval_expr(node.orelse, env))
        if isinstance(node, ast.UnaryOp):
            v = self.eval_expr(node.operand, env)
            if isinstance(node.op, ast.Not):
                return BoolVal(not v.value) if isinstance(v, BoolVal) \
                    else None
            if isinstance(node.op, ast.USub):
                if isinstance(v, Poly):
                    return -v
                if isinstance(v, SymOp):
                    return SymOp("neg", (v,))
                return v if isinstance(v, ArrayVal) else None
            return v
        if isinstance(node, ast.Lambda):
            self.on_nested_def(node, env)
            return LambdaVal(node, env)
        return super().eval_expr(node, env)

    def _eval_compare(self, node: ast.Compare, env):
        vals = [self.eval_expr(node.left, env)] + [
            self.eval_expr(c, env) for c in node.comparators
        ]
        arrays = [v for v in vals if isinstance(v, ArrayVal)]
        if arrays:
            out = self._broadcast(vals, "bool", node)
            self._check_dense(node, out, vals)
            return out
        if len(node.ops) == 1 and isinstance(node.ops[0], (ast.Is, ast.IsNot)):
            nones = [v is NONE for v in vals]
            if not all(v is NONE or isinstance(v, _NOT_NONE) for v in vals):
                return None
            return BoolVal((nones[0] == nones[1])
                           == isinstance(node.ops[0], ast.Is))
        # concrete decision for config-extent guards (branch picking)
        concrete = []
        for v in vals:
            if isinstance(v, BoolVal):
                concrete.append(int(v.value))
                continue
            if not is_sym(v):
                return None
            ev = sym_eval(v, self.ctx.bindings())
            if ev is None:
                return None
            concrete.append(ev)
        ok = True
        for op, a, b in zip(node.ops, concrete, concrete[1:]):
            table = {
                ast.Lt: a < b, ast.LtE: a <= b, ast.Gt: a > b,
                ast.GtE: a >= b, ast.Eq: a == b, ast.NotEq: a != b,
            }
            res = table.get(type(op))
            if res is None:
                return None
            ok = ok and res
        return BoolVal(ok)

    # -- attributes / subscripts -------------------------------------------

    def eval_attr(self, node, base, env):
        name = node.attr
        if isinstance(base, ConfigVal):
            return base.attr(name)
        if isinstance(base, StructVal):
            return base.fields.get(name)
        if isinstance(base, TupleVal) and len(base.elements) == 2 and (
                name in ("values", "indices")):
            return base.elements[name == "indices"]  # max/min/sort(dim=)
        if isinstance(base, ArrayVal):
            if name == "shape":
                return TupleVal(base.dims)
            if name == "dtype":
                return DtypeVal(base.dtype) if base.dtype else None
            if name in ("T", "mT"):
                dims = (tuple(reversed(base.dims)) if name == "T"
                        else base.dims[:-2] + base.dims[-2:][::-1])
                return ArrayVal(dims, base.dtype, base.site)
            if name in ("data", "real"):
                return base
            if name == "ndim":
                return Poly.const(len(base.dims))
            return None
        if isinstance(base, ClassRef):
            cands = self.ctx.project.methods.get((base.info.name, name), [])
            own = [c for c in cands if c.module is base.info.module]
            if len(own) == 1:
                return FnRef(own[0])
            return FnRef(cands[0]) if len(cands) == 1 else None
        # dtype literal spellings (torch.int16, torch.long, np.int32, ...)
        dotted = dotted_name(node)
        if "." in dotted:
            head, leaf = dotted.rsplit(".", 1)
            canon = canon_dtype(leaf)
            if head in _DTYPE_BASES and canon is not None:
                return DtypeVal(canon)
        return None

    def eval_subscript(self, node, base, env):
        if isinstance(base, ArrayVal):
            return self._index(node, base, env)
        if isinstance(base, TupleVal) and isinstance(node.slice, ast.Slice) \
                and node.slice.step is None:
            lo, hi = (_int_const(node.slice.lower) if node.slice.lower else 0,
                      _int_const(node.slice.upper) if node.slice.upper
                      else len(base.elements))
            if lo is not None and hi is not None:
                return TupleVal(base.elements[lo:hi])
            return None
        return super().eval_subscript(node, base, env)

    def _index(self, node: ast.Subscript, base: ArrayVal, env):
        elts = (list(node.slice.elts)
                if isinstance(node.slice, ast.Tuple) else [node.slice])
        ellipsis = [e for e in elts
                    if isinstance(e, ast.Constant) and e.value is Ellipsis]
        if len(ellipsis) > 1:
            return None
        used = sum(1 for e in elts
                   if not (isinstance(e, ast.Constant)
                           and (e.value is None or e.value is Ellipsis)))
        out_dims: List[Any] = []
        adv: List[ArrayVal] = []
        adv_pos: Optional[int] = None
        dim_i = 0
        for elt in elts:
            if isinstance(elt, ast.Constant) and elt.value is Ellipsis:
                span = len(base.dims) - used
                if span < 0:
                    return None
                out_dims.extend(base.dims[dim_i:dim_i + span])
                dim_i += span
                continue
            if isinstance(elt, ast.Slice):
                if dim_i >= len(base.dims):
                    return None
                out_dims.append(self._slice_dim(elt, base.dims[dim_i], env))
                dim_i += 1
                continue
            if isinstance(elt, ast.Constant) and elt.value is None:
                out_dims.append(Poly.const(1))  # newaxis
                continue
            v = self.eval_expr(elt, env)
            if dim_i >= len(base.dims):
                return None
            if isinstance(v, ArrayVal):
                if v.dtype == "bool":
                    return None  # a mask index: data-dependent length
                if v.dims == ():
                    dim_i += 1  # scalar-tensor index drops the dim
                    continue
                if adv_pos is None:
                    adv_pos = len(out_dims)
                adv.append(v)
                dim_i += 1
                continue
            if is_sym(v) or isinstance(elt, ast.Constant):
                dim_i += 1  # integer index drops the dim
                continue
            return None  # unknown index form
        out_dims.extend(base.dims[dim_i:])
        if adv:
            bc = self._broadcast_dims([a.dims for a in adv])
            if bc is None:
                return None
            out_dims[adv_pos:adv_pos] = list(bc)
        out = ArrayVal(tuple(out_dims), base.dtype, base.site)
        self._check_dense(node, out, [base] + adv)
        return out

    def _slice_dim(self, s: ast.Slice, dim, env):
        if s.step is not None:
            return None
        lo = self.eval_expr(s.lower, env) if s.lower is not None else None
        hi = self.eval_expr(s.upper, env) if s.upper is not None else None
        if s.lower is None and s.upper is None:
            return dim
        if s.lower is None and is_sym(hi):
            return hi  # [:k] — k elements (k <= dim by contract)
        if s.upper is None and is_sym(lo) and dim is not None:
            return sym_binop("sub", dim, lo)
        if is_sym(lo) and is_sym(hi):
            return sym_binop("sub", hi, lo)
        return None

    # -- operators ---------------------------------------------------------

    def eval_binop(self, node, left, right, env):
        if isinstance(left, TupleVal) and isinstance(right, TupleVal) \
                and isinstance(getattr(node, "op", None), ast.Add):
            return TupleVal(left.elements + right.elements)
        if isinstance(left, ArrayVal) or isinstance(right, ArrayVal):
            out = self._broadcast([left, right], None, node)
            self._check_dense(node, out, [left, right])
            return out
        if is_sym(left) and is_sym(right):
            op = {
                ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul",
                ast.FloorDiv: "floordiv", ast.Mod: "mod",
            }.get(type(getattr(node, "op", None)))
            if op is None:
                return None
            return sym_binop(op, left, right)
        return None

    def _broadcast_dims(self, dim_lists):
        """Right-aligned broadcast over symbolic dims; ``None`` on an
        unknown or provably mismatched pairing."""
        rank = max(len(d) for d in dim_lists)
        out = []
        for i in range(rank):
            cur = None
            for dims in dim_lists:
                j = i - (rank - len(dims))
                if j < 0:
                    continue
                d = dims[j]
                if d is None:
                    return None
                if isinstance(d, Poly) and d.is_const() and (
                        d.evaluate({}) == 1):
                    continue
                if cur is None:
                    cur = d
                elif sym_render(cur) != sym_render(d):
                    return None  # can't prove compatible
            out.append(cur if cur is not None else Poly.const(1))
        return tuple(out)

    def _broadcast(self, vals, dtype: Optional[str], node) -> Optional[
            ArrayVal]:
        arrays = [v for v in vals if isinstance(v, ArrayVal)]
        if not arrays or any(not a.known() for a in arrays):
            return None
        if any(not (isinstance(v, (ArrayVal, BoolVal, DtypeVal))
                    or is_sym(v) or v is None) for v in vals):
            return None
        dims = self._broadcast_dims([a.dims for a in arrays])
        if dims is None:
            return None
        if dtype is None:
            dtypes = {a.dtype for a in arrays}
            dtype = dtypes.pop() if len(dtypes) == 1 else None
        site = arrays[0].site
        return ArrayVal(dims, dtype, site)

    # -- calls -------------------------------------------------------------

    def eval_call(self, node, env, args, keywords):
        name = dotted_name(node.func)
        last = name.rsplit(".", 1)[-1]

        # method-style calls: evaluate the receiver ourselves (the base
        # engine does not evaluate node.func)
        if isinstance(node.func, ast.Attribute):
            base = self.eval_expr(node.func.value, env)
            attr = node.func.attr
            if isinstance(base, StructVal) and attr == "_replace":
                updates = {
                    kw.arg: keywords.get(kw.arg)
                    for kw in node.keywords if kw.arg is not None
                }
                return base.replace(updates)
            if isinstance(base, ArrayVal):
                return self._array_method(node, base, attr, args,
                                          keywords, env)
            if isinstance(base, FnRef):
                return self._call_fn(base.fn, node, args, keywords)
            if isinstance(base, ClassRef):
                fn = self.eval_attr(node.func, base, env)
                if isinstance(fn, FnRef):
                    return self._call_fn(fn.fn, node, args, keywords)
                return None

        # local lambda or def / class constructor / resolvable function
        if isinstance(node.func, ast.Name):
            fv = env.get(node.func.id)
            if isinstance(fv, LambdaVal):
                return self._call_lambda(fv, args, keywords)
            if isinstance(fv, ClassRef):
                return self._construct(fv.info, node, args, keywords)
            if node.func.id in self.ctx.classes and (
                    self.fn is None
                    or node.func.id not in self.fn.local_names()):
                return self._construct(self.ctx.classes[node.func.id],
                                       node, args, keywords)

        # builtins
        if name == "getattr" and len(node.args) >= 2:
            if isinstance(args[0], ConfigVal) and isinstance(args[1], str):
                if args[0].has(args[1]):
                    return args[0].attr(args[1])
                return args[2] if len(args) > 2 else None
            return None
        if name in ("max", "min") and len(args) >= 2:
            if all(is_sym(a) or isinstance(a, int) for a in args):
                return SymOp(name, args)
            return None
        if name == "int" and args:
            return args[0] if is_sym(args[0]) else None
        if name == "len":
            if args and isinstance(args[0], TupleVal):
                return Poly.const(len(args[0].elements))
            if args and isinstance(args[0], ArrayVal) and args[0].dims:
                return args[0].dims[0]
            return None
        if name in ("tuple", "list") and len(node.args) == 1:
            if isinstance(args[0], TupleVal):
                return args[0]
            return self._repeat_comprehension(node.args[0], env)

        # torch surface
        out = self._torch_call(node, name, last, args, keywords, env)
        if out is not None:
            return out

        # registered helper shapes (ops/dense, ops/select, transport)
        helper = _HELPER_SHAPES.get(last)
        if helper is not None:
            return self._helper_call(node, helper, args)

        # resolvable project call (inventory mode: constructors + helpers)
        if self.ctx.interprocedural and self.fn is not None:
            fn = self.ctx.project.resolve_call(node, self.fn)
            if fn is not None:
                return self._call_fn(fn, node, args, keywords)
        return None

    def _repeat_comprehension(self, node, env):
        """``tuple(z(n, c) for _ in range(5))`` -> five copies of one
        element's value (a single generator over a constant range)."""
        if not isinstance(node, (ast.GeneratorExp, ast.ListComp)) or len(
                node.generators) != 1:
            return None
        gen = node.generators[0]
        it = gen.iter
        if gen.ifs or not (isinstance(it, ast.Call)
                           and dotted_name(it.func) == "range"
                           and len(it.args) == 1):
            return None
        count = self.eval_expr(it.args[0], env)
        if not (isinstance(count, Poly) and count.is_const()):
            return None
        inner = dict(env)
        self._bind(gen.target, None, inner, node)
        elt = self.eval_expr(node.elt, inner)
        return TupleVal([elt] * count.evaluate({}))

    def _cast(self, node, args, keywords) -> Tuple[bool, Optional[str]]:
        """``.to(...)``/``.type(...)``: ``(True, dtype)`` for a dtype
        argument (None when it is not a literal), ``(False, None)`` for a
        device move, which keeps the dtype."""
        dt = keywords.get("dtype")
        if _kw_node(node, "dtype") is not None:
            return True, dt.name if isinstance(dt, DtypeVal) else None
        if not node.args:
            return False, None
        first = args[0]
        if isinstance(first, DtypeVal):
            return True, first.name
        arg = node.args[0]
        if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)) or (
                dotted_name(arg).rsplit(".", 1)[-1] in ("device", "dev")) or (
                isinstance(arg, ast.Call)
                and dotted_name(arg.func).endswith("device")):
            return False, None
        return True, None

    def _array_method(self, node, base: ArrayVal, attr, args, keywords,
                      env):
        site = (self.path, node.lineno)
        if attr in ("to", "type"):
            is_dtype, dt = self._cast(node, args, keywords)
            return ArrayVal(base.dims, dt if is_dtype else base.dtype,
                            base.site)
        if attr in _CAST_METHODS and not node.args:
            return ArrayVal(base.dims, _CAST_METHODS[attr], base.site)
        if attr in _SELF_METHODS:
            return base
        if attr in ("reshape", "view"):
            if len(args) == 1 and isinstance(args[0], DtypeVal):
                return None  # a bit-cast view
            dims = self._sizes(args)
            if dims is None:
                return None
            out = ArrayVal(dims, base.dtype, base.site)
            self._check_dense(node, out, [base])
            return out
        if attr == "flatten" and not node.args:
            total = Poly.const(1)
            for d in base.dims:
                total = sym_binop("mul", total, d) if d is not None else None
                if total is None:
                    return None
            return ArrayVal((total,), base.dtype, base.site)
        if attr == "size":
            if not node.args:
                return TupleVal(base.dims)
            ax = self._axis(node.args[0], len(base.dims))
            return base.dims[ax] if ax is not None else None
        if attr == "dim":
            return Poly.const(len(base.dims))
        if attr in ("unsqueeze", "squeeze", "expand", "expand_as", "repeat",
                    "t", "transpose", "permute"):
            return self._reshape_op(node, base, attr, args, env)
        if attr in _NEW_METHODS:
            dims = self._sizes(args[:1])
            if dims is None:
                return None
            dt = keywords.get("dtype")
            out = ArrayVal(dims, dt.name if isinstance(dt, DtypeVal)
                           else base.dtype, site)
            self._check_dense(node, out, [])
            return out
        if attr in ("gather", "index_select", "take_along_dim"):
            return self._gather(node, attr, [base] + list(args), keywords)
        if attr in _REDUCTION_FNS or attr in _SCAN_FNS:
            return self._reduce(base, node, attr, 0, args, keywords)
        if attr in _ELEMENTWISE_FNS:
            dtype = "bool" if attr in _COMPARE_FNS else None
            vals = [base] + list(args) + [keywords.get(k) for k in ("min", "max")
                                          if k in keywords]
            out = self._broadcast(vals, dtype, node)
            if out is not None and dtype is None and attr not in ("where",):
                out = ArrayVal(out.dims, base.dtype, out.site)
            self._check_dense(node, out, vals)
            return out
        return None

    def _axis(self, node, rank: int) -> Optional[int]:
        ax = _int_const(node)
        if ax is None or not -rank <= ax < rank:
            return None
        return ax % rank

    def _sizes(self, args) -> Optional[Tuple]:
        """Sizes given as varargs (``zeros(n, m)``) or one tuple
        (``zeros((n, m))``, ``zeros(s)`` for a ``*s`` tuple). A ``-1`` size
        (infer) is not proven and makes the shape unknown."""
        if len(args) == 1 and isinstance(args[0], TupleVal):
            args = list(args[0].elements)
        dims = []
        for a in args:
            if not is_sym(a):
                return None
            if isinstance(a, Poly) and a.is_const() and a.evaluate({}) < 0:
                return None
            dims.append(a)
        return tuple(dims)

    def _reshape_op(self, node, base: ArrayVal, attr, args, env):
        dims = list(base.dims)
        rank = len(dims)
        out_dims: Optional[Tuple] = None
        inputs = [base]
        if attr == "unsqueeze" and node.args:
            ax = _int_const(node.args[0])
            if ax is not None and -rank - 1 <= ax <= rank:
                dims.insert(ax % (rank + 1), Poly.const(1))
                out_dims = tuple(dims)
        elif attr == "squeeze":
            if node.args:
                ax = self._axis(node.args[0], rank)
                if ax is not None and isinstance(dims[ax], Poly) and (
                        dims[ax] == Poly.const(1)):
                    del dims[ax]
                    out_dims = tuple(dims)
                elif ax is not None and dims[ax] is not None and not (
                        isinstance(dims[ax], Poly) and dims[ax].is_const()):
                    out_dims = tuple(dims)  # a symbolic extent is >= 2
        elif attr in ("expand", "repeat"):
            sizes = args[0].elements if (
                len(args) == 1 and isinstance(args[0], TupleVal)) else args
            nodes = node.args[0].elts if (
                len(node.args) == 1
                and isinstance(node.args[0], ast.Tuple)) else node.args
            if len(sizes) < rank or len(nodes) != len(sizes):
                return None
            lead = len(sizes) - rank
            new = []
            for i, s in enumerate(sizes):
                old = dims[i - lead] if i >= lead else Poly.const(1)
                if attr == "expand" and _int_const(nodes[i]) == -1:
                    new.append(old)
                elif not is_sym(s) or old is None:
                    return None
                else:
                    new.append(s if attr == "expand"
                               else sym_binop("mul", old, s))
            out_dims = tuple(new)
        elif attr == "expand_as" and args and isinstance(args[0], ArrayVal):
            out_dims = args[0].dims
            inputs.append(args[0])
        elif attr == "t" or (attr == "transpose" and len(node.args) == 2):
            a, b = (self._axis(n, rank) for n in node.args) if (
                attr == "transpose") else (0, rank - 1)
            if a is not None and b is not None and rank >= 1:
                dims[a], dims[b] = dims[b], dims[a]
                out_dims = tuple(dims)
        elif attr == "permute":
            order = [self._axis(n, rank) for n in (
                node.args[0].elts if len(node.args) == 1
                and isinstance(node.args[0], ast.Tuple) else node.args)]
            if None not in order and sorted(order) == list(range(rank)):
                out_dims = tuple(dims[i] for i in order)
        if out_dims is None:
            return None
        out = ArrayVal(out_dims, base.dtype, base.site)
        if attr in ("expand", "expand_as", "repeat"):
            self._check_dense(node, out, inputs)
        return out

    def _gather(self, node, kind, operands, keywords):
        """``gather(x, dim, idx)``, ``index_select(x, dim, idx)`` and
        ``take_along_dim(x, idx, dim)`` (``operands``: receiver first)."""
        x = operands[0] if operands and isinstance(operands[0], ArrayVal) \
            else None
        idx = next((v for v in operands[1:] if isinstance(v, ArrayVal)),
                   keywords.get("index") if isinstance(
                       keywords.get("index"), ArrayVal) else None)
        if x is None or idx is None or not x.known() or not idx.known():
            return None
        if kind == "index_select":
            dim_node = _kw_node(node, "dim")
            if dim_node is None:
                pos = [a for a in node.args if _int_const(a) is not None]
                dim_node = pos[0] if pos else None
            ax = self._axis(dim_node, len(x.dims)) if dim_node is not None \
                else None
            if ax is None or len(idx.dims) != 1:
                return None
            dims = list(x.dims)
            dims[ax] = idx.dims[0]
            out = ArrayVal(tuple(dims), x.dtype, idx.site)
        else:
            if len(idx.dims) != len(x.dims):
                return None
            out = ArrayVal(idx.dims, x.dtype, idx.site)
        self._check_dense(node, out, [x, idx])
        return out

    def _reduce(self, base: ArrayVal, node, attr, pos: int, args, keywords):
        """A reduction or scan of ``base`` with ``dim=``/``keepdim=`` (or
        positionally from ``node.args[pos]``); ``max``/``min`` over a dim
        give ``(values, indices)``, over another tensor the maximum."""
        if attr in ("max", "min") and len(args) > pos and isinstance(
                args[pos], ArrayVal):
            return self._broadcast([base, args[pos]], base.dtype, node)
        dtype = base.dtype
        if attr in _INDEX_REDUCTIONS:
            dtype = _INDEX_REDUCTIONS[attr]
        elif attr in _INT64_REDUCTIONS | _SCAN_FNS and dtype in (
                "bool", "int8", "uint8", "int16", "int32"):
            dtype = "int64"
        dt = keywords.get("dtype")
        if isinstance(dt, DtypeVal):
            dtype = dt.name
        dim_node = _kw_node(node, "dim", "axis")
        if dim_node is None and len(node.args) > pos:
            dim_node = node.args[pos]
        if attr in _SCAN_FNS:
            return ArrayVal(base.dims, dtype, base.site)
        keep_node = _kw_node(node, "keepdim")
        if keep_node is None and dim_node is not None and len(
                node.args) > pos + 1:
            keep_node = node.args[pos + 1]
        keep = isinstance(keep_node, ast.Constant) and keep_node.value is True
        if dim_node is None:
            return ArrayVal((), dtype, base.site)
        axes_nodes = dim_node.elts if isinstance(dim_node, ast.Tuple) \
            else [dim_node]
        axes = {self._axis(a, len(base.dims)) for a in axes_nodes}
        if None in axes:
            return None
        dims = tuple(Poly.const(1) if i in axes else d
                     for i, d in enumerate(base.dims) if keep or i not in axes)
        out = ArrayVal(dims, dtype, base.site)
        if attr in ("max", "min"):
            return TupleVal((out, ArrayVal(dims, "int64", base.site)))
        return out

    def _dtype_kw(self, node, keywords) -> Tuple[bool, Optional[str]]:
        """``(given, name)`` of a ``dtype=`` keyword."""
        if _kw_node(node, "dtype") is None:
            return False, None
        dt = keywords.get("dtype")
        return True, dt.name if isinstance(dt, DtypeVal) else None

    def _fill_dtype(self, node) -> Optional[str]:
        """torch's dtype for a fill or data literal without ``dtype=``."""
        if isinstance(node, ast.UnaryOp):
            node = node.operand
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return "bool"
            if isinstance(node.value, int):
                return "int64"
            if isinstance(node.value, float):
                return "float32"
        return None

    def _torch_call(self, node, name, last, args, keywords, env):
        site = (self.path, node.lineno)
        given, dt = self._dtype_kw(node, keywords)

        if last in _CREATION_FNS:
            if last == "full":
                dims = self._sizes(args[:1])
                if not given:
                    dt = self._fill_dtype(node.args[1]) if len(
                        node.args) > 1 else None
            else:
                dims = self._sizes(args)
                if not given:
                    dt = "float32"  # torch's default dtype
            if dims is None:
                return None
            out = ArrayVal(dims, dt, site)
            self._check_dense(node, out, [])
            return out
        if last in _LIKE_FNS and args and isinstance(args[0], ArrayVal):
            if not given and last == "full_like" and len(node.args) > 1:
                given, dt = True, args[0].dtype
            return ArrayVal(args[0].dims, dt if given else args[0].dtype,
                            site)
        if last == "arange":
            if not given:
                floats = any(isinstance(a, ast.Constant)
                             and isinstance(a.value, float) for a in node.args)
                dt = "float32" if floats else "int64"
            if len(node.args) == 1 and is_sym(args[0]):
                return ArrayVal((args[0],), dt, site)
            if len(node.args) == 2 and is_sym(args[0]) and is_sym(args[1]):
                return ArrayVal((sym_binop("sub", args[1], args[0]),), dt,
                                site)
            return None
        if last == "eye" and args and is_sym(args[0]):
            cols = args[1] if len(args) > 1 and is_sym(args[1]) else args[0]
            out = ArrayVal((args[0], cols), dt if given else "float32", site)
            self._check_dense(node, out, [])
            return out
        if last in ("tensor", "as_tensor") and node.args:
            data = node.args[0]
            if not given:
                dt = self._fill_dtype(data)
            if isinstance(data, (ast.List, ast.Tuple)):
                return ArrayVal((Poly.const(len(data.elts)),), dt, site)
            if is_sym(args[0]) or isinstance(args[0], BoolVal) or (
                    self._fill_dtype(data) is not None):
                return ArrayVal((), dt, site)
            return None
        if last in ("broadcast_to", "reshape") and len(args) >= 2 and (
                isinstance(args[0], ArrayVal)):
            dims = self._sizes(args[1:2])
            if dims is None:
                return None
            out = ArrayVal(dims, args[0].dtype, site)
            self._check_dense(node, out, [args[0]])
            return out
        if last in ("cat", "concatenate") and node.args:
            return self._concat(node, env, stack=False)
        if last == "stack" and node.args:
            return self._concat(node, env, stack=True)
        if last in ("gather", "index_select", "take_along_dim") and (
                "." in name):
            return self._gather(node, last, args, keywords)
        if last in ("unsqueeze", "squeeze", "transpose", "permute") and (
                args and isinstance(args[0], ArrayVal)):
            sub = ast.Call(func=node.func, args=node.args[1:],
                           keywords=node.keywords)
            ast.copy_location(sub, node)
            return self._reshape_op(sub, args[0], last, args[1:], env)
        if "." in name and (last in _REDUCTION_FNS or last in _SCAN_FNS) and (
                args and isinstance(args[0], ArrayVal)):
            return self._reduce(args[0], node, last, 1, args, keywords)
        if "." in name and last in _ELEMENTWISE_FNS:
            vals = list(args) + [keywords.get(k) for k in ("min", "max")
                                 if k in keywords]
            arrays = [a for a in vals if isinstance(a, ArrayVal)]
            if not arrays:
                return None
            dtype = "bool" if last in _COMPARE_FNS else None
            out = self._broadcast(vals, dtype, node)
            self._check_dense(node, out, vals)
            return out
        if "." in name and last in ("flip", "roll", "clone", "abs") and (
                args and isinstance(args[0], ArrayVal)):
            return args[0]
        if last in _DRAWS and len(node.args) >= 2:
            dims = self._sizes(args[1:2])
            if dims is None:
                return None
            out = ArrayVal(dims, _DRAWS[last], site)
            self._check_dense(node, out, [])
            return out
        return None

    def _concat(self, node, env, stack: bool):
        if not isinstance(node.args[0], (ast.List, ast.Tuple)):
            return None
        parts = [self.eval_expr(e, env) for e in node.args[0].elts]
        if not parts or any(not isinstance(p, ArrayVal) or not p.known()
                            for p in parts):
            return None
        axis = 0
        ax_node = _kw_node(node, "dim", "axis")
        if ax_node is None and len(node.args) > 1:
            ax_node = node.args[1]
        if ax_node is not None:
            axis = _int_const(ax_node)
            if axis is None:
                return None
        dtypes = {p.dtype for p in parts}
        dt = dtypes.pop() if len(dtypes) == 1 else None
        site = parts[0].site
        if stack:
            dims = list(parts[0].dims)
            if any(p.dims != parts[0].dims for p in parts):
                return None
            if not -len(dims) - 1 <= axis <= len(dims):
                return None
            if axis < 0:
                axis += len(dims) + 1
            dims.insert(axis, Poly.const(len(parts)))
            return ArrayVal(tuple(dims), dt, site)
        rank = len(parts[0].dims)
        if any(len(p.dims) != rank for p in parts) or not (
                -rank <= axis < rank):
            return None
        axis %= rank
        total = parts[0].dims[axis]
        for p in parts[1:]:
            total = sym_binop("add", total, p.dims[axis])
        dims = list(parts[0].dims)
        dims[axis] = total
        return ArrayVal(tuple(dims), dt, site)

    def _helper_call(self, node, kind: str, args):
        def arr(i):
            return args[i] if (len(args) > i
                               and isinstance(args[i], ArrayVal)
                               and args[i].known()) else None

        if kind == "gather":
            table, idx = arr(0), arr(1)
            if table is None or idx is None:
                return None
            return ArrayVal(idx.dims, table.dtype, idx.site)
        if kind == "dest":
            return arr(0)
        if kind in ("sample_k", "sample_k_biased"):
            mask = arr(0)
            k = args[2] if kind == "sample_k_biased" else (
                args[1] if len(args) > 1 else None)
            if mask is None or not is_sym(k) or not mask.dims:
                return None
            lead = mask.dims[0]
            return TupleVal((ArrayVal((lead, k), "int32", mask.site),
                             ArrayVal((lead, k), "bool", mask.site)))
        if kind == "sample_one":
            mask = arr(0)
            if mask is None or not mask.dims:
                return None
            lead = mask.dims[0]
            return TupleVal((ArrayVal((lead,), "int32", mask.site),
                             ArrayVal((lead,), "bool", mask.site)))
        if kind == "card_at":
            card, idx = arr(0), arr(1)
            if card is None or idx is None or len(card.dims) < 2:
                return None
            return ArrayVal(idx.dims + card.dims[1:], card.dtype,
                            idx.site)
        if kind == "pack_int32":
            out = self._broadcast(args, "int32", node)
            self._check_dense(node, out, args)
            return out
        return None

    # -- interprocedural ---------------------------------------------------

    def _call_lambda(self, lv: LambdaVal, args, keywords):
        if self.depth >= 12:
            return None
        a = lv.node.args
        env = dict(lv.env)
        params = [p.arg for p in a.posonlyargs + a.args]
        for pname, val in zip(params, args):
            env[pname] = val
        defaults = a.defaults
        for pname, d in zip(params[len(params) - len(defaults):],
                            defaults):
            env.setdefault(pname, self.eval_expr(d, dict(lv.env)))
        if a.vararg is not None:
            env[a.vararg.arg] = TupleVal(args[len(params):])
        for kw, d in zip(a.kwonlyargs, a.kw_defaults):
            env[kw.arg] = (self.eval_expr(d, dict(lv.env))
                           if d is not None else None)
        env.update(keywords)
        # the body is textually inside the caller, so the densify patrol
        # follows the call in: `def z(*s): return torch.zeros(s, ...)`
        # building an [N, N] flags exactly like the direct form
        sub = ShapeAnalysis(self.ctx, self.fn, self.path, self.findings,
                            densify=self.densify, depth=self.depth + 1)
        if isinstance(lv.node, ast.Lambda):
            return sub.eval_expr(lv.node.body, env)
        sub.run(list(lv.node.body), env)
        return sub.return_value

    def _call_fn(self, fn: FunctionInfo, node, args, keywords):
        if self.depth >= 12 or fn.qualname in self.ctx.stack:
            return None
        a = fn.node.args
        params = [p.arg for p in a.posonlyargs + a.args]
        env: Env = {}
        for pname, val in zip(params, args):
            env[pname] = val
        defaults = a.defaults
        for pname, d in zip(params[len(params) - len(defaults):],
                            defaults):
            if pname not in env:
                sub0 = ShapeAnalysis(self.ctx, fn, fn.path, self.findings,
                                     depth=self.depth + 1)
                env[pname] = sub0.eval_expr(d, {})
        for kw in a.kwonlyargs:
            env.setdefault(kw.arg, None)
        for pname, val in keywords.items():
            if pname in params or any(k.arg == pname
                                      for k in a.kwonlyargs):
                env[pname] = val
        self.ctx.stack.append(fn.qualname)
        try:
            sub = ShapeAnalysis(self.ctx, fn, fn.path, self.findings,
                                densify=False, depth=self.depth + 1)
            sub.run(list(fn.node.body), env)
            return sub.return_value
        finally:
            self.ctx.stack.pop()

    def _construct(self, info: ClassInfo, node, args, keywords):
        fields: Dict[str, Any] = {}
        for fname, val in zip(info.fields, args):
            fields[fname] = val
        for kw in node.keywords:
            if kw.arg is not None and kw.arg in info.fields:
                fields[kw.arg] = keywords.get(kw.arg)
        return StructVal(info.name, info.fields, fields)

    # -- concrete statements -----------------------------------------------

    def _stmt(self, stmt, env):
        # config-extent guards decide concretely: `if cfg.tx_max_cells
        # > 1:` runs ONE branch, matching the real constructor (a join
        # of both would lose the partial-buffer shapes)
        if isinstance(stmt, ast.If):
            test = self.eval_expr(stmt.test, env)
            if isinstance(test, BoolVal):
                return self.run(stmt.body if test.value else stmt.orelse,
                                env)
        if isinstance(stmt, ast.FunctionDef):
            self.on_nested_def(stmt, env)
            env[stmt.name] = LambdaVal(stmt, env)
            return env
        return super()._stmt(stmt, env)

    # -- densify -----------------------------------------------------------

    def _n_degree(self, arr: ArrayVal) -> Optional[int]:
        if not arr.known():
            return None
        return sum(d.degree("N") for d in arr.dims)

    def _check_dense(self, node, out, inputs) -> None:
        """Flag a provably superlinear intermediate: the output's N-degree
        is >= 2 and exceeds every input tensor's. Config extents (M, Q,
        ...) are bounded constants; only N scales with the cluster, so only
        N-degree growth densifies."""
        if not self.densify or not isinstance(out, ArrayVal):
            return
        out_deg = self._n_degree(out)
        if out_deg is None or out_deg < 2:
            return
        in_degs = []
        for v in inputs:
            if isinstance(v, ArrayVal):
                d = self._n_degree(v)
                if d is None:
                    return  # unknown operand: cannot prove growth
                in_degs.append(d)
            elif not (is_sym(v) or isinstance(v, (BoolVal, DtypeVal))
                      or v is None):
                return
        if in_degs and max(in_degs) >= out_deg:
            return
        shape = "[" + ", ".join(sym_render(d) for d in out.dims) + "]"
        self.findings.append(Finding(
            path=self.path, line=node.lineno, rule=DENSIFY_RULE,
            message=f"intermediate of shape {shape} is O(N^{out_deg}) but "
                    f"every input is O(N^{max(in_degs, default=0)}): it "
                    "fits at 100k and not at the 1M point",
            hint="restructure as gathers/scatters over [N, const] "
                 "tables, or suppress with a reason if the dense form "
                 "is deliberate",
        ))


# --- the interpreted inventory --------------------------------------------


def _flatten(val, prefix: str, out: Dict[str, LeafShape]) -> None:
    if isinstance(val, StructVal):
        for f in val.field_order:
            _flatten(val.fields.get(f), f"{prefix}.{f}" if prefix else f,
                     out)
        return
    if isinstance(val, TupleVal):
        for i, v in enumerate(val.elements):
            _flatten(v, f"{prefix}[{i}]", out)
        return
    name = prefix or "<leaf>"
    if isinstance(val, ArrayVal) and val.known():
        path, line = val.site or ("", 0)
        # the audit's name for the stored dtype (Book.seen: int32 bits
        # named uint32, as obs/memory.py names it)
        dtype = STORED_DTYPES.get(name.rsplit(".", 1)[-1]) or val.dtype
        out[name] = LeafShape(name, val.dims, dtype, path, line)
    else:
        out[name] = LeafShape(name, None, None)


def build_inventory(project: Project, root: str,
                    config: Optional[ConfigVal] = None) -> Optional[
                        Inventory]:
    """Interpret ``<root>.create(cfg)`` symbolically over the project's own
    ASTs. None when the root class (or its ``create``) is not in the
    walked set."""
    config = config or ConfigVal.default()
    ctx = ShapeContext(project, config)
    info = ctx.classes.get(root)
    if info is None:
        return None
    creates = [c for c in project.methods.get((root, "create"), [])
               if c.module is info.module]
    if not creates:
        return None
    fn = creates[0]
    driver = ShapeAnalysis(ctx, fn, fn.path)
    result = driver._call_fn(fn, fn.node, [config], {})
    leaves: Dict[str, LeafShape] = {}
    _flatten(result, "", leaves)
    if not isinstance(result, StructVal):
        leaves = {"<root>": LeafShape("<root>", None, None)}
    return Inventory(root, leaves, dict(config.bindings),
                     dict(config.flags))


#: the sim/ops files whose ASTs define the state schema
STATE_FILES = (
    "sim/scale.py", "sim/scale_step.py", "sim/broadcast.py",
    "sim/step.py", "sim/swim.py", "sim/transport.py",
    "ops/versions.py", "ops/partials.py",
)


def state_project() -> Project:
    """Parse the package's state-schema files into a Project (no torch
    import, no bytecode execution)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    modules = []
    for rel in STATE_FILES:
        path = os.path.join(pkg, rel)
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        modules.append(ModuleInfo(
            path=path, name=module_name_for(path), tree=ast.parse(source),
            source=source, suppressions={}, bad_suppressions=[],
        ))
    return Project(modules)


def interpreted_inventory(cfg=None, mode: str = "scale") -> Inventory:
    """The inventory of ``cfg``'s state (the flagship defaults when
    omitted) read from the constructors' source; a test holds it equal to
    :func:`static_inventory`, leaf for leaf."""
    config = ConfigVal.from_config(cfg) if cfg is not None else (
        ConfigVal.default())
    if mode not in ROOTS:
        raise ValueError(f"unknown mode {mode!r}; want one of {sorted(ROOTS)}")
    root = ROOTS[mode][0]
    inv = build_inventory(state_project(), root, config)
    if inv is None:
        raise RuntimeError(f"state root {root!r} not found in {STATE_FILES}")
    return inv


# --- densify --------------------------------------------------------------

#: full-view modules where O(N^2) planes are the design (sim/swim.py's
#: [N, N] view; sim/step.py drives it): densify patrols the scale-capable
#: surfaces only
_DENSIFY_EXCLUDE = ("/sim/step.py", "/sim/swim.py")


def densify_in_scope(path: str) -> bool:
    p = os.path.abspath(path)
    if not os.path.exists(p):
        return True  # fixture / bare source blob
    norm = p.replace("\\", "/")
    if any(norm.endswith(x) for x in _DENSIFY_EXCLUDE):
        return False
    return "/sim/" in norm or "/ops/" in norm


#: annotation name suffix -> treat the parameter as a config
_CONFIG_ANNOTATIONS = ("Config",)


def _seed_param(ctx: ShapeContext, name: str, annotation: Optional[str],
                findings: List[Finding], default: Optional[ast.AST] = None):
    """Abstract value for a function parameter in densify mode: configs
    become :class:`ConfigVal`, annotated state types their create-derived
    StructVal, extent-named ints their symbol, and an unannotated
    parameter that defaults to ``None`` that default (the function is read
    on its default path)."""
    if default is not None and isinstance(default, ast.Constant) and (
            default.value is None) and not annotation:
        return NONE
    if name == "cfg" or (annotation or "").endswith(_CONFIG_ANNOTATIONS):
        return ctx.config
    if annotation and annotation in ctx.classes:
        if annotation not in ctx.struct_cache:
            ctx.struct_cache[annotation] = _class_struct(ctx, annotation,
                                                         findings)
        return ctx.struct_cache[annotation]
    if name in SYMBOLS:
        return Poly.var(SYMBOLS[name])
    return None


def _class_struct(ctx: ShapeContext, cls_name: str,
                  findings: List[Finding]):
    info = ctx.classes.get(cls_name)
    creates = [c for c in ctx.project.methods.get((cls_name, "create"), [])
               if info is not None and c.module is info.module]
    if not creates:
        return None
    fn = creates[0]
    a = fn.node.args
    params = [p.arg for p in a.posonlyargs + a.args]
    args = []
    for pname in params:
        if pname == "cfg":
            args.append(ctx.config)
        elif pname in SYMBOLS:
            args.append(Poly.var(SYMBOLS[pname]))
        else:
            args.append(None)
    driver = ShapeAnalysis(ctx, fn, fn.path, findings)
    return driver._call_fn(fn, fn.node, args, {})


def check_densify(project: Project) -> List[Finding]:
    """``densify``: walk every scale-path function with shape-seeded
    parameters and flag provably superlinear intermediates."""
    findings: List[Finding] = []
    ctx = ShapeContext(project, ConfigVal.default(),
                       interprocedural=False)
    for fn in project.iter_functions():
        if not densify_in_scope(fn.path):
            continue
        a = fn.node.args
        env: Env = {}
        positional = a.posonlyargs + a.args
        defaults = dict(zip([p.arg for p in positional][
            len(positional) - len(a.defaults):], a.defaults))
        defaults.update({k.arg: d for k, d in zip(a.kwonlyargs, a.kw_defaults)})
        for p in positional + a.kwonlyargs:
            ann = ""
            if p.annotation is not None:
                ann = dotted_name(p.annotation).rsplit(".", 1)[-1] or (
                    p.annotation.value
                    if isinstance(p.annotation, ast.Constant)
                    and isinstance(p.annotation.value, str) else "")
            env[p.arg] = _seed_param(ctx, p.arg, ann or None, [],
                                     defaults.get(p.arg))
        analysis = ShapeAnalysis(ctx, fn, fn.path, findings,
                                 densify=True)
        analysis.run(list(fn.node.body), env)
    return findings
