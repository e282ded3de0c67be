"""corrobudget for the port: the state's symbolic shape inventory, read
from the ``meta`` device (port of ``corrosion_tpu/analysis/shapes.py``'s
inventory and budget; its AST interpreter is not ported).

The JAX package derives each state leaf's symbolic shape by interpreting
the state constructors' source. The port builds the state instead, on the
``meta`` device, where a tensor has a shape and a dtype and no storage, so
a 1M-node state costs nothing. Which config extent each dim follows is
found by rebinding one config field at a time and building again:

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
declared 1M budget and :func:`check_budget` its gate of record (a test,
not a lint rule).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

from corrosion_tpu_torch.obs.memory import _walk_leaves, classify_leaf, leaf_dtype_name

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


@dataclasses.dataclass(frozen=True)
class Dim:
    """One symbolic dim: its rendering, its value at a binding, and the
    symbols it grows with (constants grow with none)."""

    text: str
    value: Callable[[Dict[str, int]], int]
    symbols: Tuple[str, ...] = ()

    def evaluate(self, env: Dict[str, int]) -> int:
        return int(self.value(env))

    def degree(self, sym: str) -> int:
        return int(sym in self.symbols)


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
    name: str
    dims: Optional[Tuple[Dim, ...]]  # None = unresolved
    dtype: Optional[str]

    def shape_str(self) -> str:
        if self.dims is None:
            return "?"
        return "[" + ", ".join(d.text for d in self.dims) + "]"

    def shape_at(self, bindings: Dict[str, int]) -> Optional[Tuple[int, ...]]:
        if self.dims is None:
            return None
        return tuple(d.evaluate(bindings) for d in self.dims)

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
