"""sharding-contract: sharded state stays on the mesh (port of
``corrosion_tpu/analysis/sharding.py``).

A mesh run (``parallel/mesh.py``) holds the state as a
:class:`~corrosion_tpu_torch.parallel.mesh.ShardedTree`, each shard's rows
on its own device; two cross-function mistakes silently collapse that:

- **shard-gather** — host-materializing sharded state. A ``.cpu()``,
  ``.numpy()``, ``np.asarray`` or ``ShardedTree.assemble`` on a value
  that derives from the sharded mesh entry points funnels the whole
  working set through one host (or one device), doubling its memory and
  serializing the drain — the failure mode the per-shard checkpoint
  pipeline (``parallel.mesh.host_shard_copy``) exists to avoid. Flagged
  **at the call site** when tainted state flows into a materializer —
  including a helper that materializes its argument somewhere down the
  call graph (the interprocedural part) — and **at the definition** of
  any whole-tree drain (a tree map of a materializer, or ``[np.asarray(x)
  for x in tree_leaves(tree)]``) outside the :data:`DRAIN_REGISTRY`.
- **shard-spec-drift** — passing freshly built (never placed) state into
  a sharded entry point's state slot. The entry point places it itself,
  so the run still works, but the caller holds a whole unplaced copy
  beside the placed one and re-pays the placement on every call. Values
  of unknown origin (parameters, loads) never flag; only a provably
  fresh build (``*.create(...)``, ``make_soak_inputs``) flowing in
  unplaced does.

Taint sources are the registries below (the ``parallel/mesh.py``
surfaces); propagation runs on :mod:`.dataflow` with union-join, so a
value that MAY be sharded on one branch keeps the taint, while a
maybe-placed value never raises spec-drift.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, FrozenSet, List, Tuple

from corrosion_tpu_torch.analysis.base import Finding, dotted_name
from corrosion_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    Project,
    fixpoint,
)
from corrosion_tpu_torch.analysis.dataflow import Env, ForwardAnalysis, TupleVal

RULE_GATHER = "shard-gather"
RULE_DRIFT = "shard-spec-drift"

#: sharded mesh entry points: positions that must receive PLACED state
#: (st, net, inputs — the key is a small host tensor and may come from
#: anywhere)
SHARDED_STATE_PARAMS: Dict[str, Tuple[int, ...]] = {
    "sharded_step": (2, 3, 5),
    "sharded_run": (2, 3, 5),
    "sharded_scale_run": (2, 3, 5),
    "sharded_scale_run_carry": (2, 3, 5),
}


def _sharded_returns() -> Dict[str, Any]:
    """Entry point -> abstract return shape with the sharded paths marked
    (the :class:`ShardedTree` rides exactly these outputs)."""
    S = frozenset({"sharded"})
    return {
        "shard_state": S,  # the whole result is placed
        "sharded_step": TupleVal((S, None)),
        "sharded_run": TupleVal((S, None)),
        "sharded_scale_run": TupleVal((S, None)),
        # ((st, key), infos): st is the sharded carry; the key is a small
        # host tensor — reading it back is not a gather
        "sharded_scale_run_carry": TupleVal((TupleVal((S, None)), None)),
    }


#: call names whose RESULT is freshly built, never-placed state
FRESH_FACTORIES = {"create", "make_soak_inputs", "make_write_inputs", "quiet"}

#: direct host materializers (dotted and bare forms)
MATERIALIZERS = {
    "np.array", "np.asarray", "numpy.array", "numpy.asarray", "float", "int",
}
#: methods that materialize their receiver: on the host (``.item()``,
#: ``.tolist()``, ``.cpu()``, ``.numpy()``) or whole on one device
#: (``ShardedTree.assemble``); ``.to("cpu")`` is matched by its argument
MATERIALIZER_METHODS = {"item", "tolist", "cpu", "numpy", "assemble"}
#: tensor methods whose result is the receiver's data, where it was
#: (``x.detach().cpu()`` is a drain of ``x``)
PASS_THROUGH_METHODS = {"detach", "clone", "contiguous", "to"}

#: functions whose whole-tree drain is sanctioned. Every entry carries its
#: reason; anything else doing a tree-wide materialization is a finding.
DRAIN_REGISTRY: Dict[str, str] = {
    # the per-shard drain: each shard's rows become an owned host copy
    # of their own — the sanctioned replacement for a whole-tree gather
    "host_shard_copy": "per-shard slice drain: owned host copies of each "
                       "shard's rows, no whole-tree intermediate",
    # checkpoint serialization: writes host-staged shard slices (a mesh
    # soak) or drains the SINGLE-DEVICE agent state whole-leaf
    "save_checkpoint": "serializes host-staged shard slices (soak) or the "
                       "single-device agent state for the crash-consistent "
                       "commit path",
    # save_checkpoint's whole-leaf helper for shards=None saves: drains
    # a SINGLE-DEVICE state (the sharded soak stages HostLeafShards and
    # never reaches it)
    "host_arrays": "whole-leaf drain of a single-device state when no "
                   "per-shard drain was staged (shards=None saves)",
    # checkpoint and backup readers take an owned host copy of the live
    # round's state under the agent's state lease (single-device serving
    # path, never a mesh)
    "device_state": "owned host copy of the Agent's single-device state "
                    "under its state lease",
    # the chaos harness's oracles: a mesh scenario's final state is held
    # to the uninterrupted reference and settled on one device (the
    # scenarios run at tens of nodes)
    "_on_one_device": "the chaos oracles compare and settle a mesh "
                      "scenario's final state whole on one device",
}


def _tags(value: Any) -> FrozenSet:
    """Every tag reachable in a (possibly tuple-nested) value."""
    if isinstance(value, frozenset):
        return value
    if isinstance(value, TupleVal):
        out: FrozenSet = frozenset()
        for el in value.elements:
            out = out | _tags(el)
        return out
    return frozenset()


def _strip_params(value: Any) -> Any:
    """Return-summary hygiene: a callee's param tags must not leak into
    its caller's environment — but "sharded"/"fresh" are global facts
    that DO travel (a factory helper wrapping ``create()`` still returns
    never-placed state)."""
    if isinstance(value, frozenset):
        kept = frozenset(t for t in value if t in ("sharded", "fresh"))
        return kept or None
    if isinstance(value, TupleVal):
        return TupleVal(_strip_params(el) for el in value.elements)
    return None


def _is_materializer_call(node: ast.AST) -> bool:
    """``np.array(a)`` or ``a.cpu()``-shaped call?"""
    if not isinstance(node, ast.Call):
        return False
    if dotted_name(node.func) in MATERIALIZERS:
        return True
    return isinstance(node.func, ast.Attribute) and (
        node.func.attr in MATERIALIZER_METHODS or _to_host(node))


def _to_host(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``?"""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    values = list(node.args) + [kw.value for kw in node.keywords
                                if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and isinstance(v.value, str)
               and v.value.startswith("cpu") for v in values)


def _lambda_materializes(node: ast.AST) -> bool:
    """``lambda a: np.array(a)``-shaped materializer?"""
    if not isinstance(node, ast.Lambda):
        return dotted_name(node) in MATERIALIZERS
    return any(_is_materializer_call(sub) for sub in ast.walk(node.body))


def _is_tree_map(name: str) -> bool:
    return name.endswith("tree_map") or name.endswith("tree.map")


def _is_leaves(name: str) -> bool:
    return name.endswith("tree_leaves") or name.endswith(
        "tree.leaves") or name.endswith("_leaves")


class _Analysis(ForwardAnalysis):
    """One function: taint propagation + gather/drift sinks.

    ``summaries`` maps qualname -> (gathered param indices, return
    value); during the summary fixpoint ``collect`` is False and no
    findings are emitted."""

    def __init__(self, fn: FunctionInfo, project: Project,
                 summaries: Dict[str, tuple], collect: bool,
                 findings: List[Finding]):
        super().__init__(fn, fn.path, findings)
        self.project = project
        self.summaries = summaries
        self.collect = collect
        self.gathered_params: set = set()
        self.returns_table = _sharded_returns()

    # -- environment -------------------------------------------------------

    def initial_env(self) -> Env:
        return {
            name: frozenset({("param", i)})
            for i, name in enumerate(self.fn.param_names())
        }

    def join(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        if isinstance(a, TupleVal) or isinstance(b, TupleVal):
            if (isinstance(a, TupleVal) and isinstance(b, TupleVal)
                    and len(a.elements) == len(b.elements)):
                return TupleVal(self.join(x, y)
                                for x, y in zip(a.elements, b.elements))
            return _tags(a) | _tags(b) or None
        return a | b

    #: static metadata reads — host facts, not device data; taint ends
    _META_ATTRS = {"shape", "ndim", "dtype", "device", "nbytes", "itemsize",
                   "mesh", "dims", "n_nodes", "bounds"}

    def eval_attr(self, node, base, env):
        # attribute reads keep taint: st.crdt of sharded st is sharded
        # — but metadata like .shape/.dtype never moves device bytes,
        # so `int(st.crdt.shape[0])` must not read as a gather
        if node.attr in self._META_ATTRS:
            return None
        return _tags(base) or None

    def eval_subscript(self, node, base, env):
        picked = super().eval_subscript(node, base, env)
        if picked is not None:
            return picked
        return _tags(base) or None

    def eval_binop(self, node, left, right, env):
        return (_tags(left) | _tags(right)) or None

    # -- calls -------------------------------------------------------------

    def _flag(self, node: ast.AST, rule: str, message: str,
              hint: str) -> None:
        if self.collect:
            self.findings.append(Finding(
                path=self.path, line=node.lineno, rule=rule,
                message=message, hint=hint))

    def _note_gather(self, node: ast.AST, value: Any, what: str) -> None:
        tags = _tags(value)
        for tag in tags:
            if isinstance(tag, tuple) and tag[0] == "param":
                self.gathered_params.add(tag[1])
        if "sharded" in tags:
            self._flag(
                node, RULE_GATHER,
                f"node-sharded state is host-materialized by {what}",
                hint="keep the drain per-shard (or route through the "
                     "sharding drain registry with a reason)",
            )

    def eval_call(self, node, env, args, keywords):
        name = dotted_name(node.func)
        last = name.rsplit(".", 1)[-1]

        # whole-tree drain shape: tree_map(materializer, X)
        if _is_tree_map(name) and node.args and _lambda_materializes(
                node.args[0]):
            if self.fn.name not in DRAIN_REGISTRY:
                self._flag(
                    node, RULE_GATHER,
                    f"`{self.fn.name}` funnels a whole pytree through "
                    "the host (tree-wide materialization)",
                    hint="drain per shard, or register the function in "
                         "sharding.DRAIN_REGISTRY with a reason",
                )
            for value in args[1:]:
                self._note_gather(node, value, f"{name}(...)")

        # direct materializer
        if name in MATERIALIZERS:
            for value in args:
                self._note_gather(node, value, f"{name}()")
            return None
        if isinstance(node.func, ast.Attribute) and (
                node.func.attr in MATERIALIZER_METHODS or _to_host(node)):
            self._note_gather(node, self.eval_expr(node.func.value, env),
                              f".{node.func.attr}()")
            return None

        if isinstance(node.func, ast.Attribute) and (
                node.func.attr in PASS_THROUGH_METHODS):
            return _tags(self.eval_expr(node.func.value, env)) or None

        # sharded entry points: spec-drift sink + tainted returns
        if last in SHARDED_STATE_PARAMS:
            for pos in SHARDED_STATE_PARAMS[last]:
                if pos < len(args) and "fresh" in _tags(args[pos]) and (
                        "sharded" not in _tags(args[pos])):
                    self._flag(
                        node, RULE_DRIFT,
                        f"freshly-built state reaches `{last}` arg "
                        f"{pos} without `shard_state` placement — every "
                        "call places a whole unplaced copy again",
                        hint="place it with parallel.mesh.shard_state("
                             "mesh, n_nodes, ...) first",
                    )
            return self.returns_table.get(last)
        if last in self.returns_table:
            return self.returns_table[last]

        if last in FRESH_FACTORIES:
            return frozenset({"fresh"})

        # interprocedural: a callee that gathers one of its params
        resolved = self.project.resolve_call(node, self.fn)
        if resolved is not None:
            summary = self.summaries.get(resolved.qualname)
            if summary:
                gathers, returns = summary
                # a method's param 0 is its receiver; call-site args
                # start at param 1
                params = resolved.param_names()
                offset = 1 if (resolved.cls is not None and params
                               and params[0] == "self") else 0
                if resolved.name not in DRAIN_REGISTRY:
                    for raw in gathers:
                        i = raw - offset
                        if not 0 <= i < len(args):
                            continue
                        tags = _tags(args[i])
                        # transitive summary: OUR param flowing into a
                        # gathering callee makes US a gatherer too, so
                        # two-hop drains flag at the outermost call
                        for tag in tags:
                            if isinstance(tag, tuple) and (
                                    tag[0] == "param"):
                                self.gathered_params.add(tag[1])
                        if "sharded" in tags:
                            self._flag(
                                node, RULE_GATHER,
                                f"node-sharded state is passed to "
                                f"`{resolved.name}()` which "
                                "host-materializes it "
                                f"({resolved.path.rsplit('/', 1)[-1]})",
                                hint="drain per shard, or register the "
                                     "callee in sharding.DRAIN_REGISTRY "
                                     "with a reason",
                            )
                return returns
        return None


def _comprehension_drains(fn: FunctionInfo) -> List[ast.AST]:
    """``[np.asarray(x) for x in tree_leaves(state)]``-shaped whole-tree
    drains."""
    out: List[ast.AST] = []
    for sub in ast.walk(fn.node):
        if not isinstance(sub, (ast.ListComp, ast.GeneratorExp)):
            continue
        if not (sub.generators and isinstance(
                sub.generators[0].iter, ast.Call) and _is_leaves(
                dotted_name(sub.generators[0].iter.func))):
            continue
        if any(_is_materializer_call(part) for part in ast.walk(sub.elt)):
            out.append(sub)
    return out


def _summarize(fn: FunctionInfo, project: Project,
               summaries: Dict[str, tuple]) -> tuple:
    run = _Analysis(fn, project, summaries, collect=False, findings=[])
    try:
        ret = run.analyze()
    except RecursionError:  # pragma: no cover - pathological nesting
        return (frozenset(), None)
    return (frozenset(run.gathered_params), _strip_params(ret))


def check_project(project: Project) -> List[Finding]:
    summaries = fixpoint(
        project, lambda fn, s: _summarize(fn, project, s))
    findings: List[Finding] = []
    for fn in project.iter_functions():
        _Analysis(fn, project, summaries, collect=True,
                  findings=findings).analyze()
        if fn.name in DRAIN_REGISTRY:
            continue
        for site in _comprehension_drains(fn):
            findings.append(Finding(
                path=fn.path, line=site.lineno, rule=RULE_GATHER,
                message=f"`{fn.name}` materializes every pytree leaf "
                        "on the host (leaves-comprehension drain)",
                hint="drain per shard, or register the function in "
                     "sharding.DRAIN_REGISTRY with a reason",
            ))
    return findings
