"""Memory accounting: per-table bytes audit of the simulator state (port
of ``corrosion_tpu/obs/memory.py``).

The audit walks the state by field name (``swim.mem_id``, ``crdt.q_val``,
``crdt.store[1]`` ...), records each leaf's shape, dtype and bytes, and
classifies its scaling against the cluster size. It reads tensor metadata
only (``numel() * element_size()``), so auditing a state on the card moves
no device bytes; numpy leaves (a host copy) count their ``nbytes``.
Exposed as the ``corro.mem.*`` gauges (:func:`publish_memory_gauges`) and
the agent's ``/v1/obs/memory`` route. The per-table audit sums to the
total state size.

The JAX package's static projection (``static_report``,
``projected_bytes``) needs its symbolic shape inventory and is not ported.
"""

from __future__ import annotations

import math
from typing import Optional


def _walk_leaves(obj, prefix: str, out: dict) -> None:
    """NamedTuple-aware named walk: ``swim.mem_id``, ``crdt.store[1]``."""
    if hasattr(obj, "_fields"):
        for f in obj._fields:
            _walk_leaves(getattr(obj, f), f"{prefix}.{f}" if prefix else f, out)
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            _walk_leaves(v, f"{prefix}[{i}]", out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _walk_leaves(obj[k], f"{prefix}.{k}" if prefix else str(k), out)
    elif obj is not None:
        out[prefix or "<leaf>"] = obj


def classify_leaf(shape, n_nodes: Optional[int]) -> str:
    """Scaling class against the cluster size: the leading axis of every
    per-node table is N, so ``[N]`` is O(N), ``[N, ...]`` is O(N·M) (M =
    the trailing extent), anything else is O(1) bookkeeping."""
    if not n_nodes or not shape or shape[0] != n_nodes:
        return "O(1)"
    return "O(N)" if math.prod(shape[1:]) == 1 else "O(N*M)"


def _nbytes(leaf) -> int:
    """Bytes of a tensor (``numel * element_size``) or a numpy array."""
    if hasattr(leaf, "element_size"):
        return int(leaf.numel() * leaf.element_size())
    return int(getattr(leaf, "nbytes", 0))


def _dtype_name(leaf) -> str:
    return str(getattr(leaf, "dtype", "?")).removeprefix("torch.")


def state_bytes(state) -> int:
    """Total bytes of every leaf, from metadata only."""
    leaves: dict = {}
    _walk_leaves(state, "", leaves)
    return sum(_nbytes(leaf) for leaf in leaves.values())


def memory_report(state, n_nodes: Optional[int] = None) -> dict:
    """Per-table audit of a state.

    Returns ``{"total_bytes", "n_nodes", "tables": {name: {"shape",
    "dtype", "nbytes", "class", "per_node_bytes"}}, "by_class": {cls:
    bytes}}``; ``per_node_bytes`` (O(N) and O(N·M) tables only) is what
    the total scales by with N."""
    leaves: dict = {}
    _walk_leaves(state, "", leaves)
    tables = {}
    by_class: dict = {}
    total = 0
    for name, leaf in leaves.items():
        shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
        nbytes = _nbytes(leaf)
        cls = classify_leaf(shape, n_nodes)
        entry = {
            "shape": list(shape),
            "dtype": _dtype_name(leaf),
            "nbytes": nbytes,
            "class": cls,
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
    }


def publish_memory_gauges(report: dict, registry) -> None:
    """Fold an audit into ``corro.mem.*`` gauges: the total, one gauge per
    table (labelled), and the per-class rollup."""
    registry.gauge("corro.mem.state.bytes", report["total_bytes"])
    for name, entry in report["tables"].items():
        registry.gauge("corro.mem.table.bytes", entry["nbytes"],
                       labels={"table": name, "class": entry["class"]})
    for cls, nbytes in report["by_class"].items():
        registry.gauge("corro.mem.class.bytes", nbytes, labels={"class": cls})
