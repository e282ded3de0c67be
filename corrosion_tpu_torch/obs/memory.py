"""Memory accounting: per-table bytes audit of the simulator state (port
of ``corrosion_tpu/obs/memory.py``).

The audit walks the state by field name (``swim.mem_id``, ``crdt.q_val``,
``crdt.store[1]`` ...), records each leaf's shape, dtype and bytes, and
classifies its scaling against the cluster size. It reads tensor metadata
only (``numel() * element_size()``), so auditing a state on the card moves
no device bytes; numpy leaves (a host copy) count their ``nbytes``.
Exposed as the ``corro.mem.*`` gauges (:func:`publish_memory_gauges`),
the agent's ``/v1/obs/memory`` route and the ``mem-report`` command. The
per-table audit sums to the total state size.

The audit has a static twin: :func:`static_report` projects the same
tables to any (N, M) from the symbolic inventory of
``analysis/shapes.py`` (built on the ``meta`` device, no storage), for
``mem-report --project`` and :func:`projected_bytes`. Both planes classify
leaves through the one :func:`classify_leaf` and name dtypes through
:func:`leaf_dtype_name`.
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


#: leaves whose tensor holds another dtype's bit patterns, by field name:
#: the Book's seen window is int32 in the port and uint32 in the JAX
#: package, and the audit names the dtype it stores
STORED_DTYPES = {"seen": "uint32"}


def leaf_dtype_name(leaf, name: str = "") -> str:
    """The dtype an audit names for ``leaf`` at path ``name``."""
    stored = STORED_DTYPES.get(name.rsplit(".", 1)[-1])
    return stored or str(getattr(leaf, "dtype", "?")).removeprefix("torch.")


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
            "dtype": leaf_dtype_name(leaf, name),
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


def static_report(cfg, mode: str = "scale", n_nodes: Optional[int] = None,
                  m_slots: Optional[int] = None) -> dict:
    """The static projection of the state audit: the symbolic inventory of
    ``cfg``'s state (``analysis/shapes.py``) evaluated at the config's
    extents, with N (and M) rebound when given. :func:`memory_report`'s
    schema plus each leaf's ``symbolic`` shape and the ``unresolved``,
    ``source``, ``root`` and ``mode`` keys; no tensor is given storage."""
    from corrosion_tpu_torch.analysis import shapes

    inv = shapes.static_inventory(cfg, mode=mode)
    overrides = {}
    if n_nodes:
        overrides["N"] = int(n_nodes)
    if m_slots:
        overrides["M"] = int(m_slots)
    report = inv.report(overrides)
    report["mode"] = mode
    return report


def projected_bytes(cfg, n_nodes: int, mode: str = "scale") -> int:
    """Projected bytes of one state replica of ``cfg``'s family at
    ``n_nodes``. A leaf the inventory cannot attribute raises: a single
    number has no ``unresolved`` field to show the undercount in."""
    report = static_report(cfg, mode=mode, n_nodes=n_nodes)
    if report.get("unresolved"):
        raise ValueError(
            "static projection has unpriceable leaves "
            f"{report['unresolved']}; the total would silently undercount"
        )
    return int(report["total_bytes"])


def mem_report_cli(args) -> int:
    """``mem-report``: build the configured state on ``--device`` (default
    ``cuda``) and print its audit as JSON; with ``--project N[,M]`` print
    the static projection at that point instead, building nothing."""
    import json

    from corrosion_tpu_torch.config import Config, load_config

    cfg_file = load_config(args.config) if args.config else Config()
    if args.n_nodes:
        cfg_file.sim.n_nodes = args.n_nodes
    cfg = cfg_file.sim_config()
    mode = cfg_file.sim.mode
    if getattr(args, "project", None):
        parts = [int(p) for p in str(args.project).split(",") if p]
        report = static_report(cfg, mode=mode, n_nodes=parts[0],
                               m_slots=parts[1] if len(parts) > 1 else None)
        print(json.dumps(report, indent=2))
        return 0
    from corrosion_tpu_torch._device import resolve_device

    dev = resolve_device(getattr(args, "device", "cuda"))
    if mode == "scale":
        from corrosion_tpu_torch.sim.scale_step import ScaleSimState

        state = ScaleSimState.create(cfg, dev)
    else:
        from corrosion_tpu_torch.sim.step import SimState

        state = SimState.create(cfg, device=dev)
    report = memory_report(state, cfg.n_nodes)
    report["mode"] = mode
    print(json.dumps(report, indent=2))
    return 0
