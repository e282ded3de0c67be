"""Shard the simulator's rounds over a mesh of devices along the node axis
(port of ``corrosion_tpu/parallel/mesh.py``).

The JAX package annotates the node axis of every state plane with a
``NamedSharding`` and lets XLA insert the collectives. The port is
single-controller in the same way: one process drives every shard, one
worker thread per shard, each running the unchanged round
(``scale_run_rounds_carry(..., axis=)``) on its own rows ``[lo, hi)`` on
its own device; the cross-node traffic is written out as the explicit
exchanges of :mod:`.exchange`. A mesh may repeat a device: on one card,
``make_mesh(["cuda:0"] * 4)`` runs four shards there, as the JAX package
proves its mesh on one CPU split into eight virtual devices.

A placed tree (:class:`ShardedTree`) holds one tree per shard: every leaf
whose leading axis is the node axis holds that shard's rows (stacked
round inputs: axis 1), every other leaf a copy. A multihost ``(dcn,
node)`` mesh shards the node axis over both mesh axes jointly, as
contiguous blocks in host-major device order.

The checkpoint pipeline drains a placed carry per shard
(:func:`host_shard_copy`), records where each slice lives
(:class:`HostLeafShards`, the manifest's ``mesh`` from
:func:`drained_mesh_meta`), and restores the slices onto whatever mesh the
resuming process has (:func:`elastic_sharding`).

The full view's round (``sharded_step``, ``sharded_run``) runs on the mesh
the same way: ``sim.step.sim_step(..., axis=)`` on every shard, its
``[N, N]`` planes sharded by rows.

Not here: ``buffers_donated`` (the port donates nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.parallel.exchange import ShardGroup, shard_bounds

NODE_AXIS = "node"
DCN_AXIS = "dcn"


class Mesh:
    """Devices laid out on named axes (``jax.sharding.Mesh``'s shape):
    ``devices`` is an object array of ``torch.device``, ``axis_names``
    names its axes. A device may repeat (several shards on one card)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes {self.axis_names}")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> List[torch.device]:
        """The shards' devices in host-major order (shard i's is item i)."""
        return list(self.devices.reshape(-1))

    def meta(self) -> dict:
        """The manifest's JSON record of the mesh (the JAX package's)."""
        return {"axis_names": list(self.axis_names),
                "shape": [int(s) for s in self.devices.shape]}


def _device_list(devices) -> List[torch.device]:
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            resolve_device("cuda")  # raises: no card
        devices = [f"cuda:{i}" for i in range(count)]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        out.append(dev)
    return out


def _object_array(items: list) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    arr[:] = items
    return arr


def make_mesh(devices=None) -> Mesh:
    """A 1-D mesh over the node axis (default: every visible card)."""
    return Mesh(_object_array(_device_list(devices)), (NODE_AXIS,))


def make_multihost_mesh(n_hosts: int, devices=None) -> Mesh:
    """A 2-D ``(dcn, node)`` mesh: the outer axis spans hosts, the inner
    each host's devices; the node axis shards over both jointly, so
    contiguous node blocks stay on one host."""
    devs = _device_list(devices)
    if n_hosts <= 0 or len(devs) % n_hosts != 0:
        raise ValueError(
            f"{len(devs)} devices do not split over {n_hosts} hosts"
        )
    return Mesh(_object_array(devs).reshape(n_hosts, -1), (DCN_AXIS, NODE_AXIS))


def _joint_node_axis(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the node dimension shards over (manifest record)."""
    return (DCN_AXIS, NODE_AXIS) if DCN_AXIS in mesh.axis_names else (NODE_AXIS,)


def node_sharding(mesh: Mesh, n_nodes: int, stacked: bool = False):
    """-> ``spec(x)``: the dimension of ``x`` that shards over the node
    axis (0 when the leading dimension is the node axis, 1 for stacked
    round inputs ``[rounds, N, ...]``), or None (replicated). With
    ``stacked`` the leading dimension is rounds whatever its size (JAX's
    rule only places; here the placement is what each shard computes on,
    so a run of N rounds must not shard its rounds)."""
    del mesh  # every mesh shards the one node axis

    def spec(x) -> Optional[int]:
        shape = tuple(x.shape)
        if not stacked and len(shape) >= 1 and shape[0] == n_nodes:
            return 0
        if len(shape) >= 2 and shape[1] == n_nodes:
            return 1
        return None

    return spec


# --- trees -----------------------------------------------------------------
# A state, net or input tree is a NamedTuple whose fields are tensors,
# nested NamedTuples, or plain tuples of tensors (the store planes); a bare
# tensor is a tree of one leaf.


def _is_node(t) -> bool:
    return isinstance(t, tuple)


def tree_leaves(tree) -> list:
    if _is_node(tree):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_rebuild(template, leaves) -> Any:
    """``template``'s structure with ``leaves`` (an iterable, in order)."""
    it = iter(leaves)

    def build(t):
        if _is_node(t):
            fields = [build(v) for v in t]
            return type(t)(*fields) if hasattr(t, "_fields") else tuple(fields)
        return next(it)

    return build(template)


class ShardedTree:
    """A tree placed on ``mesh`` along the node axis: ``parts[i]`` is shard
    i's tree, on its device; ``dims[j]`` is flat leaf j's node dimension
    (None: every shard holds a copy)."""

    def __init__(self, mesh: Mesh, n_nodes: int, parts: list, dims: list):
        self.mesh, self.n_nodes = mesh, int(n_nodes)
        self.parts, self.dims = list(parts), list(dims)

    @property
    def bounds(self) -> list:
        return shard_bounds(self.n_nodes, self.mesh.size)

    def assemble(self, device="cpu") -> Any:
        """The whole tree on one device (the shards' rows concatenated)."""
        dev = torch.device(device)
        per_shard = [tree_leaves(p) for p in self.parts]
        leaves = []
        for j, dim in enumerate(self.dims):
            if dim is None:
                leaves.append(per_shard[0][j].to(dev, copy=True))
            else:
                leaves.append(torch.cat([s[j].to(dev) for s in per_shard], dim=dim))
        return tree_rebuild(self.parts[0], leaves)

    def meta_tree(self) -> Any:
        """The whole tree's shapes and dtypes on the ``meta`` device (for
        a memory report; nothing is copied)."""
        per_shard = [tree_leaves(p) for p in self.parts]
        leaves = []
        for j, dim in enumerate(self.dims):
            t = per_shard[0][j]
            shape = list(t.shape)
            if dim is not None:
                shape[dim] = sum(int(s[j].shape[dim]) for s in per_shard)
            leaves.append(torch.empty(shape, dtype=t.dtype, device="meta"))
        return tree_rebuild(self.parts[0], leaves)

    def map(self, fn) -> "ShardedTree":
        """Apply ``fn(shard_tree, rank)`` to every shard's tree."""
        return ShardedTree(self.mesh, self.n_nodes,
                           [fn(p, i) for i, p in enumerate(self.parts)], self.dims)


def _place(mesh: Mesh, n_nodes: int, leaves: list, dims: list, template) -> ShardedTree:
    devices = mesh.flat_devices()
    bounds = shard_bounds(n_nodes, len(devices))
    parts = []
    for dev, (lo, hi) in zip(devices, bounds):
        shard = []
        for leaf, dim in zip(leaves, dims):
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(np.array(leaf, copy=True))
            if dim is not None:
                leaf = leaf.narrow(dim, lo, hi - lo)
            # an owned copy: no shard aliases another's rows or the caller's
            shard.append(leaf.to(dev, copy=True).contiguous())
        parts.append(tree_rebuild(template, shard))
    return ShardedTree(mesh, n_nodes, parts, dims)


def _stacked_inputs(tree) -> bool:
    """Stacked round inputs (``ScaleRoundInput`` with a rounds axis)."""
    kill = getattr(tree, "kill", None)
    return isinstance(kill, torch.Tensor) and kill.dim() == 2


def shard_state(mesh: Mesh, n_nodes: int, tree: Any) -> ShardedTree:
    """Place a tree on ``mesh`` by the :func:`node_sharding` rule (stacked
    round inputs along their node axis 1; a tree placed on another mesh is
    re-placed from its whole leaves)."""
    if isinstance(tree, ShardedTree):
        if tree.mesh is mesh:
            return tree
        tree = tree.assemble("cpu")
    spec = node_sharding(mesh, n_nodes, stacked=_stacked_inputs(tree))
    leaves = tree_leaves(tree)
    return _place(mesh, n_nodes, leaves, [spec(x) for x in leaves], tree)


def _scale_run_carry(cfg, st, net, key, inputs, axis):
    from corrosion_tpu_torch.sim.scale_step import scale_run_rounds_carry

    return scale_run_rounds_carry(cfg, st, net, key, inputs, axis=axis)


def _full_step(cfg, st, net, key, inp, axis):
    from corrosion_tpu_torch.sim.step import sim_step

    axis.next_round()
    return sim_step(cfg, st, net, key, inp, axis=axis)


def _full_run_carry(cfg, st, net, key, inputs, axis):
    from corrosion_tpu_torch.sim.step import run_rounds_carry

    return run_rounds_carry(cfg, st, net, key, inputs, axis=axis)


#: public sharded entry name -> the body every shard runs. The cost model
#: prices ``sharded_scale_run`` as the single-device program
#: (``analysis/cost.py``): the work is placement-independent.
SHARDED_ENTRY_POINTS = {
    "sharded_step": _full_step,
    "sharded_run": _full_run_carry,
    "sharded_scale_run": _scale_run_carry,
    "sharded_scale_run_carry": _scale_run_carry,
}


def _run_on_mesh(body, cfg, mesh: Mesh, st, net, key, inputs, exchanges=None):
    """``body(cfg, st, net, key, inputs, axis)`` on every shard of
    ``mesh`` (trees not yet placed are placed first): -> ``(placed state,
    every shard's result in shard order)``."""
    n = cfg.n_nodes
    st, net, inputs = (shard_state(mesh, n, t) for t in (st, net, inputs))
    group = ShardGroup(mesh.flat_devices(), n)

    def work(ax):
        i = ax.rank
        return body(cfg, st.parts[i], net.parts[i], key, inputs.parts[i], ax)

    results = group.run(work)
    if exchanges is not None:
        exchanges.extend(group.bytes_by_round())
    return st, results


def _carry_out(mesh: Mesh, n: int, st: ShardedTree, results: list):
    """Every shard's ``((state, key), infos)`` -> ``((ShardedTree, key),
    infos)`` (the key and the summed infos are the same on every shard)."""
    (_, key_out), infos = results[0]
    return (ShardedTree(mesh, n, [r[0][0] for r in results], st.dims), key_out), infos


def sharded_scale_run_carry(cfg, mesh: Mesh, st, net, key, inputs,
                            exchanges: Optional[list] = None):
    """``scale_run_rounds_carry`` over ``mesh``: -> ``((state, key),
    infos)`` with the state a :class:`ShardedTree` on ``mesh`` (trees not
    yet placed are placed first). Chaining the returned carry reproduces
    the straight run bit for bit, and every shard's rows equal the
    single-device run's. ``exchanges``, when given, gets each round's
    ``{site: bytes}`` moved between shards, summed over them."""
    st, results = _run_on_mesh(_scale_run_carry, cfg, mesh, st, net, key, inputs,
                               exchanges)
    return _carry_out(mesh, cfg.n_nodes, st, results)


def sharded_scale_run(cfg, mesh: Mesh, st, net, key, inputs,
                      exchanges: Optional[list] = None):
    """``scale_run_rounds`` over ``mesh``: -> ``(state, infos)``."""
    (out, _key), infos = sharded_scale_run_carry(cfg, mesh, st, net, key, inputs,
                                                 exchanges)
    return out, infos


def sharded_step(cfg, mesh: Mesh, st, net, key, inp,
                 exchanges: Optional[list] = None):
    """One full-view round (``sim.step.sim_step``) over ``mesh``: -> ``(state,
    info)`` with the state a :class:`ShardedTree` on ``mesh`` and the
    info the whole axis's (trees not yet placed are placed first; every
    shard's rows equal the single-device round's). ``exchanges``: as
    :func:`sharded_scale_run_carry`."""
    st, results = _run_on_mesh(_full_step, cfg, mesh, st, net, key, inp, exchanges)
    return ShardedTree(mesh, cfg.n_nodes, [r[0] for r in results], st.dims), results[0][1]


def sharded_run(cfg, mesh: Mesh, st, net, key, inputs,
                exchanges: Optional[list] = None):
    """The full-view round loop (``sim.step.run_rounds``) over stacked
    ``inputs`` on ``mesh``: -> ``(state, infos)``, as :func:`sharded_step`
    for each round. A returned state fed back in on the same mesh, with
    the key the straight run would carry, continues that run bit for
    bit."""
    st, results = _run_on_mesh(_full_run_carry, cfg, mesh, st, net, key, inputs,
                               exchanges)
    (out, _key), infos = _carry_out(mesh, cfg.n_nodes, st, results)
    return out, infos


# --- per-shard host drain + elastic re-placement ---------------------------


@dataclasses.dataclass(frozen=True)
class HostLeafShards:
    """One leaf of a carry, drained per shard.

    ``parts`` holds owned numpy slices ``(start, array)`` ordered by start
    along ``dim`` (``dim is None``: one whole copy). ``axes`` names the
    mesh axes the sharded dim rode (for the manifest); ``sharding`` is
    where the leaf lived, a :class:`Mesh` or a ``torch.device``, so a
    re-upload puts it back there."""

    shape: Tuple[int, ...]
    dtype: Any
    dim: Optional[int]
    parts: Tuple[Tuple[int, Any], ...]
    axes: Optional[Tuple[str, ...]] = None
    sharding: Any = None

    def nbytes(self) -> int:
        return sum(int(a.nbytes) for _start, a in self.parts)


def _owned(t: torch.Tensor) -> np.ndarray:
    return np.array(t.detach().cpu().numpy(), copy=True)


def host_shard_copy(tree: Any) -> Any:
    """Per-shard host drain of a (possibly mesh-placed) tree: -> the tree
    with :class:`HostLeafShards` leaves. Each shard's slice becomes an
    owned numpy copy; no whole leaf is gathered on the way."""
    if not isinstance(tree, ShardedTree):
        leaves = tree_leaves(tree)
        return tree_rebuild(tree, [
            HostLeafShards(tuple(t.shape), _owned(t).dtype, None, ((0, _owned(t)),),
                           sharding=t.device)
            for t in leaves])
    mesh = tree.mesh
    per_shard = [tree_leaves(p) for p in tree.parts]
    bounds = tree.bounds
    out = []
    for j, dim in enumerate(tree.dims):
        if dim is None or mesh.size == 1:
            arr = _owned(per_shard[0][j])
            parts = ((0, arr),)
            dim = None
            shape = arr.shape
        else:
            parts = tuple((lo, _owned(s[j])) for (lo, _hi), s in zip(bounds, per_shard))
            shape = list(parts[0][1].shape)
            shape[dim] = tree.n_nodes
        out.append(HostLeafShards(
            shape=tuple(int(s) for s in shape), dtype=parts[0][1].dtype, dim=dim,
            parts=parts, axes=_joint_node_axis(mesh) if dim is not None else None,
            sharding=mesh))
    return tree_rebuild(tree.parts[0], out)


def assemble_shards(hs: HostLeafShards) -> np.ndarray:
    """One leaf's slices -> a full host array."""
    if hs.dim is None:
        return hs.parts[0][1]
    return np.concatenate([a for _start, a in hs.parts], axis=hs.dim)


def device_put_shards(tree: Any) -> Any:
    """Re-upload a :func:`host_shard_copy` tree to where it came from: a
    :class:`ShardedTree` on the same mesh, or a tree on the same device.
    Every upload is an owned copy."""
    leaves = tree_leaves(tree)
    where = leaves[0].sharding
    if not isinstance(where, Mesh):
        return tree_rebuild(tree, [
            torch.from_numpy(assemble_shards(hs)).to(hs.sharding, copy=True)
            for hs in leaves])
    n = next((hs.shape[hs.dim] for hs in leaves if hs.dim is not None), None)
    if n is None:  # a one-device mesh drains every leaf whole
        n = leaves[0].shape[0]
    dims = [hs.dim if where.size > 1 else node_sharding(where, n)(hs) for hs in leaves]
    return _place(where, n, [assemble_shards(hs) for hs in leaves], dims, tree)


def drained_mesh_meta(tree: Any) -> Optional[dict]:
    """The saving mesh, JSON-ably, from a drained carry (None when nothing
    was mesh-placed): recorded in the manifest."""
    for hs in tree_leaves(tree):
        if isinstance(getattr(hs, "sharding", None), Mesh):
            return hs.sharding.meta()
    return None


def elastic_sharding(mesh: Mesh, n_nodes: int, arr,
                     dim: Optional[int] = None) -> Optional[int]:
    """The node dimension of one restored leaf on the CURRENT mesh: the
    recorded ``dim`` when the manifest has one (the recorded axis names
    need not exist here, so restore is mesh-shape-agnostic), else the
    :func:`node_sharding` rule."""
    if dim is None:
        return node_sharding(mesh, n_nodes)(arr)
    return dim


def place_restored(mesh: Mesh, n_nodes: int, template, arrays: list,
                   recorded_dims: list) -> ShardedTree:
    """Whole host leaves of a restored checkpoint -> a :class:`ShardedTree`
    on ``mesh``, each leaf at its :func:`elastic_sharding` dim."""
    dims = [elastic_sharding(mesh, n_nodes, a, d) for a, d in zip(arrays, recorded_dims)]
    return _place(mesh, n_nodes, arrays, dims, template)
