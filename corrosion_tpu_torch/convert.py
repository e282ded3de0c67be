"""Carry state between the JAX package and the port, through numpy.

The JAX side hands over its NamedTuples as nested dicts of numpy arrays
(``_asdict()`` at every level, tuples as lists); these functions build the
port's NamedTuples from them, on the device asked for, and back. Leaf order
and dtypes are the JAX containers' own, except that ``Book.seen`` (uint32
in JAX) is carried as int32 bit patterns in the port and restored to
uint32 on the way back.
"""

from __future__ import annotations

import numpy as np
import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.ops.partials import Partials
from corrosion_tpu_torch.ops.versions import Book
from corrosion_tpu_torch.sim.broadcast import CrdtState
from corrosion_tpu_torch.sim.scale import ScaleSwimState
from corrosion_tpu_torch.sim.scale_step import ScaleSimState
from corrosion_tpu_torch.sim.step import SimState
from corrosion_tpu_torch.sim.swim import SwimState
from corrosion_tpu_torch.sim.transport import NetModel


def _t(a, dev) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _build(cls, d: dict, dev, nested=None):
    nested = nested or {}
    return cls(**{
        f: nested[f](d[f]) if f in nested else _t(d[f], dev) for f in cls._fields
    })


def _crdt(tree: dict, dev) -> CrdtState:
    return _build(CrdtState, tree, dev, nested={
        "store": lambda s: tuple(_t(p, dev) for p in s),
        "book": lambda b: _build(Book, b, dev),
        "partials": lambda p: _build(Partials, p, dev),
    })


def scale_state_from_numpy(cfg, tree: dict, device="cuda") -> ScaleSimState:
    """``ScaleSimState`` from ``{"swim": {...}, "crdt": {...}}`` numpy dicts."""
    dev = resolve_device(device)
    return ScaleSimState(swim=_build(ScaleSwimState, tree["swim"], dev),
                         crdt=_crdt(tree["crdt"], dev))


def full_state_from_numpy(cfg, tree: dict, device="cuda") -> SimState:
    """The full view's ``SimState`` from the same nested numpy dicts."""
    dev = resolve_device(device)
    return SimState(swim=_build(SwimState, tree["swim"], dev),
                    crdt=_crdt(tree["crdt"], dev))


def state_to_numpy(st) -> dict:
    """The nested numpy dict of a port state, ``ScaleSimState`` or the full
    view's ``SimState`` (``seen`` as uint32)."""
    def tree(nt):
        out = {}
        for f, v in zip(nt._fields, nt):
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                out[f] = tree(v)
            elif isinstance(v, tuple):
                out[f] = [_np(p) for p in v]
            else:
                out[f] = _np(v)
        return out

    d = tree(st)
    d["crdt"]["book"]["seen"] = d["crdt"]["book"]["seen"].view(np.uint32)
    return d


def net_from_numpy(tree: dict, device="cuda") -> NetModel:
    return _build(NetModel, tree, resolve_device(device))


def round_input_from_numpy(cls, tree: dict, device="cuda"):
    """A ``cls`` (``ScaleRoundInput`` or the full view's ``RoundInput``) from
    its numpy dict."""
    return _build(cls, tree, resolve_device(device))


def key_from_numpy(data) -> torch.Tensor:
    """A port key from ``jax.random.key_data(key)`` (uint32 ``[2]``)."""
    return prng.key_from_data(np.asarray(data).astype(np.int64))


def as_numpy_tree(x):
    """Nested NamedTuples (any array type numpy can read) -> the nested
    dict/list-of-numpy form the functions above take."""
    if hasattr(x, "_asdict"):
        return {k: as_numpy_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return [as_numpy_tree(v) for v in x]
    return np.asarray(x)
