"""The simulated transport (port of ``corrosion_tpu/sim/transport.py``).

The scale round's delivery predicates work over per-node "cards": every
per-node scalar the round reads remotely (liveness, partition group,
cluster id, region, plus caller columns such as the incarnation or the HLC)
is packed into one int32 ``[N, C]`` table, and one row gather per
peer-index array replaces several element gathers. The full-view round
uses the node-id forms at the end of this module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.ops.dense import take_rows

N_RINGS = 6  # the reference buckets RTT into 6 rings (members.rs:38)
#: round-trip time of each ring, milliseconds (the members dump shows it)
RING_RTT_MS = (3.0, 15.0, 45.0, 80.0, 150.0, 250.0)

CARD_ALIVE, CARD_PART, CARD_CLUSTER, CARD_REGION = 0, 1, 2, 3
CARD_EXTRA = 4  # first caller-defined column


class NetModel(NamedTuple):
    """Dynamic network conditions (same leaves as the JAX ``NetModel``)."""

    partition: torch.Tensor  # int32 [N] — partition group per node
    drop_prob: torch.Tensor  # float32 [] — per-message loss probability
    region: torch.Tensor  # int32 [N] — geographic region id
    cluster_id: torch.Tensor  # int32 [N] — ClusterId stamped on payloads

    @staticmethod
    def create(n_nodes: int, drop_prob: float = 0.0, n_regions: int = 1,
               device="cuda") -> "NetModel":
        dev = resolve_device(device)
        return NetModel(
            partition=torch.zeros(n_nodes, dtype=torch.int32, device=dev),
            drop_prob=torch.tensor(drop_prob, dtype=torch.float32, device=dev),
            region=torch.arange(n_nodes, dtype=torch.int32, device=dev)
            % max(1, n_regions),
            cluster_id=torch.zeros(n_nodes, dtype=torch.int32, device=dev),
        )


def link_card(net: NetModel, alive, extra=()):
    """The ``[N, 4 + len(extra)]`` node card (columns ``CARD_*``)."""
    cols = [alive.to(torch.int32), net.partition, net.cluster_id, net.region]
    cols += [e.to(torch.int32) for e in extra]
    return torch.stack(cols, dim=1)


def card_at(card, idx):
    """Card rows for an arbitrary-shape index array: ``[*idx.shape, C]``."""
    return take_rows(card, idx)


def _link_ok_c(a, b):
    return (
        (a[..., CARD_ALIVE] != 0)
        & (b[..., CARD_ALIVE] != 0)
        & (a[..., CARD_PART] == b[..., CARD_PART])
        & (a[..., CARD_CLUSTER] == b[..., CARD_CLUSTER])
    )


def datagram_ok_c(net: NetModel, key, src_card, dst_card, row0: int = 0):
    """Lossy datagram delivery between pre-gathered card rows
    (broadcastable against each other; ``row0``: the first node row of
    the draw, a mesh shard's)."""
    shape = torch.broadcast_shapes(src_card.shape[:-1], dst_card.shape[:-1])
    drop = prng.uniform(key, shape, src_card.device, row0=row0) < net.drop_prob
    return _link_ok_c(src_card, dst_card) & ~drop


def bi_ok_c(net: NetModel, key, src_card, dst_card, row0: int = 0):
    """Sync bi-stream availability: fails on either of two loss draws."""
    k1, k2 = prng.split(key)
    shape = torch.broadcast_shapes(src_card.shape[:-1], dst_card.shape[:-1])
    dev = src_card.device
    drop = (prng.uniform(k1, shape, dev, row0=row0) < net.drop_prob) | (
        prng.uniform(k2, shape, dev, row0=row0) < net.drop_prob
    )
    return _link_ok_c(src_card, dst_card) & ~drop


def ring_of_c(net: NetModel, a_card, b_card, axis=None):
    """RTT ring between card rows: circular region distance, clipped to the
    six reference buckets (the region count is the whole ``axis``'s)."""
    d = (a_card[..., CARD_REGION] - b_card[..., CARD_REGION]).abs()
    top = net.region.max()
    if axis is not None:
        top = axis.max(top, "sync.regions")
    n = torch.clamp(top + 1, min=1)
    circ = torch.minimum(d, n - d)
    return torch.clamp(circ, max=N_RINGS - 1).to(torch.int32)


# --- node-id predicates of the full-view round ---------------------------
# The full view gathers each per-node field by node id (the JAX package's
# non-card forms); every draw is made with the same key and shape as there.
# On a mesh shard the fields come from :func:`whole_nodes` and the draws
# take the shard's rows (``row0``).


def whole_nodes(axis, net: NetModel, alive, site: str):
    """The whole node axis's ``(net, alive)`` for the node-id predicates:
    on a mesh shard its rows' liveness, partition, cluster id and region
    are gathered in one exchange (``site``); the whole axis returns them
    as they are."""
    if axis.is_whole:
        return net, alive
    card = axis.all_gather(link_card(net, alive), site)
    return (net._replace(partition=card[:, CARD_PART], region=card[:, CARD_REGION],
                         cluster_id=card[:, CARD_CLUSTER]),
            card[:, CARD_ALIVE] != 0)


def _at(t, idx):
    return t[idx.long()]


def ring_of(net: NetModel, src, dst):
    """RTT ring between node ids (int32 tensors of one shape)."""
    d = (_at(net.region, src) - _at(net.region, dst)).abs()
    n = torch.clamp(net.region.max() + 1, min=1)
    circ = torch.minimum(d, n - d)
    return torch.clamp(circ, max=N_RINGS - 1).to(torch.int32)


def same_region(net: NetModel, rows=None):
    """[N, N] ring-0 adjacency (full-view rounds only); ``rows``: the
    regions of the viewing rows (a mesh shard's, against the whole
    ``net``), else every node's."""
    rows = net.region if rows is None else rows
    return rows[:, None] == net.region[None, :]


def _link_ok(net: NetModel, alive, src, dst):
    """Both endpoints up, same partition group, same cluster id."""
    return (
        _at(alive, src)
        & _at(alive, dst)
        & (_at(net.partition, src) == _at(net.partition, dst))
        & (_at(net.cluster_id, src) == _at(net.cluster_id, dst))
    )


def datagram_ok(net: NetModel, key, alive, src, dst, row0: int = 0):
    """Lossy datagram delivery between node ids (``src``/``dst`` of one
    shape; one uniform draw of that shape, ``row0``: as
    :func:`datagram_ok_c`)."""
    drop = prng.uniform(key, src.shape, src.device, row0=row0) < net.drop_prob
    return _link_ok(net, alive, src, dst) & ~drop


# changeset broadcast uni streams share datagram loss semantics
uni_ok = datagram_ok


def bi_ok(net: NetModel, key, alive, src, dst):
    """Sync bi-stream availability: fails on either of two loss draws."""
    k1, k2 = prng.split(key)
    dev = src.device
    drop = (prng.uniform(k1, src.shape, dev) < net.drop_prob) | (
        prng.uniform(k2, src.shape, dev) < net.drop_prob
    )
    return _link_ok(net, alive, src, dst) & ~drop
