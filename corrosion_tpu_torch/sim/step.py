"""The full-view whole-cluster round: SWIM + writes + broadcast + sync (port
of ``corrosion_tpu/sim/step.py``).

One call advances every simulated node through one protocol round over the
O(N^2) full membership view; the faithful small-N reference of the scale
round. ``run_rounds`` is a Python loop over rounds in place of the JAX
package's ``lax.scan``; the per-round key is split off the carried key, so
chaining carries reproduces a straight run bit for bit.

At ``tx_max_cells == 1`` the round runs on CUDA tensors through the ingest
kernel in two forms (the non-emitting local write, m=1, and the
``recv_slots``-wide receive batch) and on CPU tensors through its plain
version. At ``wan_config``'s default ``tx_max_cells=8`` it runs multi-cell
transactions (``local_write_tx``, chunked delivery through the partial
buffer) on the plain route, as the JAX package does. It reads nothing back from
the device except once per ``run_rounds_carry`` call, for the host mirror
of the round counter that the sweep predicate needs.

The round also runs on one shard of a mesh (``axis=``, as the scale round
does): ``parallel/mesh.py``'s ``sharded_step`` and ``sharded_run`` run it
on every shard's rows, one thread a shard, and each shard's round launches
its own kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch._units import arm
from corrosion_tpu_torch.ops.lww import STATE_ALIVE
from corrosion_tpu_torch.ops.select import sample_k, sample_k_biased
from corrosion_tpu_torch.ops.versions import needs_count
from corrosion_tpu_torch.parallel.exchange import NodeAxis
from corrosion_tpu_torch.sim.broadcast import (
    LAST_SYNC_CAP,
    CrdtState,
    bcast_step,
    local_write,
    local_write_tx,
)
from corrosion_tpu_torch.sim.config import SimConfig, check_full_slice
from corrosion_tpu_torch.sim.swim import SwimState, swim_metrics, swim_step
from corrosion_tpu_torch.sim.sync import choose_sync_peers, sync_step
from corrosion_tpu_torch.sim.transport import NetModel, ring_of, same_region, whole_nodes


class SimState(NamedTuple):
    swim: SwimState
    crdt: CrdtState

    @staticmethod
    def create(cfg: SimConfig, n_seeds: int = 4, device="cuda") -> "SimState":
        return SimState(SwimState.create(cfg, n_seeds, device),
                        CrdtState.create(cfg, device))


class RoundInput(NamedTuple):
    """External events for one round (same leaves as the JAX ``RoundInput``;
    stacked with a leading rounds axis for ``run_rounds``)."""

    kill: torch.Tensor  # bool [N]
    revive: torch.Tensor  # bool [N]
    write_mask: torch.Tensor  # bool [N] (only nodes < n_origins write)
    write_cell: torch.Tensor  # int32 [N]
    write_val: torch.Tensor  # int32 [N]
    write_clp: torch.Tensor  # int32 [N]
    tx_mask: torch.Tensor  # bool [N] — one multi-cell transaction a node
    tx_len: torch.Tensor  # int32 [N] — real lanes (1..K)
    tx_cell: torch.Tensor  # int32 [N, K]
    tx_val: torch.Tensor  # int32 [N, K]
    tx_clp: torch.Tensor  # int32 [N, K]

    @staticmethod
    def quiet(cfg: SimConfig, device="cuda") -> "RoundInput":
        dev = resolve_device(device)
        n, k = cfg.n_nodes, max(1, cfg.tx_max_cells)

        def z(*s, dtype=torch.int32):
            return torch.zeros(s, dtype=dtype, device=dev)

        return RoundInput(
            kill=z(n, dtype=torch.bool), revive=z(n, dtype=torch.bool),
            write_mask=z(n, dtype=torch.bool), write_cell=z(n), write_val=z(n),
            write_clp=z(n), tx_mask=z(n, dtype=torch.bool),
            tx_len=torch.ones(n, dtype=torch.int32, device=dev),
            tx_cell=z(n, k), tx_val=z(n, k), tx_clp=z(n, k),
        )


def sim_step(cfg: SimConfig, st: SimState, net: NetModel, key, inp: RoundInput,
             now: Optional[int] = None, axis=None):
    """One full protocol round for the whole cluster. ``now`` is the host
    mirror of ``st.crdt.now``; it is read (once) only when a sweep is
    configured and it is not given. ``axis``: a mesh shard's view of the
    node axis (``parallel/mesh.py``): ``st``, ``net`` and ``inp`` hold its
    rows, node ids stay global, and the round's info counts are summed
    over the axis at its end; None runs the whole axis on one device.
    Returns ``(state, info)``."""
    check_full_slice(cfg)
    n = cfg.n_nodes
    dev = st.swim.view.device
    ax = NodeAxis.whole(n, dev) if axis is None else axis
    ids = None if ax.is_whole else ax.ids()
    k_swim, k_bcast, k_sync, k_bt, k_sp = prng.split(key, 5)
    swim, swim_info = swim_step(cfg, st.swim, net, k_swim,
                                kill=inp.kill, revive=inp.revive, axis=axis)
    believed = (swim.view >= 0) & ((swim.view & 3) == STATE_ALIVE)
    cand = believed & ~ax.eye()

    # tick the round counter (the HLC's physical time axis), then write
    cst = st.crdt._replace(now=st.crdt.now + 1)
    cst = local_write(cfg, cst, inp.write_mask, inp.write_cell, inp.write_val,
                      inp.write_clp, ids=ids)
    if cfg.tx_max_cells > 1:
        cst = local_write_tx(cfg, cst, inp.tx_mask, inp.tx_cell, inp.tx_val,
                             inp.tx_clp, inp.tx_len, ids=ids)

    # broadcast fanout: same-region members take strict priority
    net_all, alive_all = whole_nodes(ax, net, swim.alive, "step.card")
    targets, t_ok = sample_k_biased(
        cand & swim.alive[:, None], same_region(net_all, net.region).to(torch.float32),
        cfg.bcast_fanout, k_bt, row0=ax.lo)
    cst, b_info = bcast_step(cfg, cst, targets, t_ok, alive_all, net_all, k_bcast,
                             axis=axis)

    # need-driven sync peer choice from a 2x random sample; last_sync
    # tracks are peer node ids
    iarr = ax.ids()
    p_cnt = cfg.sync_peers
    cand_ids, cand_sok = sample_k(cand, min(2 * p_cnt, n), k_sp, row0=ax.lo)
    staleness = torch.gather(cst.last_sync, 1, cand_ids.long())
    rings_c = ring_of(net_all, iarr[:, None].expand(cand_ids.shape), cand_ids)
    peers, p_ok, _ = choose_sync_peers(cfg, cst.book, cand_ids, cand_sok,
                                       staleness, rings_c, p_cnt)
    sweep = None
    if cfg.sync_sweep_every > 0:
        if now is None:
            now = int(st.crdt.now)
        sweep = (now + 1) % (max(1, cfg.sync_interval) * cfg.sync_sweep_every) == 0
        if sweep:
            arm("sweep")
    arm("sync")
    cst, s_ok, s_info = sync_step(cfg, cst, peers, p_ok, swim.alive, net, k_sync,
                                  sweep=sweep, axis=axis)
    rows = iarr if ax.is_whole else torch.arange(ax.rows, dtype=torch.int32, device=dev)
    ls = torch.clamp(cst.last_sync + 1, max=LAST_SYNC_CAP)
    flat = torch.where(s_ok, rows[:, None].long() * n + peers.long(), ax.rows * n)
    ls = torch.cat([ls.reshape(-1), ls.new_zeros(1)])
    ls[flat.reshape(-1)] = 0
    cst = cst._replace(last_sync=ls[: ax.rows * n].reshape(ax.rows, n))

    return SimState(swim, cst), ax.sum_info({**swim_info, **b_info, **s_info}, "info")


def _round(inputs: RoundInput, r: int) -> RoundInput:
    return RoundInput(*(a[r] for a in inputs))


def run_rounds_carry(cfg: SimConfig, st: SimState, net: NetModel, key,
                     inputs: RoundInput, axis=None):
    """The rounds of stacked ``inputs`` (leading axis = rounds) in a loop.
    Returns ``((state, key), infos)`` with every info value stacked over
    rounds; feeding the carry back in reproduces a straight run. ``axis``:
    as :func:`sim_step`."""
    check_full_slice(cfg)
    rounds = inputs.kill.shape[0]
    now = int(st.crdt.now) if cfg.sync_sweep_every > 0 else None
    infos = []
    for r in range(rounds):
        key, sub = prng.split(key)
        if axis is not None:
            axis.next_round()
        st, info = sim_step(cfg, st, net, sub, _round(inputs, r), now=now, axis=axis)
        if now is not None:
            now += 1
        infos.append(info)
    stacked = {k: torch.stack([i[k] for i in infos]) for k in infos[0]} if infos else {}
    return (st, key), stacked


def run_rounds(cfg: SimConfig, st: SimState, net: NetModel, key, inputs: RoundInput):
    """The round loop over stacked per-round inputs: ``(state, infos)``."""
    (st, _key), infos = run_rounds_carry(cfg, st, net, key, inputs)
    return st, infos


def crdt_metrics(cfg: SimConfig, st: SimState) -> dict:
    """The reference's convergence predicate: equal LWW stores, equal heads
    (on slots tracking the same actor) and no outstanding needs across all
    alive nodes."""
    alive = st.swim.alive
    ref = int(torch.argmax(alive.to(torch.int32)))
    same_store = torch.stack(
        [(p == p[ref]).all(dim=1) for p in st.crdt.store]).all(dim=0)
    book = st.crdt.book
    aligned = book.org_id == book.org_id[ref]
    same_head = torch.where(aligned, book.head == book.head[ref], True).all(dim=1)
    needs = needs_count(book)
    no_needs = (needs <= 0).all(dim=1)
    ok = (~alive) | (same_store & same_head & no_needs)
    swim_m = {f"swim_{k}": v for k, v in swim_metrics(st.swim).items()}
    return {
        "converged": ok.all(),
        "n_diverged": (~ok).sum(),
        "total_needs": torch.where(alive[:, None], torch.clamp(needs, min=0), 0).sum(),
        **swim_m,
    }
