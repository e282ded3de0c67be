"""The fused whole-cluster round at scale: bounded-table SWIM + CRDT (port
of ``corrosion_tpu/sim/scale_step.py``).

One round: SWIM front, SWIM back (swim kernel), the local write that also
emits the piggyback payload (emitting ingest kernel), the piggyback
broadcast into the receiving ingest kernel, cohort anti-entropy sync every
``sync_interval`` rounds (with the sweep lane), then the carry re-narrows.
The route of the CRDT half is the config's, as in the JAX package: at
``pig_changes == 0`` the local write is the non-emitting kernel and the
piggyback selection is plain (the receiving kernel then takes an empty
batch); multi-cell transactions (``tx_max_cells > 1``) and the wire-budget
lane (``bcast_wire_budget``) run the plain write, selection and ingest,
with the partial-changeset buffer, on the card as on the CPU.
``scale_run_rounds`` loops the round in Python; the sync gate reads a
host-side mirror of the round counter, so no round waits on the device.

``quiet="on"`` swaps in :func:`scale_sim_step_quiet`, which runs only the
SWIM front on a round it proves to be a fixpoint.

The round functions take ``axis`` (``parallel/exchange.NodeAxis``): on a
mesh shard they run on its rows with global node ids, and every cross-node
access is one of the axis's exchanges (``parallel/mesh.py`` runs one
thread a shard); None is the whole axis, the round as it runs on one
device. A round's info counts are summed over the axis once, at its end.

Only ``fused="off"``/``"interpret"`` are refused (:func:`check_slice`): the
port has no XLA or interpret path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch._units import arm
from corrosion_tpu_torch.ops.dense import (
    scatter_cols_add,
    scatter_cols_set,
    select_cols,
    take_rows,
)
from corrosion_tpu_torch.ops.lww import STATE_ALIVE, STATE_DOWN, STATE_SUSPECT
from corrosion_tpu_torch.ops.partials import NO_SLOT
from corrosion_tpu_torch.ops.select import sample_k
from corrosion_tpu_torch.ops.slots import budget_mask
from corrosion_tpu_torch.ops.versions import needs_count
from corrosion_tpu_torch.sim.broadcast import (
    CHANGE_WIRE_BYTES,
    LAST_SYNC_CAP,
    NO_Q,
    CrdtState,
    ingest_changes,
    kernel_ingest,
    local_write,
    local_write_tx,
)
from corrosion_tpu_torch.sim.config import FUSED_MODES, QUIET_MODES
from corrosion_tpu_torch.sim.scale import (
    ScaleSwimState,
    _swim_back,
    _swim_front,
    node_axis,
    scale_config,
    scale_swim_metrics,
    scale_swim_step,
    swim_front_disturbed,
)
from corrosion_tpu_torch.sim.transport import NetModel, card_at, link_card, ring_of_c


@dataclasses.dataclass(frozen=True)
class ScaleSimConfig:
    """Static shapes for the scale round, field for field the JAX
    ``ScaleSimConfig`` (a CPU test pins the two equal)."""

    n_nodes: int
    m_slots: int = 64
    n_seeds: int = 4
    n_indirect: int = 3
    suspicion_rounds: int = 6
    max_transmissions: int = 10
    announce_interval: int = 16
    down_purge_rounds: int = 64
    pig_members: int = 0
    n_origins: int = 16
    any_writer: bool = True
    org_keep_rounds: int = 16
    n_rows: int = 16
    n_cols: int = 4
    buf_slots: int = 32
    tx_max_cells: int = 1
    partial_slots: int = 8
    bcast_queue: int = 32
    bcast_max_transmissions: int = 4
    bcast_wire_budget: bool = False
    pig_changes: int = 4
    bcast_budget_bytes: int = 10 * 1024 * 1024
    sync_interval: int = 8
    sync_peers: int = 2
    sync_pull_peers: int = 3
    sync_chunk: int = 32
    serve_cap: int = 3
    sync_min_chunk: int = 4
    sync_defer_cap: int = 8
    sync_sweep_every: int = 4
    sync_cohort: bool = True
    narrow_dtypes: bool = True
    narrow_int8: bool = False
    narrow_q_int8: bool = False
    fused: str = "auto"
    quiet: str = "auto"
    quiet_backstop_interval: int = 0
    quiet_shards: int = 1

    @property
    def n_cells(self) -> int:
        return self.n_rows * self.n_cols

    @property
    def sync_tracks(self) -> int:
        return self.m_slots

    def validate(self) -> "ScaleSimConfig":
        if self.n_origins > self.n_nodes or self.m_slots <= 0:
            raise ValueError(
                f"need n_origins <= n_nodes and m_slots > 0, got "
                f"{self.n_origins}/{self.n_nodes}/{self.m_slots}"
            )
        if not 1 <= self.tx_max_cells <= 30:
            raise ValueError(f"tx_max_cells {self.tx_max_cells} not in 1..30")
        if self.n_nodes > 1 << 30:
            raise ValueError(
                f"n_nodes {self.n_nodes} > 2^30: sender-election packs "
                f"priority + node id in one int32 word"
            )
        if not 0 <= self.pig_members <= self.m_slots:
            raise ValueError(
                f"pig_members {self.pig_members} must be 0..m_slots ({self.m_slots})"
            )
        if self.narrow_dtypes and max(
                self.n_cells, self.tx_max_cells + 1,
                self.bcast_max_transmissions + 1, self.max_transmissions,
                self.suspicion_rounds, self.down_purge_rounds,
                LAST_SYNC_CAP) >= (1 << 15):
            raise ValueError(
                "narrow_dtypes stores these planes as int16; a plane bound "
                "exceeds int16 range"
            )
        if self.narrow_int8 and not self.narrow_dtypes:
            raise ValueError("narrow_int8 is a tier of narrow_dtypes; enable both")
        if self.narrow_int8 and self.max_transmissions >= (1 << 7):
            raise ValueError(
                f"narrow_int8 stores mem_tx as int8; max_transmissions "
                f"{self.max_transmissions} exceeds int8 range"
            )
        if self.narrow_q_int8:
            if not self.narrow_dtypes:
                raise ValueError("narrow_q_int8 is a tier of narrow_dtypes; enable both")
            if max(self.bcast_max_transmissions, self.tx_max_cells) >= (1 << 7):
                raise ValueError(
                    "narrow_q_int8 stores q_tx/q_seq/q_nseq as int8; a bound "
                    "exceeds int8 range"
                )
        if self.fused not in FUSED_MODES:
            raise ValueError(f"fused {self.fused!r} not one of {FUSED_MODES}")
        if self.quiet not in QUIET_MODES:
            raise ValueError(f"quiet {self.quiet!r} not one of {QUIET_MODES}")
        if self.quiet == "on" and not self.sync_cohort:
            raise ValueError("quiet='on' requires sync_cohort")
        if self.quiet_backstop_interval < 0:
            raise ValueError(
                f"quiet_backstop_interval {self.quiet_backstop_interval} must be >= 0"
            )
        if self.quiet_shards < 1 or self.n_nodes % self.quiet_shards:
            raise ValueError(
                f"quiet_shards {self.quiet_shards} must be >= 1 and divide "
                f"n_nodes ({self.n_nodes})"
            )
        return self

    @property
    def timer_dtype(self):
        return torch.int16 if self.narrow_dtypes else torch.int32

    @property
    def tx_dtype(self):
        return torch.int8 if self.narrow_int8 else self.timer_dtype

    @property
    def q_dtype(self):
        return torch.int8 if self.narrow_q_int8 else self.timer_dtype


def scale_sim_config(n_nodes: int, **overrides) -> ScaleSimConfig:
    """Cluster-size-adaptive defaults (SWIM knobs from ``scale_config``)."""
    swim = scale_config(n_nodes)
    log_n = max(1, math.ceil(math.log2(max(2, n_nodes))))
    defaults = dict(
        m_slots=swim.m_slots,
        n_seeds=swim.n_seeds,
        n_indirect=swim.n_indirect,
        suspicion_rounds=swim.suspicion_rounds,
        max_transmissions=swim.max_transmissions,
        announce_interval=swim.announce_interval,
        down_purge_rounds=swim.down_purge_rounds,
        bcast_max_transmissions=max(3, log_n // 2),
        sync_peers=max(3, min(10, n_nodes // 100)),
    )
    defaults.update(overrides)
    return ScaleSimConfig(n_nodes=n_nodes, **defaults).validate()


def check_slice(cfg: ScaleSimConfig) -> None:
    """Raise for the execution knobs the port does not have: ``fused="off"``
    and ``"interpret"`` (the route follows the config and the tensors'
    device, ROADMAP, rules of the port)."""
    if cfg.fused in ("off", "interpret"):
        raise ValueError(
            f"fused={cfg.fused!r}: the port has no XLA or interpret path; the "
            f"route follows the config and the tensors' device (ROADMAP, "
            f"rules of the port)")


class ScaleSimState(NamedTuple):
    swim: ScaleSwimState
    crdt: CrdtState

    @staticmethod
    def create(cfg: ScaleSimConfig, device="cuda") -> "ScaleSimState":
        dev = resolve_device(device)
        return ScaleSimState(ScaleSwimState.create(cfg, dev), CrdtState.create(cfg, dev))


class ScaleRoundInput(NamedTuple):
    """External events for one round (or stacked ``[rounds, ...]``)."""

    kill: torch.Tensor  # bool [N]
    revive: torch.Tensor  # bool [N]
    write_mask: torch.Tensor  # bool [N]
    write_cell: torch.Tensor  # int32 [N]
    write_val: torch.Tensor  # int32 [N]
    write_clp: torch.Tensor  # int32 [N]
    tx_mask: torch.Tensor  # bool [N]
    tx_len: torch.Tensor  # int32 [N]
    tx_cell: torch.Tensor  # int32 [N, K]
    tx_val: torch.Tensor  # int32 [N, K]
    tx_clp: torch.Tensor  # int32 [N, K]

    @staticmethod
    def quiet(cfg: ScaleSimConfig, device="cuda") -> "ScaleRoundInput":
        dev = resolve_device(device)
        n, k = cfg.n_nodes, max(1, cfg.tx_max_cells)

        def z(*s, dtype=torch.int32):
            return torch.zeros(s, dtype=dtype, device=dev)

        return ScaleRoundInput(
            kill=z(n, dtype=torch.bool), revive=z(n, dtype=torch.bool),
            write_mask=z(n, dtype=torch.bool), write_cell=z(n), write_val=z(n),
            write_clp=z(n), tx_mask=z(n, dtype=torch.bool),
            tx_len=torch.ones(n, dtype=torch.int32, device=dev),
            tx_cell=z(n, k), tx_val=z(n, k), tx_clp=z(n, k),
        )


def make_write_inputs(cfg: ScaleSimConfig, key, rounds: int, write_mask,
                      device="cuda") -> ScaleRoundInput:
    """Stacked per-round inputs with conflict-heavy random writes for the
    nodes in ``write_mask`` (bool [rounds, N]): single-cell writes, or at
    ``tx_max_cells > 1`` one transaction of 1..K cells (drawn with
    replacement) per writer; the same draws as the JAX package's
    ``make_write_inputs``."""
    dev = resolve_device(device)
    k_cell, k_val, k_len = prng.split(key, 3)
    n = cfg.n_nodes
    quiet = ScaleRoundInput.quiet(cfg, dev)
    inputs = ScaleRoundInput(*(a.expand((rounds,) + tuple(a.shape)).clone() for a in quiet))
    if cfg.tx_max_cells > 1:
        k = cfg.tx_max_cells
        return inputs._replace(
            tx_mask=write_mask.to(dev),
            tx_len=prng.randint(k_len, (rounds, n), 1, k + 1, dev),
            tx_cell=prng.randint(k_cell, (rounds, n, k), 0, cfg.n_cells, dev),
            tx_val=prng.randint(k_val, (rounds, n, k), 0, 1 << 20, dev),
        )
    return inputs._replace(
        write_mask=write_mask.to(dev),
        write_cell=prng.randint(k_cell, (rounds, n), 0, cfg.n_cells, dev),
        write_val=prng.randint(k_val, (rounds, n), 0, 1 << 20, dev),
    )


def million_config(n_nodes: int = 1_000_000, **overrides) -> ScaleSimConfig:
    """The JAX package's priced 1M point: bounded member piggyback of 16
    entries a packet, int8 ``mem_tx`` and int8 queue counters, every other
    knob at :func:`scale_sim_config`'s default. ``n_nodes`` and
    ``overrides`` cut it to size."""
    tiers = dict(pig_members=16, narrow_int8=True, narrow_q_int8=True)
    return scale_sim_config(n_nodes, **{**tiers, **overrides})


def flagship_workload(cfg: ScaleSimConfig, rounds: int, device="cuda"):
    """bench.py's workload: the ``n_origins`` origin nodes write with
    probability 0.25 per round, 1 % datagram loss, round key 0. Returns
    ``(state, net, key, inputs)`` for ``rounds`` stacked rounds."""
    dev = resolve_device(device)
    n = cfg.n_nodes
    k_w, k_in, _ = prng.split(prng.key(1), 3)
    writer = torch.arange(n, device=dev) < cfg.n_origins
    w = (prng.uniform(k_w, (rounds, n), dev) < 0.25) & writer[None, :]
    return (ScaleSimState.create(cfg, dev),
            NetModel.create(n, drop_prob=0.01, device=dev),
            prng.key(0), make_write_inputs(cfg, k_in, rounds, w, dev))


def piggyback_bcast_step(cfg, cst: CrdtState, channels, key, carried=None,
                         emitted=None, axis=None):
    """Disseminate queued changesets over the SWIM packet channels
    (``(src, valid)`` pairs, one sender per receiver). Each delivered packet
    carries its sender's ``pig_changes`` selected queue slots: the
    local-write kernel's ``emitted`` ``(payload, sel_slots, sel_ok)`` when
    given, else the selection here (the per-sender byte budget over
    ``carried`` delivered packets, then a uniform sample of the live slots
    under ``key``, packed once per sender as ``[N, (n_fields + 1) * R]``
    int32, with the remaining-budget lane under ``bcast_wire_budget``). The
    senders' budgets burn once per delivered packet; the receivers ingest.
    ``carried`` int32 [N] defaults to the delivered packets per sender."""
    q, r = cfg.bcast_queue, cfg.pig_changes
    dev = cst.q_origin.device
    ax = node_axis(cfg, axis, dev)
    n, big_n = ax.rows, ax.n
    i32 = torch.int32
    if carried is None:
        carried = torch.zeros(big_n + 1, dtype=i32, device=dev)
        for src, valid in channels:
            src = torch.clamp(src, min=0).long()
            carried.scatter_add_(0, torch.where(src < big_n, src, big_n), valid.to(i32))
        carried = ax.owner_add(carried[:big_n], "bcast.carried")
    wire = bool(cfg.bcast_wire_budget)
    if emitted is not None:
        if wire:
            raise ValueError(
                "kernel-emitted payloads carry no wire-budget lane; "
                "bcast_wire_budget runs the plain selection")
        payload, sel_slots, sel_ok = emitted
    else:
        live_slot = (cst.q_origin != NO_Q) & (cst.q_tx > 0)
        allowed = torch.clamp(
            cfg.bcast_budget_bytes // (CHANGE_WIRE_BYTES * torch.clamp(carried, min=1)),
            min=1).to(i32)
        sel_slots, sel_ok = sample_k(budget_mask(live_slot, cst.q_tx, allowed), r, key,
                                     row0=ax.lo)
        fields = [cst.q_origin, cst.q_dbv, cst.q_cell, cst.q_ver, cst.q_val,
                  cst.q_site, cst.q_clp, cst.q_seq, cst.q_nseq, cst.q_ts]
        if wire:
            fields.append(cst.q_tx)
        payload = torch.cat([select_cols(f, sel_slots).to(i32) for f in fields]
                            + [sel_ok.to(i32)], dim=1)
    n_fields = 11 if wire else 10
    payload = ax.all_gather(payload, "bcast.payload")
    parts, valids = [], []
    for src, valid in channels:
        got = take_rows(payload, torch.clamp(src, min=0))
        parts.append([got[:, i * r:(i + 1) * r] for i in range(n_fields)])
        valids.append(valid[:, None] & (got[:, n_fields * r:(n_fields + 1) * r] != 0))
    lanes = [torch.cat([p[i] for p in parts], dim=1) for i in range(n_fields)]
    live = torch.cat(valids, dim=1)

    # sender budget decrement: one per delivered packet, in the plane dtype
    dec = scatter_cols_add(
        torch.zeros((n, q), dtype=cst.q_tx.dtype, device=dev),
        sel_slots, carried[:, None].expand(sel_slots.shape), sel_ok,
    )
    q_tx = torch.clamp(cst.q_tx - dec, min=0)
    exhausted = (cst.q_origin != NO_Q) & (q_tx <= 0)
    cst = cst._replace(q_tx=q_tx, q_origin=torch.where(exhausted, NO_Q, cst.q_origin))
    return ingest_changes(cfg, cst, live, *lanes[:10],
                          m_tx=lanes[10] if wire else None)


def _post_swim(cfg, st, net, swim, swim_info, channels, carried, k_pig, k_sp,
               k_sync, inp, now: int, axis=None):
    """CRDT half of the round; ``now`` is the host mirror of the ticked
    round counter. The info counts are this axis's rows' own."""
    from corrosion_tpu_torch.ops import megakernel
    from corrosion_tpu_torch.sim.sync import choose_sync_peers, sync_step

    m = cfg.m_slots
    dev = swim.mem_id.device
    ax = node_axis(cfg, axis, dev)
    n, r0 = ax.rows, ax.lo
    cst = st.crdt._replace(now=st.crdt.now + 1)
    iarr = ax.ids()

    emitted = None
    if kernel_ingest(cfg) and cfg.pig_changes > 0:
        # the local-write kernel also emits the round's piggyback selection,
        # from the same draw the plain selection would make under k_pig
        rand = prng.uniform(k_pig, (n, cfg.bcast_queue), dev, row0=r0)
        cst, emitted = megakernel.local_write_fused(
            cfg, cst, inp.write_mask, inp.write_cell, inp.write_val,
            inp.write_clp, rand=rand, carried=carried, ids=iarr,
        )
    else:
        cst = local_write(cfg, cst, inp.write_mask, inp.write_cell,
                          inp.write_val, inp.write_clp, ids=iarr)
        if cfg.tx_max_cells > 1:
            cst = local_write_tx(cfg, cst, inp.tx_mask, inp.tx_cell, inp.tx_val,
                                 inp.tx_clp, inp.tx_len, ids=iarr)
    cst, b_info = piggyback_bcast_step(cfg, cst, channels, k_pig, carried,
                                       emitted=emitted, axis=ax)

    bel_alive = (
        (swim.mem_id >= 0)
        & (swim.mem_id != iarr[:, None])
        & (swim.mem_view >= 0)
        & ((swim.mem_view & 3) == STATE_ALIVE)
    )
    p_cnt = min(cfg.sync_peers, max(1, cfg.sync_pull_peers))
    cst = cst._replace(last_sync=torch.clamp(cst.last_sync + 1, max=LAST_SYNC_CAP))

    def run_sync(cst):
        arm("sync")
        cand_slots, cand_sok = sample_k(bel_alive, min(2 * cfg.sync_peers, m), k_sp,
                                        row0=r0)
        cand_ids = select_cols(swim.mem_id, cand_slots)
        staleness = select_cols(cst.last_sync, cand_slots)
        card = link_card(net, swim.alive)
        cards = ax.all_gather(card, "sync.ring_card")
        rings_c = ring_of_c(net, card[:, None, :],
                            card_at(cards, torch.clamp(cand_ids, min=0)),
                            axis=axis)
        peers, p_ok, c_idx = choose_sync_peers(
            cfg, cst.book, cand_ids, cand_sok, staleness, rings_c, p_cnt
        )
        sweep = None
        if cfg.sync_sweep_every > 0:
            sweep = now % (max(1, cfg.sync_interval) * cfg.sync_sweep_every) == 0
            if sweep:
                arm("sweep")
                # the sweep lane pairs uniformly over the whole id space
                r_peer = prng.randint(prng.fold_in(k_sp, 1), (n,), 0, ax.n, dev,
                                      row0=r0)
                peers = peers.clone()
                p_ok = p_ok.clone()
                peers[:, 0] = r_peer
                p_ok[:, 0] = r_peer != iarr
        cst, s_ok, s_info = sync_step(
            cfg, cst, peers, p_ok, swim.alive, net, k_sync,
            go_all=cfg.sync_cohort, sweep=sweep, axis=axis,
        )
        if sweep:
            # lane 0 synced the random sweep peer, not the scored candidate
            s_ok = s_ok.clone()
            s_ok[:, 0] = False
        synced_slots = select_cols(cand_slots, c_idx)
        ls = scatter_cols_set(cst.last_sync, synced_slots,
                              torch.zeros_like(synced_slots), s_ok)
        return cst._replace(last_sync=ls), s_info

    if not cfg.sync_cohort or now % max(1, cfg.sync_interval) == 0:
        cst, s_info = run_sync(cst)
    else:
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        s_info = {"syncs": zero, "cells_pulled": zero, "versions_granted": zero,
                  "serve_rejects": zero}

    st_out = _narrow_carry(cfg, ScaleSimState(swim, cst))
    info = {**swim_info, **b_info, **s_info, **activity_info(cfg, st_out)}
    return st_out, info


def scale_sim_step(cfg: ScaleSimConfig, st: ScaleSimState, net: NetModel, key,
                   inp: ScaleRoundInput, now: Optional[int] = None, axis=None):
    """One full protocol round at scale. ``now`` is the host mirror of
    ``st.crdt.now`` (read from the device once when omitted; a replicated
    scalar on a mesh). Returns ``(state, info)``."""
    check_slice(cfg)
    if now is None:
        now = int(st.crdt.now)
    k_swim, k_pig, k_sp, k_sync = prng.split(key, 4)
    swim, swim_info, channels, carried = scale_swim_step(
        cfg, st.swim, net, k_swim, kill=inp.kill, revive=inp.revive, axis=axis
    )
    st_out, info = _post_swim(cfg, st, net, swim, swim_info, channels, carried,
                              k_pig, k_sp, k_sync, inp, now + 1, axis=axis)
    ax = node_axis(cfg, axis, st_out.crdt.now.device)
    return st_out, ax.sum_info(info, "info")


def _pending(st: ScaleSimState):
    """bool [N, M]: occupied member entries in the Suspect or Down state."""
    view = st.swim.mem_view
    return (
        (st.swim.mem_id >= 0)
        & (view >= 0)
        & (((view & 3) == STATE_SUSPECT) | ((view & 3) == STATE_DOWN))
    )


def _quiet_busy(cfg: ScaleSimConfig, st: ScaleSimState):
    """bool [N]: alive nodes that still owe the cluster work (the carry
    half of the quiet predicate). Stricter than :func:`activity_masks`:
    a Suspect/Down entry counts whatever its timer, and so does any
    sendable membership entry; dead rows never count."""
    row_busy = (
        _pending(st).any(dim=1)
        | (st.swim.mem_tx > 0).any(dim=1)
        | (st.crdt.q_origin != NO_Q).any(dim=1)
        | (st.crdt.partials.origin != NO_SLOT).any(dim=1)
        | (needs_count(st.crdt.book) > 0).any(dim=1)
    )
    return st.swim.alive & row_busy


def _quiet_info(cfg: ScaleSimConfig, busy, quiet_ok, settled,
                schedule_ok: bool, ax) -> dict:
    """The ``quiet_*`` round-info keys, shared by both branches, over the
    whole axis (``quiet_shards`` blocks of the node axis may span mesh
    shards: each block's busy bit is or-ed over the mesh)."""
    i32 = torch.int32
    shards = max(1, int(cfg.quiet_shards))
    shard_busy = ax.any(ax.spread(busy, False).reshape(shards, -1).any(dim=1),
                        "quiet.blocks")
    return {
        "quiet_round": quiet_ok.to(i32),
        "quiet_shards_quiet": (~shard_busy).sum().to(i32),
        "quiet_shards_skipped": quiet_ok.to(i32) * shards,
        "quiet_backstop": (settled & (not schedule_ok)).to(i32),
        "quiet_nodes_active": ax.sum(busy.sum(), "quiet.active").to(i32),
    }


def scale_sim_step_quiet(cfg: ScaleSimConfig, st: ScaleSimState, net: NetModel,
                         key, inp: ScaleRoundInput, now: Optional[int] = None,
                         axis=None):
    """:func:`scale_sim_step` for ``quiet="on"``: run the SWIM front, then
    take a fixpoint branch (the counter tick and staleness aging, nothing
    else) when no alive node owes work, the round injects no event, its
    delivered SWIM traffic would change no table, and it is neither a sync
    nor a backstop round; else the dense round. The branch is taken on the
    host, on one device read of the predicate per round (none on a round
    the schedule already forces dense). Both branches give the same state
    as the dense round, bit for bit. On a mesh the predicate is one
    all-reduce, so every shard takes the same branch."""
    check_slice(cfg)
    if now is None:
        now = int(st.crdt.now)
    ax = node_axis(cfg, axis, st.crdt.now.device)
    k_swim, k_pig, k_sp, k_sync = prng.split(key, 4)
    front = _swim_front(cfg, st.swim, net, k_swim, kill=inp.kill, revive=inp.revive,
                        axis=axis)

    busy = _quiet_busy(cfg, st)
    input_quiet = ~(inp.kill.any() | inp.revive.any() | inp.write_mask.any()
                    | inp.tx_mask.any())
    now1 = now + 1  # the dense round gates sync after the tick
    bs = max(1, cfg.quiet_backstop_interval or cfg.sync_interval)
    schedule_ok = now1 % max(1, cfg.sync_interval) != 0 and now1 % bs != 0
    settled = ax.all(~busy.any() & input_quiet & ~swim_front_disturbed(cfg, front),
                     "quiet.settled")
    quiet_ok = settled & schedule_ok

    if schedule_ok and bool(quiet_ok):
        arm("fixpoint")
        crdt = st.crdt._replace(
            now=st.crdt.now + 1,
            last_sync=torch.clamp(st.crdt.last_sync + 1, max=LAST_SYNC_CAP),
        )
        st_out = _narrow_carry(cfg, ScaleSimState(st.swim, crdt))
        zero = torch.zeros((), dtype=torch.int64, device=busy.device)
        info = {
            "acked": front.acked.sum(), "failed_probes": front.failed.sum(),
            "refutes": zero, "delivered": zero, "fresh": zero,
            "tx_completed": zero, "clock_drift_rejects": zero,
            "queued": (st.crdt.q_origin != NO_Q).sum(),
            "syncs": zero, "cells_pulled": zero, "versions_granted": zero,
            "serve_rejects": zero, **activity_info(cfg, st_out),
        }
    else:
        arm("dense")
        swim, swim_info = _swim_back(cfg, st.swim, front, axis=axis)
        st_out, info = _post_swim(cfg, st, net, swim, swim_info,
                                  list(front.channels), front.carried, k_pig,
                                  k_sp, k_sync, inp, now1, axis=axis)
    return st_out, {**ax.sum_info(info, "info"),
                    **_quiet_info(cfg, busy, quiet_ok, settled, schedule_ok, ax)}


def activity_masks(cfg: ScaleSimConfig, st: ScaleSimState) -> dict:
    """Per-node occupancy bits: queued changesets, buffered partials,
    outstanding version needs, running SWIM timers."""
    pending = _pending(st)
    return {
        "bcast": (st.crdt.q_origin != NO_Q).any(dim=1),
        "partials": (st.crdt.partials.origin != NO_SLOT).any(dim=1),
        "sync": (needs_count(st.crdt.book) > 0).any(dim=1),
        "probes": (pending & (st.swim.mem_timer > 0)).any(dim=1),
    }


def activity_info(cfg: ScaleSimConfig, st: ScaleSimState) -> dict:
    """The ``active_*`` round-info counts."""
    return {f"active_{k}": v.sum() for k, v in activity_masks(cfg, st).items()}


def _narrow_carry(cfg: ScaleSimConfig, st: ScaleSimState) -> ScaleSimState:
    """Re-narrow the small-range planes on round carry-out."""
    if not cfg.narrow_dtypes:
        return st
    dt, qdt = cfg.timer_dtype, cfg.q_dtype
    swim = st.swim._replace(
        mem_timer=st.swim.mem_timer.to(dt), mem_tx=st.swim.mem_tx.to(cfg.tx_dtype)
    )
    crdt = st.crdt._replace(
        q_cell=st.crdt.q_cell.to(dt),
        q_seq=st.crdt.q_seq.to(qdt),
        q_nseq=st.crdt.q_nseq.to(qdt),
        q_tx=st.crdt.q_tx.to(qdt),
        last_sync=st.crdt.last_sync.to(dt),
    )
    return ScaleSimState(swim, crdt)


def _round_input(inputs: ScaleRoundInput, r: int) -> ScaleRoundInput:
    return ScaleRoundInput(*(a[r] for a in inputs))


def scale_run_rounds_carry(cfg: ScaleSimConfig, st, net: NetModel, key, inputs,
                           axis=None):
    """Run the stacked rounds in a Python loop. Returns ``((state, key),
    infos)`` with every info key stacked over rounds; chaining carries
    reproduces one straight run bit for bit. ``cfg.quiet == "on"`` runs
    :func:`scale_sim_step_quiet`; "auto" and "off" run the dense round.
    ``axis``: a mesh shard's view of the node axis (``parallel/mesh.py``);
    None runs the whole axis on one device."""
    check_slice(cfg)
    step = scale_sim_step_quiet if cfg.quiet == "on" else scale_sim_step
    rounds = inputs.kill.shape[0]
    now = int(st.crdt.now)  # the host mirror's start
    infos = []
    for r in range(rounds):
        key, sub = prng.split(key)
        if axis is not None:
            axis.next_round()
        st, info = step(cfg, st, net, sub, _round_input(inputs, r), now=now,
                        axis=axis)
        now += 1
        infos.append(info)
    stacked = {k: torch.stack([i[k] for i in infos]) for k in infos[0]} if infos else {}
    return (st, key), stacked


def scale_run_rounds(cfg: ScaleSimConfig, st, net: NetModel, key, inputs,
                     axis=None):
    """The round loop over stacked per-round inputs: ``(state, infos)``."""
    (st, _key), infos = scale_run_rounds_carry(cfg, st, net, key, inputs, axis=axis)
    return st, infos


def scale_crdt_metrics(cfg: ScaleSimConfig, st: ScaleSimState) -> dict:
    """Convergence predicate at scale: every alive replica holds the
    reference node's store, equal heads wherever the same actor is tracked,
    and no outstanding needs."""
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
    alive_slots = alive.to(torch.float32).sum() * aligned.shape[1]
    org_aligned_frac = (aligned & alive[:, None]).to(torch.float32).sum() / torch.clamp(
        alive_slots, min=1.0)
    store_ok = (~alive) | same_store
    swim_m = {f"swim_{k}": v for k, v in scale_swim_metrics(st.swim).items()}
    return {
        "converged": ok.all(),
        "store_converged": store_ok.all(),
        "n_store_diverged": (~store_ok).sum(),
        "n_diverged": (~ok).sum(),
        "total_needs": torch.where(alive[:, None], torch.clamp(needs, min=0), 0).sum(),
        "org_aligned_frac": org_aligned_frac,
        **swim_m,
    }
