"""Large-cluster SWIM with bounded ``[N, M]`` member tables (port of
``corrosion_tpu/sim/scale.py``).

Each node tracks at most M members in a globally hash-slotted table
(subject ``s`` lives in slot ``s % M``), so a gossip packet is the
sender's aligned row and receiving it is a row gather plus an elementwise
merge; with ``pig_members = k > 0`` a packet is instead a bounded list of
the sender's k freshest entries, each merged at its hash class. The round
splits into a front half (churn, probe/indirect/announce legs, one sender
elected per receiver) and a back half (row gathers, then the row-local
table update that the swim kernel runs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.ops.dense import (
    lookup_cols,
    scatter_cols_add,
    scatter_cols_max,
    scatter_cols_set,
    select_cols,
    take_rows,
)
from corrosion_tpu_torch.ops.lww import (
    STATE_ALIVE,
    STATE_DOWN,
    STATE_SUSPECT,
    pack_inc_state,
)
from corrosion_tpu_torch.ops.select import sample_k, sample_k_biased, sample_one
from corrosion_tpu_torch.sim.config import FUSED_MODES
from corrosion_tpu_torch.sim.transport import (
    CARD_EXTRA,
    NetModel,
    card_at,
    datagram_ok_c,
    link_card,
)

FREE = -1


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """Static shapes/constants for the bounded-table simulator."""

    n_nodes: int
    m_slots: int = 64
    n_seeds: int = 4
    n_indirect: int = 3
    suspicion_rounds: int = 6
    max_transmissions: int = 10
    announce_interval: int = 16
    down_purge_rounds: int = 64
    pig_members: int = 0
    narrow_dtypes: bool = False
    narrow_int8: bool = False
    fused: str = "auto"

    def validate(self) -> "ScaleConfig":
        if self.m_slots <= 0 or self.n_seeds < 1:
            raise ValueError(
                f"need m_slots > 0 and n_seeds >= 1, got "
                f"{self.m_slots}/{self.n_seeds}"
            )
        if self.n_nodes > 1 << 30:
            raise ValueError(
                f"n_nodes {self.n_nodes} > 2^30: sender-election packs "
                f"priority + node id in one int32 word"
            )
        if not 0 <= self.pig_members <= self.m_slots:
            raise ValueError(
                f"pig_members {self.pig_members} must be 0..m_slots "
                f"({self.m_slots}) (top_k over the slot axis)"
            )
        if self.narrow_dtypes and max(
                self.max_transmissions, self.suspicion_rounds,
                self.down_purge_rounds) >= (1 << 15):
            raise ValueError(
                "narrow_dtypes stores timers/budgets as int16; a "
                "timer/budget bound exceeds int16 range"
            )
        if self.narrow_int8 and not self.narrow_dtypes:
            raise ValueError("narrow_int8 is a tier of narrow_dtypes; enable both")
        if self.narrow_int8 and self.max_transmissions >= (1 << 7):
            raise ValueError(
                "narrow_int8 stores mem_tx as int8; max_transmissions "
                f"{self.max_transmissions} exceeds int8 range"
            )
        if self.fused not in FUSED_MODES:
            raise ValueError(f"fused {self.fused!r} not one of {FUSED_MODES}")
        return self

    @property
    def timer_dtype(self):
        return torch.int16 if self.narrow_dtypes else torch.int32

    @property
    def tx_dtype(self):
        return torch.int8 if self.narrow_int8 else self.timer_dtype


def scale_config(n_nodes: int, **overrides) -> ScaleConfig:
    """Cluster-size-adaptive defaults (budgets grow with log N)."""
    log_n = max(1, math.ceil(math.log2(max(2, n_nodes))))
    defaults = dict(
        m_slots=min(64, max(8, n_nodes // 2)),
        max_transmissions=log_n + 4,
        suspicion_rounds=max(4, log_n),
        down_purge_rounds=8 * max(4, log_n),
    )
    defaults.update(overrides)
    return ScaleConfig(n_nodes=n_nodes, **defaults).validate()


class ScaleSwimState(NamedTuple):
    alive: torch.Tensor  # bool  [N]
    inc: torch.Tensor  # int32 [N]
    mem_id: torch.Tensor  # int32 [N, M] — subject id per slot, -1 free
    mem_view: torch.Tensor  # int32 [N, M] — packed (inc, state), -1 free
    mem_timer: torch.Tensor  # timer dtype [N, M]
    mem_tx: torch.Tensor  # tx dtype [N, M]

    @staticmethod
    def create(cfg, device="cuda") -> "ScaleSwimState":
        dev = resolve_device(device)
        n, m = cfg.n_nodes, cfg.m_slots
        iarr = torch.arange(n, dtype=torch.int32, device=dev)
        mem_id = torch.full((n, m), FREE, dtype=torch.int32, device=dev)
        mem_view = torch.full((n, m), FREE, dtype=torch.int32, device=dev)
        alive_key = pack_inc_state(0, STATE_ALIVE)
        for s in range(min(cfg.n_seeds, n)):
            mem_id[:, s % m] = s
            mem_view[:, s % m] = alive_key
        rows = iarr.long()
        mem_id[rows, rows % m] = iarr
        mem_view[rows, rows % m] = alive_key
        return ScaleSwimState(
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            inc=torch.zeros(n, dtype=torch.int32, device=dev),
            mem_id=mem_id,
            mem_view=mem_view,
            mem_timer=torch.zeros((n, m), dtype=cfg.timer_dtype, device=dev),
            mem_tx=torch.full((n, m), cfg.max_transmissions,
                              dtype=cfg.tx_dtype, device=dev),
        )


def bootstrap_members(st: ScaleSwimState, member_ids,
                      incarnations=None) -> ScaleSwimState:
    """Seed every node's bounded member table with a persisted member list
    (ids outside ``[0, N)`` are dropped). Entries land in their hash
    class; where two ids share a class the later one is kept, and each
    node's own entry wins its class back."""
    n, m = st.mem_id.shape
    ids = np.asarray(member_ids, np.int32)
    incs = (np.asarray(incarnations, np.int32) if incarnations is not None
            else np.zeros(ids.shape, np.int32))
    in_range = (ids >= 0) & (ids < n)
    by_slot = {int(i) % m: (int(i), int(inc))
               for i, inc in zip(ids[in_range], incs[in_range])}
    if not by_slot:
        return st
    dev = st.mem_id.device
    slots = torch.tensor(list(by_slot), dtype=torch.int64, device=dev)
    vals = torch.tensor(list(by_slot.values()), dtype=torch.int32, device=dev)
    mem_id = st.mem_id.clone()
    mem_view = st.mem_view.clone()
    mem_id[:, slots] = vals[:, 0][None, :]
    mem_view[:, slots] = pack_inc_state(vals[:, 1], STATE_ALIVE)[None, :]
    rows = torch.arange(n, device=dev)
    mem_id[rows, rows % m] = rows.to(torch.int32)
    mem_view[rows, rows % m] = pack_inc_state(st.inc, STATE_ALIVE)
    return st._replace(mem_id=mem_id, mem_view=mem_view)


def _election_pri_bits(n: int) -> int:
    """Random-priority width of the sender election (12 bits while the id
    width leaves room; priority + id always fit one non-negative int32)."""
    bits = max(1, n - 1).bit_length()
    pri_bits = min(12, 31 - bits)
    if pri_bits < 1:
        raise ValueError(
            f"sender election has no priority bit left above {bits} id "
            f"bits (n_nodes {n} > 2^30)"
        )
    return pri_bits


def _one_sender_per_receiver(n, src_valid, tgt, key):
    """One sender per receiver: a random priority packed above the sender
    id, resolved by one scatter-max. Returns ``(sender_of, has_sender)``."""
    dev = src_valid.device
    bits = max(1, n - 1).bit_length()
    pri = prng.randint(key, (n,), 0, 1 << _election_pri_bits(n), dev)
    packed = torch.where(
        src_valid, (pri << bits) | torch.arange(n, dtype=torch.int32, device=dev), -1
    )
    best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, tgt.long(), packed, "amax", include_self=True)
    return best & ((1 << bits) - 1), best >= 0


def swim_tables_update(
    consts,
    mem_id, mem_view, old_id, old_view, mem_timer, mem_tx,
    alive, inc, node_id, self_slot, sus_heard, sends,
    probe_slot, suspect_key, probe_failed,
    ch_in_id, ch_in_view, ch_in_sendable, ch_valid, ch_snd, ch_snd_inc,
):
    """The row-local back half of a SWIM round: the suspect mark, four
    packet merges, sender-alive assertions, send-budget decrement,
    suspicion/down timers, purge, refutation, self refresh and budget
    refill. Returns ``(mem_id, mem_view, timer, mem_tx, inc,
    refute)``; timer and budget stay at the dtype they came in.

    ``consts`` may carry a 5th element ``pig_k``: when > 0 the channels are
    bounded packets, ``ch_in_id``/``ch_in_view`` [N, pig_k] packed entry
    lists whose entries apply one by one at their hash class ``id % m``
    (each lookup sees the earlier entries' writes). The caller then owns
    the budget decrement of the entries it sent, so the full-row decrement
    is skipped; the refill on change stays here."""
    m, suspicion_rounds, down_purge_rounds, max_transmissions = consts[:4]
    pig_k = consts[4] if len(consts) > 4 else 0
    timer_dtype, tx_dtype = mem_timer.dtype, mem_tx.dtype
    iarr = node_id

    mem_view = scatter_cols_max(
        mem_view, probe_slot[:, None], suspect_key[:, None], probe_failed[:, None]
    )

    sendable = mem_tx > 0
    for in_id, in_view, in_sendable, valid in zip(
        ch_in_id, ch_in_view, ch_in_sendable, ch_valid
    ):
        if pig_k > 0:
            for j in range(pig_k):
                idj, vwj = in_id[:, j], in_view[:, j]
                okj = valid & (idj >= 0)
                slotj = (idj % m)[:, None]
                curid = lookup_cols(mem_id, slotj)[:, 0]
                curvw = lookup_cols(mem_view, slotj, fill=-1)[:, 0]
                same = okj & (curid == idj)
                ins = okj & (curid < 0)
                take = (
                    okj
                    & (curid >= 0)
                    & (curid != idj)
                    & ((curvw & 3) == STATE_DOWN)
                    & ((vwj & 3) == STATE_ALIVE)
                )
                new_vw = torch.where(same, torch.maximum(curvw, vwj), vwj)
                mem_view = scatter_cols_set(mem_view, slotj, new_vw[:, None],
                                            (same | ins | take)[:, None])
                mem_id = scatter_cols_set(mem_id, slotj, idj[:, None],
                                          (ins | take)[:, None])
            continue
        ok = valid[:, None] & (in_id >= 0) & in_sendable
        same = ok & (mem_id == in_id)
        ins = ok & (mem_id < 0)
        take = (
            ok
            & (mem_id >= 0)
            & (mem_id != in_id)
            & ((mem_view & 3) == STATE_DOWN)
            & ((in_view & 3) == STATE_ALIVE)
        )
        mem_view = torch.where(same, torch.maximum(mem_view, in_view), mem_view)
        mem_view = torch.where(ins | take, in_view, mem_view)
        mem_id = torch.where(ins | take, in_id, mem_id)

    for snd, valid, s_inc in zip(ch_snd, ch_valid, ch_snd_inc):
        s_key = pack_inc_state(s_inc, STATE_ALIVE)
        slot = (snd % m)[:, None]
        cur_id = lookup_cols(mem_id, slot)[:, 0]
        same1 = cur_id == snd
        free1 = cur_id < 0
        mem_view = scatter_cols_max(
            mem_view, slot, s_key[:, None], (valid & (same1 | free1))[:, None]
        )
        mem_id = scatter_cols_set(mem_id, slot, snd[:, None], (valid & free1)[:, None])

    mem_tx = mem_tx.to(torch.int32)
    if pig_k == 0:
        mem_tx = torch.clamp(
            torch.where(sendable, mem_tx - sends[:, None], mem_tx), min=0)

    alive2 = alive[:, None]
    occupied = mem_id >= 0
    changed = (mem_view != old_view) | (mem_id != old_id)
    is_suspect = occupied & (mem_view >= 0) & ((mem_view & 3) == STATE_SUSPECT)
    newly = changed & is_suspect
    timer = torch.where(newly, suspicion_rounds, mem_timer.to(torch.int32))
    ticking = is_suspect & ~newly & alive2
    timer = torch.where(ticking, timer - 1, timer)
    expired = is_suspect & (timer <= 0) & alive2
    mem_view = torch.where(expired, (mem_view >> 2) * 4 + STATE_DOWN, mem_view)

    is_down = occupied & (mem_view >= 0) & ((mem_view & 3) == STATE_DOWN)
    newly_down = expired | (changed & is_down)
    timer = torch.where(is_down & newly_down, down_purge_rounds, timer)
    timer = torch.where(is_down & ~newly_down & alive2, timer - 1, timer)
    purge = is_down & (timer <= 0) & alive2
    mem_id = torch.where(purge, FREE, mem_id)
    mem_view = torch.where(purge, FREE, mem_view)

    id_at_self = lookup_cols(mem_id, self_slot[:, None])[:, 0]
    view_at_self = lookup_cols(mem_view, self_slot[:, None], fill=-1)[:, 0]
    self_gossip = torch.where(id_at_self == iarr, view_at_self, -1)
    heard = torch.maximum(sus_heard, self_gossip)
    refute = alive & (heard >= inc * 4 + STATE_SUSPECT)
    inc = torch.where(refute, (heard >> 2) + 1, inc)
    self_key = pack_inc_state(inc, STATE_ALIVE)
    cols = torch.arange(m, dtype=torch.int32, device=mem_id.device)
    own = (self_slot[:, None] == cols[None, :]) & alive2
    mem_view = torch.where(own, self_key[:, None], mem_view)
    mem_id = torch.where(own, iarr[:, None], mem_id)

    changed = (mem_view != old_view) | (mem_id != old_id)
    mem_tx = torch.where(changed, max_transmissions, mem_tx)
    return (mem_id, mem_view, timer.to(timer_dtype), mem_tx.to(tx_dtype),
            inc, refute)


class _SwimFront(NamedTuple):
    """First half of the SWIM round (see ``corrosion_tpu.sim.scale``)."""

    alive: torch.Tensor
    inc: torch.Tensor
    mem_id: torch.Tensor
    mem_view: torch.Tensor
    self_slot: torch.Tensor
    sus_heard: torch.Tensor
    sends: torch.Tensor
    probe_slot: torch.Tensor
    suspect_key: torch.Tensor
    failed: torch.Tensor
    acked: torch.Tensor
    ann_tgt: torch.Tensor
    ann_back: torch.Tensor
    channels: tuple
    ch_snd_inc: tuple
    carried: torch.Tensor
    k_upd: torch.Tensor


def _swim_front(cfg, st: ScaleSwimState, net: NetModel, key, kill=None,
                revive=None) -> _SwimFront:
    """Front half of the SWIM probe period: churn, self refresh, probe,
    indirect and announce legs, elections, delivered-packet counts."""
    n, m = cfg.n_nodes, cfg.m_slots
    dev = st.mem_id.device
    iarr = torch.arange(n, dtype=torch.int32, device=dev)
    (k_tgt, k_p1, k_p2, k_help, k_ind, k_ann, k_annt, k_ann1, k_ann2,
     k_cp, k_ca, k_upd) = prng.split(key, 12)

    kill = torch.zeros(n, dtype=torch.bool, device=dev) if kill is None else kill
    revive = torch.zeros(n, dtype=torch.bool, device=dev) if revive is None else revive
    alive = (st.alive & ~kill) | revive
    inc = st.inc + revive.to(torch.int32)

    self_slot = iarr % m
    cols = torch.arange(m, dtype=torch.int32, device=dev)
    own = (self_slot[:, None] == cols[None, :]) & alive[:, None]
    self_key = pack_inc_state(inc, STATE_ALIVE)
    mem_id = torch.where(own, iarr[:, None], st.mem_id)
    mem_view = torch.where(own, self_key[:, None], st.mem_view)

    occupied = mem_id >= 0
    not_self = mem_id != iarr[:, None]
    bel_alive = occupied & not_self & (mem_view >= 0) & ((mem_view & 3) == STATE_ALIVE)

    card = link_card(net, alive, extra=(inc,))

    # --- probe target: one believed-alive table entry -------------------
    probe_slot, has_slot = sample_one(bel_alive, k_tgt)
    tgt = torch.clamp(select_cols(mem_id, probe_slot[:, None])[:, 0], min=0)
    has_tgt = alive & has_slot
    tgt_card = card_at(card, tgt)
    leg_out = has_tgt & datagram_ok_c(net, k_p1, card, tgt_card)
    leg_back = datagram_ok_c(net, k_p2, tgt_card, card)
    probe_ok = leg_out & leg_back

    # --- indirect probes through helper entries -------------------------
    h_mask = bel_alive & (mem_id != tgt[:, None])
    h_slots, h_valid = sample_k(h_mask, max(1, cfg.n_indirect), k_help)
    helpers = torch.clamp(select_cols(mem_id, h_slots), min=0)
    k1, k2, k3, k4 = prng.split(k_ind, 4)
    helper_card = card_at(card, helpers)
    self_b = card[:, None, :]
    tgt_b = tgt_card[:, None, :]
    ind_leg = (
        datagram_ok_c(net, k1, self_b, helper_card)
        & datagram_ok_c(net, k2, helper_card, tgt_b)
        & datagram_ok_c(net, k3, tgt_b, helper_card)
        & datagram_ok_c(net, k4, helper_card, self_b)
    )
    ind_ok = (h_valid & ind_leg).any(dim=1) & has_tgt
    acked = probe_ok | ind_ok
    failed = has_tgt & ~acked

    # --- failed probe: suspect the entry, notify the subject -------------
    cur = select_cols(mem_view, probe_slot[:, None])[:, 0]
    suspect_key = (cur >> 2) * 4 + STATE_SUSPECT
    notify_ok = failed & datagram_ok_c(net, prng.fold_in(k_p1, 1), card, tgt_card)
    sus_heard = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sus_heard.scatter_reduce_(0, tgt.long(), torch.where(notify_ok, suspect_key, -1),
                              "amax", include_self=True)

    # --- announce to a random ever-known member (heal/rejoin path) ------
    announcing = alive & (
        prng.uniform(k_ann, (n,), dev)
        < torch.tensor(1.0 / max(1, cfg.announce_interval), dtype=torch.float32,
                       device=dev)
    )
    known = occupied & not_self
    ann_slot, has_known = sample_one(known, k_annt)
    ann_tgt = torch.clamp(select_cols(mem_id, ann_slot[:, None])[:, 0], min=0)
    # bootstrap fallback: a node that knows nobody announces to a seed
    seed_tgt = prng.randint(prng.fold_in(k_annt, 1), (n,), 0, min(cfg.n_seeds, n), dev)
    lonely = alive & ~has_known & (seed_tgt != iarr)
    ann_tgt = torch.where(lonely, seed_tgt, ann_tgt)
    has_known = has_known | lonely
    ann_card = card_at(card, ann_tgt)
    announcing = announcing & has_known
    ann_out = announcing & datagram_ok_c(net, k_ann1, card, ann_card)
    ann_back = ann_out & datagram_ok_c(net, k_ann2, ann_card, card)

    # --- choose one prober / announcer per receiver ----------------------
    prober_of, has_prober = _one_sender_per_receiver(n, leg_out, tgt, k_cp)
    announcer_of, has_announcer = _one_sender_per_receiver(n, ann_out, ann_tgt, k_ca)

    sends = (
        has_tgt.to(torch.int32)
        + announcing.to(torch.int32)
        + has_prober.to(torch.int32)
        + has_announcer.to(torch.int32)
    )
    channels = [
        (torch.clamp(prober_of, min=0), has_prober),
        (tgt, probe_ok),
        (torch.clamp(announcer_of, min=0), has_announcer),
        (ann_tgt, ann_back),
    ]
    ch_cards = [
        card_at(card, channels[0][0]),
        tgt_card,
        card_at(card, channels[2][0]),
        ann_card,
    ]
    ch_snd_inc = tuple(c[:, CARD_EXTRA] for c in ch_cards)

    # delivered-packet count per sender (the piggyback budget multiplicity)
    elect = torch.stack(
        [torch.clamp(prober_of, min=0), torch.clamp(announcer_of, min=0)], dim=1
    )
    g_tgt = card_at(elect, tgt)
    g_ann = card_at(elect, ann_tgt)
    probe_delivered = leg_out & (g_tgt[:, 0] == iarr)
    ann_delivered = ann_out & (g_ann[:, 1] == iarr)
    ack_count = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, tgt.long(), probe_ok.to(torch.int32))
    reply_count = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, ann_tgt.long(), ann_back.to(torch.int32))
    carried = (
        probe_delivered.to(torch.int32)
        + ann_delivered.to(torch.int32)
        + ack_count
        + reply_count
    )
    return _SwimFront(
        alive=alive, inc=inc, mem_id=mem_id, mem_view=mem_view,
        self_slot=self_slot, sus_heard=sus_heard, sends=sends,
        probe_slot=probe_slot, suspect_key=suspect_key, failed=failed,
        acked=acked, ann_tgt=ann_tgt, ann_back=ann_back,
        channels=tuple(channels), ch_snd_inc=ch_snd_inc,
        carried=carried, k_upd=k_upd,
    )


def _swim_back(cfg, st: ScaleSwimState, front: _SwimFront):
    """Back half of the SWIM probe period: the cross-node row gathers, then
    the row-local table update through the swim kernel wrapper."""
    from corrosion_tpu_torch.ops import megakernel

    n, m = cfg.n_nodes, cfg.m_slots
    dev = st.mem_id.device
    iarr = torch.arange(n, dtype=torch.int32, device=dev)
    old_id, old_view = st.mem_id, st.mem_view

    # down-notice: the announce receiver's belief about the announcer
    peer_view_rows = take_rows(old_view, front.ann_tgt)
    peer_id_rows = take_rows(old_id, front.ann_tgt)
    bel = select_cols(peer_view_rows, front.self_slot[:, None])[:, 0]
    bel_is_me = select_cols(peer_id_rows, front.self_slot[:, None])[:, 0] == iarr
    notice = torch.where(front.ann_back & bel_is_me, bel, -1)
    sus_heard = torch.maximum(front.sus_heard, notice)

    sendable = st.mem_tx > 0
    pig_k = int(cfg.pig_members)
    mem_tx_in = st.mem_tx
    ch_snd = [src for src, _ in front.channels]
    ch_valid = [valid for _, valid in front.channels]
    if pig_k > 0:
        # bounded packets: each packet carries its sender's pig_k sendable
        # entries with the most budget left (random tiebreak), one [N, 2k]
        # row gather per channel
        upd_slots, upd_ok = sample_k_biased(
            sendable & (old_id >= 0), st.mem_tx.to(torch.float32), pig_k,
            front.k_upd)
        upd_id = torch.where(upd_ok, select_cols(old_id, upd_slots), FREE)
        pig_pack = torch.cat([upd_id, select_cols(old_view, upd_slots)], dim=1)
        got = [take_rows(pig_pack, src) for src in ch_snd]
        ch_in_id = [g[:, :pig_k].contiguous() for g in got]
        ch_in_view = [g[:, pig_k:].contiguous() for g in got]
        ch_in_send = [torch.ones((n, pig_k), dtype=torch.bool, device=dev)] * 4
        # the selected entries' budget decrement, in the plane's own dtype
        dec = scatter_cols_add(
            torch.zeros((n, m), dtype=st.mem_tx.dtype, device=dev), upd_slots,
            front.sends[:, None].expand(upd_slots.shape), upd_ok)
        mem_tx_in = torch.clamp(st.mem_tx - dec, min=0)
    else:
        ch_in_id = [take_rows(old_id, src) for src in ch_snd]
        ch_in_view = [take_rows(old_view, src) for src in ch_snd]
        ch_in_send = [take_rows(sendable, src) for src in ch_snd]

    consts = (m, int(cfg.suspicion_rounds), int(cfg.down_purge_rounds),
              int(cfg.max_transmissions), pig_k)
    mem_id, mem_view, timer, mem_tx, inc, refute = megakernel.swim_tables_fused(
        consts,
        front.mem_id, front.mem_view, old_id, old_view, st.mem_timer,
        mem_tx_in, front.alive, front.inc, iarr, front.self_slot,
        sus_heard, front.sends, front.probe_slot, front.suspect_key,
        front.failed,
        ch_in_id, ch_in_view, ch_in_send, ch_valid, ch_snd,
        list(front.ch_snd_inc),
    )
    st2 = ScaleSwimState(front.alive, front.inc, mem_id, mem_view, timer, mem_tx)
    info = {
        "acked": front.acked.sum(),
        "failed_probes": front.failed.sum(),
        "refutes": refute.sum(),
    }
    return st2, info


def swim_front_disturbed(cfg, front: _SwimFront):
    """Would this round's delivered SWIM traffic change any membership
    table? A bool tensor, computed from the front half alone."""
    m = cfg.m_slots
    disturbed = front.failed.any()
    for (src, valid), s_inc in zip(front.channels, front.ch_snd_inc):
        s_key = pack_inc_state(s_inc, STATE_ALIVE)
        slot = (src % m)[:, None]
        cur_id = lookup_cols(front.mem_id, slot)[:, 0]
        cur_view = lookup_cols(front.mem_view, slot, fill=-1)[:, 0]
        would = valid & ((cur_id < 0) | ((cur_id == src) & (s_key > cur_view)))
        disturbed = disturbed | would.any()
    return disturbed


def scale_swim_step(cfg, st: ScaleSwimState, net: NetModel, key, kill=None,
                    revive=None):
    """One SWIM probe period for the whole cluster. Returns ``(state, info,
    channels, carried)``."""
    front = _swim_front(cfg, st, net, key, kill=kill, revive=revive)
    st2, info = _swim_back(cfg, st, front)
    return st2, info, list(front.channels), front.carried


def scale_swim_metrics(st: ScaleSwimState):
    """Belief accuracy over occupied entries of alive viewers."""
    n = st.alive.shape[0]
    iarr = torch.arange(n, dtype=torch.int32, device=st.alive.device)
    occ = (st.mem_id >= 0) & (st.mem_view >= 0)
    not_self = st.mem_id != iarr[:, None]
    subj_alive = take_rows(st.alive, torch.clamp(st.mem_id, min=0))
    state = st.mem_view & 3
    entry_ok = torch.where(subj_alive, state == STATE_ALIVE, state == STATE_DOWN)
    counted = occ & not_self & st.alive[:, None]
    correct = (entry_ok & counted).sum()
    total = torch.clamp(counted.sum(), min=1)
    return {
        "accuracy": correct / total,
        "mean_tracked": counted.sum() / torch.clamp(st.alive.sum(), min=1),
        "n_alive": st.alive.sum(),
    }
