"""SWIM membership over the full [N, N] view (port of
``corrosion_tpu/sim/swim.py``).

All N nodes run one probe period at once. A node's view of every other
node is one packed int32 (``incarnation * 4 + state``; -1 = unknown), so
applying a membership update is a scatter-max. Probe targets, indirect
helpers, announce targets and piggyback subjects are drawn by masked
uniform scores and ``argmax`` / stable ``top_k`` (the lowest index wins a
tie, as in JAX). Every draw uses the JAX package's key and shape, so the
round equals it bit for bit.

The scatters are order-free: maxima go through ``scatter_reduce_(...,
"amax")`` and the budget decrement through integer sums; entries the JAX
code drops (index ``n * n``) land in a scratch element past the end.

``swim_step(..., axis=)`` runs one mesh shard's rows of the round
(``parallel/mesh.py``): the draws take the shard's rows of each whole
draw, and the accesses to other nodes' rows (the probe target's notice,
the announce, the packets that carry another node's selection, the
piggyback scatter and the budget counts) go through the axis's exchanges.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.ops.lww import STATE_ALIVE, STATE_DOWN, STATE_SUSPECT
from corrosion_tpu_torch.parallel.exchange import NodeAxis
from corrosion_tpu_torch.sim.transport import NetModel, datagram_ok, whole_nodes

UNKNOWN = -1


class SwimState(NamedTuple):
    alive: torch.Tensor  # bool [N] — ground-truth process liveness
    incarnation: torch.Tensor  # int32 [N]
    view: torch.Tensor  # int32 [N, N] — packed (inc, state); -1 unknown
    suspect_timer: torch.Tensor  # int32 [N, N]
    tx_left: torch.Tensor  # int32 [N, N] — piggyback budget per belief

    @staticmethod
    def create(cfg, n_seeds: int = 4, device="cuda") -> "SwimState":
        """Everyone up; each node knows itself and the first ``n_seeds``
        nodes (the bootstrap list)."""
        dev = resolve_device(device)
        n = cfg.n_nodes
        view = torch.full((n, n), UNKNOWN, dtype=torch.int32, device=dev)
        view[:, : max(1, n_seeds)] = STATE_ALIVE
        view.diagonal().fill_(STATE_ALIVE)
        return SwimState(
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            incarnation=torch.zeros(n, dtype=torch.int32, device=dev),
            view=view,
            suspect_timer=torch.zeros((n, n), dtype=torch.int32, device=dev),
            tx_left=torch.full((n, n), cfg.max_transmissions, dtype=torch.int32,
                               device=dev),
        )


def bootstrap_members(st: SwimState, member_ids, incarnations=None) -> SwimState:
    """Seed every node's view with a persisted member list (ids outside
    ``[0, N)`` are dropped)."""
    n = st.view.shape[0]
    ids = np.asarray(member_ids, np.int32)
    incs = (np.asarray(incarnations, np.int32) if incarnations is not None
            else np.zeros(ids.shape, np.int32))
    in_range = (ids >= 0) & (ids < n)
    ids, incs = ids[in_range], incs[in_range]
    if ids.size == 0:
        return st
    dev = st.view.device
    cols = torch.from_numpy(ids.astype(np.int64)).to(dev)
    keys = torch.from_numpy(incs * 4 + STATE_ALIVE).to(dev)
    return st._replace(view=_scatter_max(
        st.view, torch.arange(n, device=dev)[:, None] * n + cols[None, :],
        keys[None, :].expand(n, -1)))


def _scatter_max(plane, flat, vals):
    """``plane.flat[flat] = max(plane.flat[flat], vals)``; indices equal to
    ``plane.numel()`` are dropped."""
    n_el = plane.numel()
    out = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
    out.scatter_reduce_(0, flat.reshape(-1).long(), vals.reshape(-1).to(plane.dtype),
                        "amax", include_self=True)
    return out[:n_el].reshape(plane.shape)


def _diag_max(view, vals, cols):
    """``view[i, cols[i]] = max(view[i, cols[i]], vals[i])`` for every row
    ``i`` (``cols``: the rows' node ids, the diagonal of their rows)."""
    idx = torch.arange(view.shape[0], device=view.device)
    out = view.clone()
    out[idx, cols] = torch.maximum(view[idx, cols], vals)
    return out


def _max_at(ax, view, row, col, vals, site, valid=None):
    """``view[row, col] = max(view[row, col], vals)`` at node ids (the rows
    of any node), where ``valid``: the order-free scatter-max. On a mesh
    shard every shard's entries are gathered and each owner applies those
    that fall in its rows."""
    n = ax.n
    if ax.is_whole:
        flat = row.long() * n + col.long()
        if valid is not None:
            flat = torch.where(valid, flat, n * n)
        return _scatter_max(view, flat, vals)
    i32 = torch.int32
    row = row.reshape(-1).to(i32)
    if valid is not None:
        row = torch.where(valid.reshape(-1), row, -1)
    got = ax.all_gather(torch.stack(
        [row, col.reshape(-1).to(i32), vals.reshape(-1).to(i32)], dim=1), site)
    mine = (got[:, 0] >= ax.lo) & (got[:, 0] < ax.hi)
    flat = torch.where(mine, (got[:, 0] - ax.lo).long() * n + got[:, 1].long(),
                       ax.rows * n)
    return _scatter_max(view, flat, got[:, 2])


def _announce(ax, view, old_view, al, gid, vals):
    """The announce's two accesses to the target's row: the write
    ``view[al, gid] = max(view[al, gid], vals)`` and the read
    ``old_view[al, gid]``. On a mesh shard the targets' rows are remote:
    the ``(al, gid, vals)`` triples are gathered, each owner applies the
    writes in its rows and answers the reads from them, and the answers
    come back by the owner maximum (one owner holds each entry)."""
    if ax.is_whole:
        view[al, gid] = torch.maximum(view[al, gid], vals)
        return view, old_view[al, gid]
    asks = ax.all_gather(torch.stack([al.to(torch.int32), gid.to(torch.int32), vals],
                                     dim=1), "swim.announce")
    mine = (asks[:, 0] >= ax.lo) & (asks[:, 0] < ax.hi)
    r = torch.where(mine, asks[:, 0] - ax.lo, 0).long()
    c = asks[:, 1].long()
    view = _scatter_max(view, torch.where(mine, r * ax.n + c, ax.rows * ax.n), asks[:, 2])
    answer = torch.where(mine, old_view[r, c], torch.iinfo(torch.int32).min)
    return view, ax.owner_max(answer, "swim.answer")


def _node_rows(ax, subj, payload, sel_ok, self_key):
    """Every node's piggyback selection, payload and self key, for the
    packets that carry another node's: the rows as they are on the whole
    axis, all rows gathered in one exchange on a mesh shard."""
    if ax.is_whole:
        return subj, payload, sel_ok, self_key
    u = subj.shape[1]
    got = ax.all_gather(torch.cat([subj.to(torch.int32), payload, sel_ok.to(torch.int32),
                                   self_key[:, None]], dim=1), "swim.rows")
    return (got[:, :u].long(), got[:, u:2 * u], got[:, 2 * u:3 * u] != 0,
            got[:, 3 * u].contiguous())


def swim_step(cfg, st: SwimState, net: NetModel, key, kill=None, revive=None,
              axis=None):
    """One SWIM probe period for all nodes. Returns ``(state, info)``.
    ``axis`` (``parallel/exchange.NodeAxis``): a mesh shard's view of the
    node axis, whose rows of every plane ``st`` holds (node ids stay
    global; the info counts are its rows' own); None runs the whole axis
    on one device."""
    n = cfg.n_nodes
    dev = st.view.device
    ax = NodeAxis.whole(n, dev) if axis is None else axis
    r0 = ax.lo
    iarr = ax.ids()
    gid = iarr.long()
    # local row indices, and every node's id (both ``gid`` on the whole axis)
    rows = gid if ax.is_whole else torch.arange(ax.rows, device=dev)
    cols = iarr if ax.is_whole else torch.arange(n, dtype=torch.int32, device=dev)
    k_tgt, k_p1, k_p2, k_help, k_ind, k_pri, k_announce = prng.split(key, 7)
    eye = ax.eye()

    def draw(k, shape):
        return prng.uniform(k, shape, dev, row0=r0)

    def scores(mask, k):
        u = draw(k, mask.shape)
        return torch.where(mask, u, torch.full_like(u, -1.0))

    # --- churn --------------------------------------------------------------
    none = torch.zeros(ax.rows, dtype=torch.bool, device=dev)
    kill = none if kill is None else kill
    revive = none if revive is None else revive
    alive = (st.alive & ~kill) | revive
    inc = st.incarnation + revive.to(torch.int32)
    net_all, alive_all = whole_nodes(ax, net, alive, "swim.card")

    old_view = st.view
    self_key = inc * 4 + STATE_ALIVE
    view = _diag_max(old_view, torch.where(alive, self_key, UNKNOWN), gid)

    # --- probe target: one believed-alive member, uniformly ----------------
    believed_alive = (view >= 0) & ((view & 3) == STATE_ALIVE) & ~eye
    tgt = torch.argmax(scores(believed_alive, k_tgt), dim=1).to(torch.int32)
    has_tgt = alive & believed_alive.any(dim=1)

    # --- direct probe + ack -------------------------------------------------
    leg_out = datagram_ok(net_all, k_p1, alive_all, iarr, tgt, row0=r0)
    leg_back = datagram_ok(net_all, k_p2, alive_all, tgt, iarr, row0=r0)
    probe_ok = has_tgt & leg_out & leg_back

    # --- indirect probes through n_indirect helpers -------------------------
    h_val, helpers = prng.top_k(
        scores(believed_alive & (cols[None, :] != tgt[:, None]), k_help),
        max(1, cfg.n_indirect))
    helpers = helpers.to(torch.int32)
    h_valid = h_val >= 0
    k1, k2, k3, k4 = prng.split(k_ind, 4)
    src = iarr[:, None].expand(helpers.shape)
    tgt_b = tgt[:, None].expand(helpers.shape)
    ind_leg = (
        datagram_ok(net_all, k1, alive_all, src, helpers, row0=r0)
        & datagram_ok(net_all, k2, alive_all, helpers, tgt_b, row0=r0)
        & datagram_ok(net_all, k3, alive_all, tgt_b, helpers, row0=r0)
        & datagram_ok(net_all, k4, alive_all, helpers, src, row0=r0)
    )
    ind_ok = (h_valid & ind_leg).any(dim=1) & has_tgt
    acked = probe_ok | ind_ok
    failed = has_tgt & ~acked

    # --- suspicion start, and its notice to the target ----------------------
    tl = tgt.long()
    cur_tgt = view[rows, tl]
    suspect_key = (cur_tgt >> 2) * 4 + STATE_SUSPECT
    view[rows, tl] = torch.maximum(cur_tgt, torch.where(failed, suspect_key, UNKNOWN))
    notify_ok = failed & datagram_ok(net_all, prng.fold_in(k_p1, 1), alive_all, iarr,
                                     tgt, row0=r0)
    view = _max_at(ax, view, tl, tl, torch.where(notify_ok, suspect_key, UNKNOWN),
                   "swim.notice")

    # --- periodic announce to a random ever-known member --------------------
    k_ann, k_annt, k_ann1, k_ann2 = prng.split(k_announce, 4)
    announcing = alive & (
        draw(k_ann, (ax.rows,))
        < torch.tensor(1.0 / max(1, cfg.announce_interval), dtype=torch.float32,
                       device=dev))
    known = (view >= 0) & ~eye
    ann_tgt = torch.argmax(scores(known, k_annt), dim=1).to(torch.int32)
    announcing = announcing & known.any(dim=1)
    ann_out = announcing & datagram_ok(net_all, k_ann1, alive_all, iarr, ann_tgt, row0=r0)
    ann_back = ann_out & datagram_ok(net_all, k_ann2, alive_all, ann_tgt, iarr, row0=r0)
    al = ann_tgt.long()
    view, bel = _announce(ax, view, old_view, al, gid,
                          torch.where(ann_out, self_key, UNKNOWN))
    notice = ann_back & (bel >= 0) & ((bel & 3) != STATE_ALIVE)
    view = _diag_max(view, torch.where(notice, bel, UNKNOWN), gid)

    # --- piggyback gossip on probe, ack, announce and its reply -------------
    sel_val, subj = prng.top_k(scores(st.tx_left > 0, k_pri), cfg.piggyback)
    sel_ok = sel_val >= 0
    payload = torch.gather(view, 1, subj)  # [N, U]
    subj_n, payload_n, sel_ok_n, self_key_n = _node_rows(ax, subj, payload, sel_ok,
                                                         self_key)

    def own(x):
        return x[:, None].expand(subj.shape)

    parts = [
        (own(tgt), subj, payload, (has_tgt & leg_out)[:, None] & sel_ok),
        (own(iarr), subj_n[tl], payload_n[tl], probe_ok[:, None] & sel_ok_n[tl]),
        (own(ann_tgt), subj, payload, ann_out[:, None] & sel_ok),
        (own(iarr), subj_n[al], payload_n[al], ann_back[:, None] & sel_ok_n[al]),
    ]
    # every delivered packet also asserts its sender alive at its incarnation
    asserts = [
        (tgt, iarr, self_key, has_tgt & leg_out),
        (iarr, tgt, self_key_n[tl], probe_ok),
        (ann_tgt, iarr, self_key, ann_out),
        (iarr, ann_tgt, self_key_n[al], ann_back),
    ]
    recv = torch.cat([p[0].reshape(-1) for p in parts] + [a[0] for a in asserts])
    subjects = torch.cat([p[1].reshape(-1) for p in parts] + [a[1] for a in asserts])
    keys_m = torch.cat([p[2].reshape(-1) for p in parts] + [a[2] for a in asserts])
    valid_m = torch.cat([p[3].reshape(-1) for p in parts] + [a[3] for a in asserts])
    view = _max_at(ax, view, recv, subjects, keys_m, "swim.gossip", valid=valid_m)

    # --- piggyback budgets burn on every attempted send ---------------------
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    heard = ax.owner_add(
        zeros.index_add(0, tl, (leg_out & alive_all[tl]).to(torch.int32))
        + zeros.index_add(0, al, ann_back.to(torch.int32)), "swim.sends")
    sends = has_tgt.to(torch.int32) + announcing.to(torch.int32) + heard
    dec = torch.where(sel_ok, rows[:, None] * n + subj, ax.rows * n)
    tx_left = torch.cat([st.tx_left.reshape(-1), st.tx_left.new_zeros(1)])
    tx_left.scatter_add_(0, dec.reshape(-1), -sends[:, None].expand(subj.shape).reshape(-1))
    tx_left = torch.clamp(tx_left[: ax.rows * n].reshape(ax.rows, n), min=0)

    # --- suspicion timers: arm, tick, expire to Down ------------------------
    changed = view != old_view
    is_suspect = (view >= 0) & ((view & 3) == STATE_SUSPECT)
    newly = changed & is_suspect
    timer = torch.where(newly, cfg.suspicion_rounds, st.suspect_timer)
    ticking = is_suspect & ~newly & alive[:, None]
    timer = torch.where(ticking, timer - 1, timer)
    expired = is_suspect & (timer <= 0) & alive[:, None]
    view = torch.where(expired, (view >> 2) * 4 + STATE_DOWN, view)

    # --- refutation: hearing myself suspected/down bumps my incarnation -----
    selfv = view[rows, gid]
    refute = alive & (selfv >= 0) & ((selfv & 3) != STATE_ALIVE)
    inc = torch.where(refute, (selfv >> 2) + 1, inc)
    view[rows, gid] = torch.where(alive, inc * 4 + STATE_ALIVE, selfv)

    # --- fresh news gets a fresh dissemination budget ------------------------
    tx_left = torch.where(view != old_view, cfg.max_transmissions, tx_left)

    info = {
        "acked": acked.sum(),
        "failed_probes": failed.sum(),
        "refutes": refute.sum(),
    }
    return SwimState(alive, inc, view, timer, tx_left), info


def swim_metrics(st: SwimState) -> dict:
    """Every alive viewer sees alive subjects Alive and dead ones Down or
    unknown."""
    state = st.view & 3
    known = st.view >= 0
    ok = torch.where(st.alive[None, :], known & (state == STATE_ALIVE),
                     ~known | (state == STATE_DOWN))
    viewer = st.alive[:, None]
    n = st.alive.shape[0]
    correct = (ok & viewer).sum(dtype=torch.int32)
    want = viewer.sum(dtype=torch.int32) * n
    return {
        "accuracy": correct / torch.clamp(want, min=1),
        "converged": correct == want,
        "n_alive": st.alive.sum(),
    }
