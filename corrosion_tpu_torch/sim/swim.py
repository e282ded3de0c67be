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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch._device import resolve_device
from corrosion_tpu_torch.ops.lww import STATE_ALIVE, STATE_DOWN, STATE_SUSPECT
from corrosion_tpu_torch.sim.transport import NetModel, datagram_ok

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


def _diag_max(view, vals):
    n = view.shape[0]
    idx = torch.arange(n, device=view.device)
    out = view.clone()
    out[idx, idx] = torch.maximum(view[idx, idx], vals)
    return out


def swim_step(cfg, st: SwimState, net: NetModel, key, kill=None, revive=None):
    """One SWIM probe period for all nodes. Returns ``(state, info)``."""
    n = cfg.n_nodes
    dev = st.view.device
    iarr = torch.arange(n, dtype=torch.int32, device=dev)
    rows = iarr.long()
    k_tgt, k_p1, k_p2, k_help, k_ind, k_pri, k_announce = prng.split(key, 7)
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    def draw(k, shape):
        return prng.uniform(k, shape, dev)

    def scores(mask, k):
        u = draw(k, mask.shape)
        return torch.where(mask, u, torch.full_like(u, -1.0))

    # --- churn --------------------------------------------------------------
    kill = torch.zeros(n, dtype=torch.bool, device=dev) if kill is None else kill
    revive = torch.zeros(n, dtype=torch.bool, device=dev) if revive is None else revive
    alive = (st.alive & ~kill) | revive
    inc = st.incarnation + revive.to(torch.int32)

    old_view = st.view
    self_key = inc * 4 + STATE_ALIVE
    view = _diag_max(old_view, torch.where(alive, self_key, UNKNOWN))

    # --- probe target: one believed-alive member, uniformly ----------------
    believed_alive = (view >= 0) & ((view & 3) == STATE_ALIVE) & ~eye
    tgt = torch.argmax(scores(believed_alive, k_tgt), dim=1).to(torch.int32)
    has_tgt = alive & believed_alive.any(dim=1)

    # --- direct probe + ack -------------------------------------------------
    leg_out = datagram_ok(net, k_p1, alive, iarr, tgt)
    leg_back = datagram_ok(net, k_p2, alive, tgt, iarr)
    probe_ok = has_tgt & leg_out & leg_back

    # --- indirect probes through n_indirect helpers -------------------------
    h_val, helpers = prng.top_k(
        scores(believed_alive & (iarr[None, :] != tgt[:, None]), k_help),
        max(1, cfg.n_indirect))
    helpers = helpers.to(torch.int32)
    h_valid = h_val >= 0
    k1, k2, k3, k4 = prng.split(k_ind, 4)
    src = iarr[:, None].expand(helpers.shape)
    tgt_b = tgt[:, None].expand(helpers.shape)
    ind_leg = (
        datagram_ok(net, k1, alive, src, helpers)
        & datagram_ok(net, k2, alive, helpers, tgt_b)
        & datagram_ok(net, k3, alive, tgt_b, helpers)
        & datagram_ok(net, k4, alive, helpers, src)
    )
    ind_ok = (h_valid & ind_leg).any(dim=1) & has_tgt
    acked = probe_ok | ind_ok
    failed = has_tgt & ~acked

    # --- suspicion start, and its notice to the target ----------------------
    tl = tgt.long()
    cur_tgt = view[rows, tl]
    suspect_key = (cur_tgt >> 2) * 4 + STATE_SUSPECT
    view[rows, tl] = torch.maximum(cur_tgt, torch.where(failed, suspect_key, UNKNOWN))
    notify_ok = failed & datagram_ok(net, prng.fold_in(k_p1, 1), alive, iarr, tgt)
    view = _scatter_max(view, tl * n + tl, torch.where(notify_ok, suspect_key, UNKNOWN))

    # --- periodic announce to a random ever-known member --------------------
    k_ann, k_annt, k_ann1, k_ann2 = prng.split(k_announce, 4)
    announcing = alive & (
        draw(k_ann, (n,))
        < torch.tensor(1.0 / max(1, cfg.announce_interval), dtype=torch.float32,
                       device=dev))
    known = (view >= 0) & ~eye
    ann_tgt = torch.argmax(scores(known, k_annt), dim=1).to(torch.int32)
    announcing = announcing & known.any(dim=1)
    ann_out = announcing & datagram_ok(net, k_ann1, alive, iarr, ann_tgt)
    ann_back = ann_out & datagram_ok(net, k_ann2, alive, ann_tgt, iarr)
    al = ann_tgt.long()
    view[al, rows] = torch.maximum(view[al, rows],
                                   torch.where(ann_out, self_key, UNKNOWN))
    bel = old_view[al, rows]
    notice = ann_back & (bel >= 0) & ((bel & 3) != STATE_ALIVE)
    view = _diag_max(view, torch.where(notice, bel, UNKNOWN))

    # --- piggyback gossip on probe, ack, announce and its reply -------------
    sel_val, subj = prng.top_k(scores(st.tx_left > 0, k_pri), cfg.piggyback)
    sel_ok = sel_val >= 0
    payload = torch.gather(view, 1, subj)  # [N, U]

    def own(x):
        return x[:, None].expand(subj.shape)

    parts = [
        (own(tgt), subj, payload, (has_tgt & leg_out)[:, None] & sel_ok),
        (own(iarr), subj[tl], payload[tl], probe_ok[:, None] & sel_ok[tl]),
        (own(ann_tgt), subj, payload, ann_out[:, None] & sel_ok),
        (own(iarr), subj[al], payload[al], ann_back[:, None] & sel_ok[al]),
    ]
    # every delivered packet also asserts its sender alive at its incarnation
    asserts = [
        (tgt, iarr, self_key, has_tgt & leg_out),
        (iarr, tgt, self_key[tl], probe_ok),
        (ann_tgt, iarr, self_key, ann_out),
        (iarr, ann_tgt, self_key[al], ann_back),
    ]
    recv = torch.cat([p[0].reshape(-1) for p in parts] + [a[0] for a in asserts])
    subjects = torch.cat([p[1].reshape(-1) for p in parts] + [a[1] for a in asserts])
    keys_m = torch.cat([p[2].reshape(-1) for p in parts] + [a[2] for a in asserts])
    valid_m = torch.cat([p[3].reshape(-1) for p in parts] + [a[3] for a in asserts])
    flat = torch.where(valid_m, recv.long() * n + subjects.long(), n * n)
    view = _scatter_max(view, flat, keys_m)

    # --- piggyback budgets burn on every attempted send ---------------------
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    sends = (
        has_tgt.to(torch.int32) + announcing.to(torch.int32)
        + zeros.index_add(0, tl, (leg_out & alive[tl]).to(torch.int32))
        + zeros.index_add(0, al, ann_back.to(torch.int32))
    )
    dec = torch.where(sel_ok, rows[:, None] * n + subj, n * n)
    tx_left = torch.cat([st.tx_left.reshape(-1), st.tx_left.new_zeros(1)])
    tx_left.scatter_add_(0, dec.reshape(-1), -sends[:, None].expand(subj.shape).reshape(-1))
    tx_left = torch.clamp(tx_left[: n * n].reshape(n, n), min=0)

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
    selfv = view[rows, rows]
    refute = alive & (selfv >= 0) & ((selfv & 3) != STATE_ALIVE)
    inc = torch.where(refute, (selfv >> 2) + 1, inc)
    view[rows, rows] = torch.where(alive, inc * 4 + STATE_ALIVE, selfv)

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
