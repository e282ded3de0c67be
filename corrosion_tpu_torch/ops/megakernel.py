"""The port's two kernels, their wrappers and their plain versions
(port of ``corrosion_tpu/ops/megakernel.py``).

- ``swim_tables_fused``: the row-local SWIM back half
  (``csrc/swim_tables.cu``; plain version ``sim/scale.swim_tables_update``).
- ``ingest_changes_fused`` / ``local_write_fused``: receiver ingest (the
  scale round's piggyback batches and the full view's ``recv_slots``-wide
  mailboxes), and the local write, which on the scale round also emits the
  round's piggyback payload (``csrc/ingest.cu``; plain version
  :func:`ingest_plain`).

A wrapper picks its route from the tensors it is given and nothing else:
on CUDA tensors it launches the kernel (or raises), on CPU tensors it runs
the plain version. There is no probe and no degrade path. Each launch adds
one to :data:`LAUNCHES` and to its form's count in :data:`FORM_LAUNCHES`,
so a run can show that it went through the kernels, in which forms. On a
mesh each shard thread counts its own launches
(:func:`shard_launch_counts`), and the runner adds them in after the join.
``swim_tables_fused`` and ``ingest`` are priced units (``_units.py``): a
cost counter prices each call from its shapes, the same on either route.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from corrosion_tpu_torch._units import unit
from corrosion_tpu_torch.ops import cuda_lib
from corrosion_tpu_torch.ops.dense import (
    apply_changes,
    lookup_cols,
    scatter_cols_max,
    scatter_cols_or,
    select_cols,
)
from corrosion_tpu_torch.ops.slots import alloc_slots_evict, budget_mask, scatter_rows
from corrosion_tpu_torch.ops.versions import (
    _shift_right,
    _trailing_ones,
    as_i32,
    as_u32,
    claim_slots_arrays,
)
from corrosion_tpu_torch import random as prng
from corrosion_tpu_torch.sim.scale import swim_tables_update as swim_tables_plain

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"swim_tables": 0, "ingest": 0, "ingest_emit": 0}
#: the same launches per (wrapper, form): the swim kernel's form is
#: "aligned" or "packed" with its timer and budget bits, e.g.
#: "packed/16/8", and the row's width where it takes the wide form (more
#: than 128 slots), e.g. "aligned/16/16/m256"; the ingest kernel's its
#: q_cell and q_tx bits, e.g. "16/8", the batch width where it takes the wide instantiation, e.g.
#: "32/32/m96", or where the batch is empty, e.g. "16/16/m0", the origins
#: where they take the wide book (more than 32), e.g. "16/16/o256", and the
#: payload picks past one a lane, e.g. "16/16/o256/q128/w8/r64"
FORM_LAUNCHES: dict = {}


_SHARD = threading.local()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    FORM_LAUNCHES.clear()


class ShardLaunches:
    """One shard thread's launch counts, kept apart until the join."""

    def __init__(self):
        self.launches = dict.fromkeys(LAUNCHES, 0)
        self.forms: dict = {}

    def close(self) -> "ShardLaunches":
        _SHARD.counts = None
        return self


def shard_launch_counts() -> ShardLaunches:
    """Count this thread's launches apart from the process's counters
    until ``close()``."""
    _SHARD.counts = ShardLaunches()
    return _SHARD.counts


def add_launch_counts(c: ShardLaunches) -> None:
    for k, v in c.launches.items():
        LAUNCHES[k] += v
    for f, v in c.forms.items():
        FORM_LAUNCHES[f] = FORM_LAUNCHES.get(f, 0) + v


def _count_launch(name: str, form: str) -> None:
    c = getattr(_SHARD, "counts", None)
    launches, forms = (LAUNCHES, FORM_LAUNCHES) if c is None else (c.launches, c.forms)
    launches[name] += 1
    forms[(name, form)] = forms.get((name, form), 0) + 1


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no route for tensors on {t.device}")


def _on_device(dev):
    """A kernel launches on the calling thread's current device: make it the
    tensors' (a mesh shard's thread may drive another card). The host build
    of the kernels (``tests/cuda_host``) runs on CPU tensors: nothing to set."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(t, dtype, shape, device, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


def _raise_on(rc: int, lib, fn: str) -> None:
    if rc != 0:
        lib_err = getattr(lib, fn)
        lib_err.restype = ctypes.c_char_p
        lib_err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"CUDA launch failed ({rc}): {lib_err(rc).decode()}")


# --- K1: the SWIM back half ----------------------------------------------


class _SwimArgs(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "mem_id", "mem_view", "old_id", "old_view", "timer", "tx",
            "alive", "inc", "node_id", "self_slot", "sus_heard", "sends",
            "probe_slot", "suspect_key", "probe_failed")]
        + [(f, ctypes.c_void_p * 4) for f in (
            "ch_id", "ch_view", "ch_send", "ch_valid", "ch_snd", "ch_snd_inc")]
        + [(f, ctypes.c_void_p) for f in (
            "o_id", "o_view", "o_timer", "o_tx", "o_inc", "o_refute")]
        + [(f, ctypes.c_int32) for f in (
            "n", "m", "suspicion_rounds", "down_purge_rounds",
            "max_transmissions", "pig_k")]
    )


#: (timer dtype, budget dtype) pairs the swim kernel is instantiated for
_SWIM_DTYPES = ((torch.int16, torch.int8), (torch.int16, torch.int16),
                (torch.int32, torch.int32))


def _swim_cuda(consts, mem_id, mem_view, old_id, old_view, mem_timer, mem_tx,
               alive, inc, node_id, self_slot, sus_heard, sends, probe_slot,
               suspect_key, probe_failed, ch_in_id, ch_in_view, ch_in_send,
               ch_valid, ch_snd, ch_snd_inc):
    m, suspicion_rounds, down_purge_rounds, max_transmissions = consts[:4]
    pig_k = int(consts[4]) if len(consts) > 4 else 0
    lib = cuda_lib.library("swim_tables")
    n = mem_id.shape[0]
    dev = mem_id.device
    if (mem_timer.dtype, mem_tx.dtype) not in _SWIM_DTYPES:
        raise ValueError(
            f"swim kernel takes timer/budget planes of dtypes "
            f"{_SWIM_DTYPES}, got {mem_timer.dtype}/{mem_tx.dtype}"
        )
    i32, b8, tdt, xdt = torch.int32, torch.bool, mem_timer.dtype, mem_tx.dtype
    nm, nn = (n, m), (n,)
    nch = (n, pig_k) if pig_k else nm
    keep = []

    def c(t, dtype, shape, name):
        t = _check(t, dtype, shape, dev, name)
        keep.append(t)
        return _ptr(t)

    a = _SwimArgs()
    a.mem_id = c(mem_id, i32, nm, "mem_id")
    a.mem_view = c(mem_view, i32, nm, "mem_view")
    a.old_id = c(old_id, i32, nm, "old_id")
    a.old_view = c(old_view, i32, nm, "old_view")
    a.timer = c(mem_timer, tdt, nm, "mem_timer")
    a.tx = c(mem_tx, xdt, nm, "mem_tx")
    a.alive = c(alive, b8, nn, "alive")
    a.inc = c(inc, i32, nn, "inc")
    a.node_id = c(node_id, i32, nn, "node_id")
    a.self_slot = c(self_slot, i32, nn, "self_slot")
    a.sus_heard = c(sus_heard, i32, nn, "sus_heard")
    a.sends = c(sends, i32, nn, "sends")
    a.probe_slot = c(probe_slot, i32, nn, "probe_slot")
    a.suspect_key = c(suspect_key, i32, nn, "suspect_key")
    a.probe_failed = c(probe_failed, b8, nn, "probe_failed")
    for i in range(4):
        a.ch_id[i] = c(ch_in_id[i], i32, nch, "ch_in_id")
        a.ch_view[i] = c(ch_in_view[i], i32, nch, "ch_in_view")
        # the packed form does not read the send flags
        a.ch_send[i] = None if pig_k else c(ch_in_send[i], b8, nm, "ch_in_send")
        a.ch_valid[i] = c(ch_valid[i], b8, nn, "ch_valid")
        a.ch_snd[i] = c(ch_snd[i], i32, nn, "ch_snd")
        a.ch_snd_inc[i] = c(ch_snd_inc[i], i32, nn, "ch_snd_inc")
    o_id = torch.empty(nm, dtype=i32, device=dev)
    o_view = torch.empty(nm, dtype=i32, device=dev)
    o_timer = torch.empty(nm, dtype=tdt, device=dev)
    o_tx = torch.empty(nm, dtype=xdt, device=dev)
    o_inc = torch.empty(nn, dtype=i32, device=dev)
    o_refute = torch.empty(nn, dtype=b8, device=dev)
    a.o_id, a.o_view, a.o_timer, a.o_tx = map(_ptr, (o_id, o_view, o_timer, o_tx))
    a.o_inc, a.o_refute = _ptr(o_inc), _ptr(o_refute)
    a.n, a.m = n, m
    a.suspicion_rounds = suspicion_rounds
    a.down_purge_rounds = down_purge_rounds
    a.max_transmissions = max_transmissions
    a.pig_k = pig_k
    fn = lib.swim_tables_launch
    fn.argtypes = [ctypes.POINTER(_SwimArgs), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on_device(dev):
        rc = fn(ctypes.byref(a), mem_timer.element_size(), mem_tx.element_size(),
                int(pig_k > 0), ctypes.c_void_p(stream))
    _raise_on(rc, lib, "swim_tables_error_string")
    wide = f"/m{m}" if m > lib.swim_tables_register_slots() else ""
    _count_launch("swim_tables", f"{'packed' if pig_k else 'aligned'}/"
                  f"{8 * mem_timer.element_size()}/{8 * mem_tx.element_size()}{wide}")
    return o_id, o_view, o_timer, o_tx, o_inc, o_refute


@unit("swim_tables")
def swim_tables_fused(consts, *args):
    """The SWIM back half (same arguments as ``swim_tables_update``): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if _route(args[0]) == "cuda":
        return _swim_cuda(consts, *args)
    return swim_tables_plain(consts, *args)


# --- K2 / K3: ingest, with and without payload emission -------------------


class IngestParams(NamedTuple):
    """Static constants of one ingest call."""

    n_origins: int
    n_cells: int
    q_slots: int
    seen_words: int
    hlc_round_bits: int
    hlc_max_drift: int
    pig_r: int  # > 0: emit the piggyback payload (K3)
    budget_bytes: int
    wire_bytes: int
    keep_rounds: int
    enqueue_all: bool


class IngestInputs(NamedTuple):
    live: torch.Tensor  # bool [N, m]
    origin: torch.Tensor  # int32 [N, m] (and the eight fields below)
    dbv: torch.Tensor
    cell: torch.Tensor
    ver: torch.Tensor
    val: torch.Tensor
    site: torch.Tensor
    clp: torch.Tensor
    ts: torch.Tensor
    budget: torch.Tensor
    store: tuple  # 5 x int32 [N, C]: ver, val, site, dbv, clp
    head: torch.Tensor  # int32 [N, O]
    km: torch.Tensor
    seen: torch.Tensor  # int32 [N, O*W] (uint32 bit patterns)
    org_id: torch.Tensor
    org_last: torch.Tensor
    q_origin: torch.Tensor  # int32 [N, Q]
    q_dbv: torch.Tensor
    q_cell: torch.Tensor  # int16 or int32
    q_ver: torch.Tensor
    q_val: torch.Tensor
    q_site: torch.Tensor
    q_clp: torch.Tensor
    q_ts: torch.Tensor
    q_tx: torch.Tensor  # int8, int16 or int32
    hlc: torch.Tensor  # int32 [N]
    now: torch.Tensor  # int32 []
    rand: Optional[torch.Tensor] = None  # float32 [N, Q] (emit)
    carried: Optional[torch.Tensor] = None  # int32 [N] (emit)


class IngestOutputs(NamedTuple):
    store: tuple
    head: torch.Tensor
    km: torch.Tensor
    seen: torch.Tensor
    org_id: torch.Tensor
    org_last: torch.Tensor
    q_origin: torch.Tensor
    q_dbv: torch.Tensor
    q_cell: torch.Tensor
    q_ver: torch.Tensor
    q_val: torch.Tensor
    q_site: torch.Tensor
    q_clp: torch.Tensor
    q_ts: torch.Tensor
    q_tx: torch.Tensor
    hlc: torch.Tensor  # int32 [N]
    fresh: torch.Tensor  # bool [N, m]
    drift: torch.Tensor  # int32 [N]
    payload: Optional[torch.Tensor] = None  # int32 [N, 11 * pig_r]
    sel: Optional[torch.Tensor] = None  # int32 [N, pig_r]
    sel_ok: Optional[torch.Tensor] = None  # bool [N, pig_r]


def ingest_plain(p: IngestParams, x: IngestInputs) -> IngestOutputs:
    """The ingest kernel's function written on whole tensors."""
    if x.origin.shape[1] == 0:
        # an empty batch (the scale round at pig_changes == 0) is one
        # message that is not live: the reductions over the batch then have
        # an element, and the outputs are the empty batch's
        out = ingest_plain(p, x._replace(**{
            f: getattr(x, f).new_zeros((x.origin.shape[0], 1))
            for f in ("live",) + _MSG_FIELDS}))
        return out._replace(fresh=out.fresh[:, :0])
    o, w = p.n_origins, p.seen_words
    origin, dbv, now = x.origin, x.dbv, x.now

    # HLC fold with max-drift rejection
    ts_ok = x.live & ((x.ts >> p.hlc_round_bits) <= now + p.hlc_max_drift)
    folded = torch.where(ts_ok, x.ts, 0).amax(dim=1)
    hlc = torch.maximum(x.hlc, folded)
    drift = (x.live & ~ts_ok).sum(dim=1, dtype=torch.int32)
    live = ts_ok

    def window(head, org_id):
        slot = torch.where(origin >= 0, origin % o, 0)
        owned = (origin >= 0) & (lookup_cols(org_id, slot, fill=-1) == origin)
        h_at = lookup_cols(head, slot)
        off = dbv - h_at - 1
        in_win = (off >= 0) & (off < 32 * w)
        word_idx = slot * w + torch.where(off >= 0, off >> 5, 0)
        bit = (torch.clamp(off, min=0) & 31).to(torch.int64)
        return slot, owned, h_at, in_win, word_idx, bit

    # seen check + in-batch dedupe
    slot, owned_pre, h_at, in_win, word_idx, bit = window(x.head, x.org_id)
    hit = ((as_u32(lookup_cols(x.seen, word_idx)) >> bit) & 1) == 1
    seen_b = live & owned_pre & ((dbv <= h_at) | (in_win & hit))
    # a live message repeats an earlier live one's (origin, dbv): ordered by
    # (not live, key, index), it follows a live message of its key (two
    # stable sorts, O(m log m) a row where an [N, m, m] compare would not fit
    # the card at m = 512 and N = 100,000)
    key = origin.to(torch.int64) * (1 << 32) + (dbv.to(torch.int64) & 0xFFFFFFFF)
    by_key = torch.argsort(key, dim=1, stable=True)
    order = by_key.gather(1, torch.argsort((~live).gather(1, by_key).to(torch.int32), dim=1,
                                           stable=True))
    k_s, l_s = key.gather(1, order), live.gather(1, order)
    rep = torch.zeros_like(live)
    rep[:, 1:] = l_s[:, 1:] & l_s[:, :-1] & (k_s[:, 1:] == k_s[:, :-1])
    dup = torch.zeros_like(live).scatter_(1, order, rep)
    fresh = live & ~seen_b & ~dup

    # slot claim/evict, then record under the post-claim ownership
    head, km, seen, org_id, org_last = claim_slots_arrays(
        x.head, x.km, x.seen, x.org_id, x.org_last, origin, fresh, now,
        p.keep_rounds, w,
    )
    slot, owned, _, in_win, word_idx, bit = window(head, org_id)
    rec = fresh & owned
    seen = scatter_cols_or(seen, word_idx, as_i32(torch.ones_like(bit) << bit),
                           rec & in_win)
    km = scatter_cols_max(km, slot, dbv, live & owned)

    # head advance: trailing ones, then shift the window down
    n = head.shape[0]
    seen3 = seen.reshape(n, o, w)
    t = _trailing_ones(seen3)
    head = head + t
    seen = _shift_right(seen3, t).reshape(n, o * w)
    km = torch.maximum(km, head)

    store = apply_changes(x.store, x.cell, x.ver, x.val, x.site, dbv, x.clp, fresh)

    # re-broadcast enqueue, evicting the lowest remaining budget
    enq = fresh if p.enqueue_all else rec
    q_slot, placed = alloc_slots_evict(x.q_origin == -1, x.q_tx, enq)
    q_new = [
        scatter_rows(plane, q_slot, placed, msg)
        for plane, msg in (
            (x.q_origin, origin), (x.q_dbv, dbv), (x.q_cell, x.cell),
            (x.q_ver, x.ver), (x.q_val, x.val), (x.q_site, x.site),
            (x.q_clp, x.clp), (x.q_ts, x.ts), (x.q_tx, x.budget),
        )
    ]
    payload = sel = sel_ok = None
    if p.pig_r:
        q_origin, q_tx = q_new[0], q_new[8]
        allowed = torch.clamp(
            p.budget_bytes // (p.wire_bytes * torch.clamp(x.carried, min=1)),
            min=1).to(torch.int32)
        keep = budget_mask((q_origin != -1) & (q_tx > 0), q_tx, allowed)
        scores = torch.where(keep, x.rand, torch.full_like(x.rand, -1.0))
        val, cols = prng.top_k(scores, p.pig_r)
        sel, sel_ok = cols.to(torch.int32), val >= 0
        pick = [select_cols(f, sel).to(torch.int32) for f in q_new[:7]]
        zeros = torch.zeros_like(sel)
        payload = torch.cat(
            pick + [zeros, zeros + 1, select_cols(q_new[7], sel),
                    sel_ok.to(torch.int32)], dim=1)
    return IngestOutputs(store, head, km, seen, org_id, org_last, *q_new,
                         hlc, fresh, drift, payload, sel, sel_ok)


class _IngestArgs(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "live", "origin", "dbv", "cell", "ver", "val", "site", "clp",
            "ts", "budget")]
        + [("store", ctypes.c_void_p * 5)]
        + [(f, ctypes.c_void_p) for f in (
            "head", "km", "seen", "org_id", "org_last",
            "q_origin", "q_dbv", "q_cell", "q_ver", "q_val", "q_site",
            "q_clp", "q_ts", "q_tx", "hlc", "now", "rand", "carried")]
        + [("o_store", ctypes.c_void_p * 5)]
        + [(f, ctypes.c_void_p) for f in (
            "o_head", "o_km", "o_seen", "o_org_id", "o_org_last",
            "o_q_origin", "o_q_dbv", "o_q_cell", "o_q_ver", "o_q_val",
            "o_q_site", "o_q_clp", "o_q_ts", "o_q_tx", "o_hlc", "o_fresh",
            "o_drift", "o_payload", "o_sel", "o_selok")]
        + [(f, ctypes.c_int32) for f in (
            "n", "m", "n_origins", "n_cells", "q_slots", "seen_words",
            "hlc_round_bits", "hlc_max_drift", "pig_r", "budget_bytes",
            "wire_bytes", "keep_rounds", "enqueue_all")]
    )


#: (q_cell dtype, q_tx dtype) pairs the ingest kernel is instantiated for
_INGEST_DTYPES = ((torch.int16, torch.int8), (torch.int16, torch.int16),
                  (torch.int32, torch.int32))
_MSG_FIELDS = ("origin", "dbv", "cell", "ver", "val", "site", "clp", "ts", "budget")
_Q_FIELDS = ("q_origin", "q_dbv", "q_cell", "q_ver", "q_val", "q_site",
             "q_clp", "q_ts", "q_tx")


def _ingest_cuda(p: IngestParams, x: IngestInputs) -> IngestOutputs:
    lib = cuda_lib.library("ingest")
    limits = (ctypes.c_int * 8)()
    lib.ingest_limits(limits)
    n, m = x.origin.shape
    c_cnt, o, w, q = p.n_cells, p.n_origins, p.seen_words, p.q_slots
    # limits: widest m, O (any form: past the staged book's origins the book
    # row stays in global memory), W, Q, R, the widest m of the narrow
    # instantiation (and of the emitting one of one pick a lane), C (any
    # form: past the staged row's cells the row stays in global memory), the
    # most O of the register book
    if (m > limits[0] or not 1 <= o <= limits[1] or w > limits[2] or q > limits[3]
            or p.pig_r > limits[4] or c_cnt > limits[6]):
        raise ValueError(
            f"ingest widths m={m} O={o} W={w} Q={q} R={p.pig_r} C={c_cnt} "
            f"exceed the kernel's limits {list(limits)}"
        )
    dev = x.origin.device
    cdt, qdt = x.q_cell.dtype, x.q_tx.dtype
    if (cdt, qdt) not in _INGEST_DTYPES:
        raise ValueError(
            f"ingest kernel takes q_cell/q_tx planes of dtypes "
            f"{_INGEST_DTYPES}, got {cdt}/{qdt}"
        )
    i32 = torch.int32
    keep = []

    def c(t, dtype, shape, name):
        t = _check(t, dtype, shape, dev, name)
        keep.append(t)
        return _ptr(t)

    a = _IngestArgs()
    a.live = c(x.live, torch.bool, (n, m), "live")
    for f in _MSG_FIELDS:
        setattr(a, f, c(getattr(x, f), i32, (n, m), f))
    for i in range(5):
        a.store[i] = c(x.store[i], i32, (n, c_cnt), "store")
    for f in ("head", "km", "org_id", "org_last"):
        setattr(a, f, c(getattr(x, f), i32, (n, o), f))
    a.seen = c(x.seen, i32, (n, o * w), "seen")
    for f in _Q_FIELDS:
        dt = {"q_cell": cdt, "q_tx": qdt}.get(f, i32)
        setattr(a, f, c(getattr(x, f), dt, (n, q), f))
    a.hlc = c(x.hlc, i32, (n,), "hlc")
    a.now = c(x.now.to(i32).reshape(()), i32, (), "now")
    if p.pig_r:
        a.rand = c(x.rand, torch.float32, (n, q), "rand")
        a.carried = c(x.carried, i32, (n,), "carried")

    def e(shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = IngestOutputs(
        store=tuple(e((n, c_cnt)) for _ in range(5)),
        head=e((n, o)), km=e((n, o)), seen=e((n, o * w)),
        org_id=e((n, o)), org_last=e((n, o)),
        q_origin=e((n, q)), q_dbv=e((n, q)), q_cell=e((n, q), cdt),
        q_ver=e((n, q)), q_val=e((n, q)), q_site=e((n, q)), q_clp=e((n, q)),
        q_ts=e((n, q)), q_tx=e((n, q), qdt),
        hlc=e((n,)), fresh=e((n, m), torch.bool), drift=e((n,)),
        payload=e((n, 11 * p.pig_r)) if p.pig_r else None,
        sel=e((n, p.pig_r)) if p.pig_r else None,
        sel_ok=e((n, p.pig_r), torch.bool) if p.pig_r else None,
    )
    for i in range(5):
        a.o_store[i] = _ptr(out.store[i])
    for f in ("head", "km", "seen", "org_id", "org_last", *_Q_FIELDS, "hlc",
              "fresh", "drift", "payload", "sel"):
        setattr(a, "o_" + f, _ptr(getattr(out, f)))
    a.o_selok = _ptr(out.sel_ok)
    a.n, a.m = n, m
    a.n_origins, a.n_cells, a.q_slots, a.seen_words = o, c_cnt, q, w
    a.hlc_round_bits, a.hlc_max_drift = p.hlc_round_bits, p.hlc_max_drift
    a.pig_r, a.budget_bytes, a.wire_bytes = p.pig_r, p.budget_bytes, p.wire_bytes
    a.keep_rounds, a.enqueue_all = p.keep_rounds, int(p.enqueue_all)
    fn = lib.ingest_launch
    fn.argtypes = [ctypes.POINTER(_IngestArgs), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on_device(dev):
        rc = fn(ctypes.byref(a), x.q_cell.element_size(), x.q_tx.element_size(),
                int(p.pig_r > 0), ctypes.c_void_p(stream))
    _raise_on(rc, lib, "ingest_error_string")
    form = f"{8 * x.q_cell.element_size()}/{8 * x.q_tx.element_size()}"
    if m > limits[5] or m == 0:
        # a batch wider than 32 (its messages in registers up to 128, in
        # global memory past), or the empty batch (the scale round at
        # pig_changes == 0)
        form += f"/m{m}"
    if o > limits[7]:
        # the shared book's instantiation, past its origins the global book's
        form += f"/o{o}"
    if c_cnt > lib.ingest_staged_cells():
        form += f"/c{c_cnt}"  # the row in global memory
    shallow = (ctypes.c_int * 2)()
    lib.ingest_shallow_limits(shallow)
    # the deep form (4 queue slots a lane, up to 8 seen words)
    if q > shallow[1]:
        form += f"/q{q}"
    if w > shallow[0]:
        form += f"/w{w}"
    long_limits = (ctypes.c_int * 2)()
    lib.ingest_long_limits(long_limits)
    if p.pig_r > long_limits[1]:
        form += f"/r{p.pig_r}"  # more than one pick a lane (the long form)
    _count_launch("ingest_emit" if p.pig_r else "ingest", form)
    return out


@unit("ingest")
def ingest(p: IngestParams, x: IngestInputs) -> IngestOutputs:
    """The ingest kernel on CUDA tensors, its plain version on CPU tensors."""
    if _route(x.origin) == "cuda":
        return _ingest_cuda(p, x)
    return ingest_plain(p, x)


def ingest_changes_fused(cfg, cst, live, m_origin, m_dbv, m_cell, m_ver,
                         m_val, m_site, m_clp, m_ts, *, m_budget=None,
                         drift_rounds: Optional[int] = None, rand=None,
                         carried=None, enqueue_all: bool = False):
    """Single-cell receiver ingest of per-row message batches through the
    ingest kernel. With ``rand`` ([N, Q] uniforms) and ``carried`` ([N]
    delivered packets) it also emits this round's piggyback selection and
    returns ``(cst, info, (payload, sel_slots, sel_ok))``; else
    ``(cst, info)``."""
    from corrosion_tpu_torch.sim.broadcast import (
        CHANGE_WIRE_BYTES,
        HLC_MAX_DRIFT_ROUNDS,
        HLC_ROUND_BITS,
        NO_Q,
    )

    n, o, w = cst.book.seen.shape
    emit = rand is not None and carried is not None
    p = IngestParams(
        n_origins=o, n_cells=cst.store[0].shape[1], q_slots=cst.q_origin.shape[1],
        seen_words=w, hlc_round_bits=HLC_ROUND_BITS,
        hlc_max_drift=HLC_MAX_DRIFT_ROUNDS if drift_rounds is None else drift_rounds,
        pig_r=int(cfg.pig_changes) if emit else 0,
        budget_bytes=int(cfg.bcast_budget_bytes), wire_bytes=CHANGE_WIRE_BYTES,
        keep_rounds=int(cfg.org_keep_rounds), enqueue_all=bool(enqueue_all),
    )
    if m_budget is None:
        m_budget = torch.full_like(m_origin, max(1, int(cfg.bcast_max_transmissions) - 1))
    x = IngestInputs(
        live, m_origin, m_dbv, m_cell, m_ver, m_val, m_site, m_clp, m_ts,
        m_budget, tuple(cst.store), cst.book.head, cst.book.known_max,
        cst.book.seen.reshape(n, o * w), cst.book.org_id, cst.book.org_last,
        cst.q_origin, cst.q_dbv, cst.q_cell, cst.q_ver, cst.q_val, cst.q_site,
        cst.q_clp, cst.q_ts, cst.q_tx, cst.hlc, cst.now,
        rand if emit else None, carried if emit else None,
    )
    r = ingest(p, x)
    book = cst.book._replace(
        head=r.head, known_max=r.km, seen=r.seen.reshape(n, o, w),
        org_id=r.org_id, org_last=r.org_last,
    )
    cst = cst._replace(
        store=r.store, book=book,
        q_origin=r.q_origin, q_dbv=r.q_dbv, q_cell=r.q_cell, q_ver=r.q_ver,
        q_val=r.q_val, q_site=r.q_site, q_clp=r.q_clp, q_ts=r.q_ts,
        q_tx=r.q_tx, hlc=r.hlc,
    )
    info = {
        "delivered": live.sum() - r.drift.sum(),
        "fresh": r.fresh.sum(),
        "tx_completed": torch.zeros((), dtype=torch.int64, device=live.device),
        "clock_drift_rejects": r.drift.sum(),
        "queued": (r.q_origin != NO_Q).sum(),
    }
    if emit:
        return cst, info, (r.payload, r.sel, r.sel_ok)
    return cst, info


def local_write_fused(cfg, cst, write_mask, cell, val, clp=None, *, rand=None,
                      carried=None, ids=None):
    """The local write as a one-message batch through the ingest kernel
    (origin = site = self, dbv = next_dbv, ver = cell's clock + 1, full
    budget, no drift reject, enqueued even when its slot is contended).
    With ``rand``/``carried`` it returns ``(cst, emitted)``, else ``cst``.
    ``ids``: the global node ids of the rows (a mesh shard's), else
    ``0..N-1``."""
    from corrosion_tpu_torch.sim.broadcast import _writers, hlc_tick

    n = write_mask.shape[0]
    dev = write_mask.device
    iarr = torch.arange(n, dtype=torch.int32, device=dev) if ids is None else ids
    w = _writers(cfg, write_mask, ids)
    if clp is None:
        clp = torch.zeros(n, dtype=torch.int32, device=dev)
    dbv = cst.next_dbv
    cur_ver = lookup_cols(cst.store[0], cell[:, None])[:, 0]
    ts, _ = hlc_tick(cst.hlc, cst.now, w)
    col = lambda v: v[:, None].contiguous()  # noqa: E731
    out = ingest_changes_fused(
        cfg, cst, col(w), col(iarr), col(dbv), col(cell), col(cur_ver + 1),
        col(val), col(iarr), col(clp), col(ts),
        m_budget=torch.full((n, 1), int(cfg.bcast_max_transmissions),
                            dtype=torch.int32, device=dev),
        drift_rounds=1 << 20, rand=rand, carried=carried, enqueue_all=True,
    )
    cst2 = out[0]._replace(next_dbv=torch.where(w, dbv + 1, cst.next_dbv))
    if len(out) == 3:
        return cst2, out[2]
    return cst2
