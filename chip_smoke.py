#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's rounds on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build every kernel from ``corrosion_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together) and print ptxas' register and stack report;
   each of the swim kernel's 18 instantiations is named, and any stack
   frame or spill in one of them fails the run.
2. Hold every kernel form against its plain PyTorch version on the card on
   random valid inputs drawn from the port's PRNG, and again, untimed, on
   tie-heavy inputs at N three past the configuration's (``_ingest_inputs``
   and ``_swim_inputs`` with ``ties=True``; the swim inputs must give rows
   where two row-addressed steps meet in one hash class), every output
   bitwise equal, tolerance 0; time both with CUDA events: the flagship forms
   at N = 100,000; the 1M point's forms (packed-entry swim kernel with int8
   budgets, ingest with int8 q_tx) at N = 1,000,000; the full view's forms
   at N = 8192 (the recv_slots-wide receive batch, m = 96, on inputs where
   many rows record more messages than the queue's 64 slots, and the
   non-emitting local write, m = 1, both on int32 planes); the empty receive
   batch (m = 0) of ``pig_changes=0`` at N = 100,000; and the forms no
   path here runs (int32 planes at N = 100,000, the non-emitting local write
   at int16/int16 and int16/int8, the swim kernel's other budget tiers at
   N = 1,000,000).
3. Run 16 rounds of ``scale_sim_config(4096, sync_interval=2,
   sync_sweep_every=2)`` with writes, churn and 5 % message loss once on
   the card (kernels) and once on the CPU (plain versions); every state leaf
   and round-info value must be bitwise equal after every round. The same
   for the 1M point's configuration at 4096 nodes. (The CPU route is held
   bitwise to the JAX package by ``tests/test_torch_*.py``.)
4. The flagship: ``scale_sim_config(100_000)`` with bench.py's workload
   (``sim.scale_step.flagship_workload``), 2 warm-up rounds, then three
   timed batches of 8 rounds. Each kernel's launch count over the timed
   rounds must equal the number of rounds; prints each batch's rounds/s,
   their median and peak device memory.
5. The 1M point: ``sim.scale_step.million_config()`` (bounded member
   piggyback, int8 budget and queue-counter planes) with the same workload,
   2 warm-up rounds, then three timed batches of 4 rounds. Each kernel must
   launch once a round, in that configuration's forms; prints rounds/s,
   peak device memory and the carried state's bytes.
6. The quiet round: ``quiet="on"`` on the card against ``quiet="off"`` on
   the card and ``quiet="on"`` on the CPU, on a settled trace; every state
   leaf and info value must be bitwise equal, the fixpoint branch must run,
   and each kernel must launch once in every dense round of the card's
   ``quiet="on"`` run and in no fixpoint round.
7. The full view, card vs CPU: 16 rounds of ``scenario.full_mix`` (churn,
   conflict-heavy writes, 1 % loss) at ``full_view_config(1024)``; every
   state leaf and info value bitwise equal after every round.
8. The full view at ``full_view_config(8192)`` (O(N^2) membership view,
   recv_slots = 96) with the same workload: 2 warm-up rounds, then three
   timed batches of 4 rounds. The ingest kernel must launch once a round as
   the local write (m = 1) and once as the receive batch (m = 96), and the
   swim kernel never; prints rounds/s, peak device memory and the carried
   state's bytes.
9. tx-trajectory: phase 3's trajectory for the configurations whose CRDT
   half takes the plain route or the empty batch: multi-cell transactions
   (``tx_max_cells=4``), the wire-budget lane (``bcast_wire_budget``), and
   ``pig_changes=0``. Card and CPU bitwise equal after every round; the
   swim kernel launches once a round in all three; the ingest kernel never
   in the first two, and at ``pig_changes=0`` once a round as the
   non-emitting local write and once as the empty receive batch (m = 0).
10. full-tx-trajectory: phase 7 at ``wan_config(1024, n_origins=16)``
    (``tx_max_cells=8``, the agent's full-view default) with one seeded
    transaction of 1..8 cells per writing origin and round; card and CPU
    bitwise equal after every round, transactions completed, no kernel
    launched (the configuration takes the plain route).
11. tx, wirebudget: ``scale_sim_config(100_000, n_origins=16,
    tx_max_cells=4)`` and ``scale_sim_config(100_000, n_origins=16,
    bcast_wire_budget=True)`` with the flagship's workload (routed through
    ``make_write_inputs``' transaction branch for the first): 2 warm-up
    rounds, then ten timed batches of 2 rounds; median and quartiles of
    rounds/s, peak device memory; the swim kernel launches once a round,
    the ingest kernel never.
12. full-tx: ``wan_config(8192, n_origins=16)`` under ``full_mix`` with
    phase 10's transactions: 2 warm-up rounds, then ten timed batches of 1
    round; median and quartiles of rounds/s, peak device memory; no kernel
    launches.
13. parity: BASELINE's state-parity check at N=256 (16 origins, 64
    cells, 24 rounds, up to 512 rounds to settle): single-writer scripts
    (without and with 5 % loss) and multi-cell transactions (tx 4, plain
    route) equal to the pure-Python oracle cluster bitwise; conflicting,
    delete/resurrect and full-mix scripts (kill, revive, partition, heal)
    agree and hold only written values. Every script converges on both
    sides, the card equals the CPU route bitwise, and each kernel launches
    once a round (the swim kernel alone at tx 4); the single writer also
    runs ``quiet="on"`` to the same result.
14. soak: the flagship for 64 rounds straight, as ``run_segmented`` in 4
    segments of 16 with the async writer (keep_last 2), and as its first
    32 rounds segmented then ``resume_segmented`` from disk: every leaf
    and info bitwise equal, the same launches per form, peak device bytes
    within 5 % of the straight run's; prints rounds/s, checkpoint stall
    and writer seconds, one checkpoint's bytes, and save, verify and load
    seconds.
15. full-soak: ``full_view_config(1024)`` for 16 rounds, one segment of 8
    checkpointed and resumed from disk, equal to the straight run bitwise,
    with the ingest kernel at m = 96 once a round.

Each kernel's bound is the larger of the bytes it must move on these inputs
over the memory rate and the integer operations its function needs on them
(counted from what it computes, not from the kernel's loops) over the int32
rate.

The last lines are the card's name and power limit, the per-kernel JSON
record (launches are counted on the path that runs each form, 0 for the
forms no path here runs), and ``{"ok": true, "device": {...}}``. The script
needs one CUDA device and exits non-zero without printing a result when
there is none.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # published HBM3 rate of one H100 SXM
# The kernels do int32 work on the CUDA cores. An SM has 64 INT32 lanes
# beside its 128 FP32 lanes, so the int32 rate is a quarter of the published
# 67 TFLOP/s float32 rate (which counts an FMA as two operations).
H100_INT32_OPS_PER_S = 67e12 / 4
FLAGSHIP_NODES = 100_000
MILLION_NODES = 1_000_000
TRAJECTORY_NODES = 4096  # small enough for the CPU route to keep pace
FULL_NODES = 8192  # the full view's measured point (sim.config.full_view_config)
FULL_TRAJECTORY_NODES = 1024  # the full view, card vs CPU: float ties are common
# BASELINE's correctness size: a 256-node cluster, 16 origins, 64 cells
PARITY_NODES, PARITY_ORIGINS, PARITY_CELLS, PARITY_ROUNDS = 256, 16, 64, 24
# empty rounds after the single writer's script for the quiet check: the
# cluster goes quiet about 100 rounds after the last write
PARITY_QUIET_TAIL = 128
SOAK_ROUNDS, SOAK_SEGMENT = 64, 16


def _swim_ops(args, pig_k: int = 0) -> int:
    """Integer operations the swim function needs on these operands: a
    channel merge (~10 per slot, packed: ~14 per entry) only on the rows
    where that channel is valid, ~30 per slot for timers, budget and
    stores, ~60 per row."""
    mem_id, ch_valid = args[0], args[18]
    n, m = mem_id.shape
    merge = 14 * pig_k if pig_k else 10 * m
    return sum(_count(v) for v in ch_valid) * merge + n * (30 * m + 60)


def _ingest_ops(p, x, out) -> int:
    """Integer operations the ingest function needs on these operands,
    counted from what it computes, not from the kernel's loops. Per live
    message: the HLC fold (3), the seen check (10), the known-max update
    (2), and a first-occurrence dedupe that sorts the row's live (origin,
    version) keys (2 per compare). Per fresh message: the slot claim (3)
    and the seen-bit record (8); per fresh message on a valid cell one step
    of a running per-cell LWW winner over five keys (12), and 2 per cell to
    seed and write back the winners. The enqueue: 2 per queue slot to build
    the evict keys, the E smallest of them (2 per compare, Q per pick, or a
    sort of Q·⌈log2 Q⌉ compares if that is fewer), 3 per enqueued message.
    Per origin the claim's take or evict (8 + W) and the head advance (8
    per seen word, + 4). The emitting form adds the payload choice: a sort
    of the queue by budget, the R largest draws, 4 per slot, 15 per entry."""
    import torch

    def sort_cmp(k):  # compares to sort k keys, per row
        return k * torch.ceil(torch.log2(torch.clamp(k.to(torch.float64), min=1)))

    n, c, q, r = x.live.shape[0], p.n_cells, p.q_slots, p.pig_r
    live = x.live.sum(dim=1)
    fresh = out.fresh
    applied = fresh & (x.cell >= 0) & (x.cell < c)
    enq = torch.clamp((fresh if p.enqueue_all else fresh & _owned(p, x, out)).sum(dim=1), max=q)
    log_q = int(sort_cmp(torch.tensor(q))) // q
    ops = (15 * int(live.sum()) + 2 * int(sort_cmp(live).sum()) + 11 * _count(fresh)
           + 12 * _count(applied) + n * 2 * c
           + n * 2 * q + 2 * q * int(torch.clamp(enq, max=log_q).sum()) + 3 * int(enq.sum())
           + n * p.n_origins * (12 + 9 * p.seen_words))
    if r:
        ops += n * (2 * q * log_q + 2 * q * min(r, log_q) + 4 * q + 15 * r)
    return ops


def _bound(nbytes: int, ops: int) -> tuple:
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over the int32 rate."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = ops / H100_INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, kernel: str) -> float:
    """Device time of ``kernel`` (part of a kernel's name) per call of ``fn``,
    from ``torch.profiler``: the kernel alone, without the wrapper's host
    time, which CUDA events over back-to-back calls include when the kernel
    is shorter than it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corrosion_tpu_torch.round_profile import _device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages() if kernel in e.key)
    return us / iters / 1e3


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _count(t) -> int:
    return int(t.sum())


def _flat(x):
    """Tensor leaves of nested NamedTuples / tuples / dicts, in order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


def _max_abs_err(a_list, b_list) -> int:
    import torch

    worst = 0
    for a, b in zip(a_list, b_list, strict=True):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"dtype/shape mismatch {a.dtype}{tuple(a.shape)} "
                                 f"vs {b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            diff = (a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64))
        else:
            diff = a.to(torch.int64) - b.to(torch.int64)
        if diff.numel():
            worst = max(worst, int(diff.abs().max()))
    return worst


def _swim_inputs(n: int, m: int, plane_dtype, seed: int, dev, tx_dtype=None,
                 pig_k: int = 0, ties: bool = False):
    """Random valid operands of the swim kernel (the order of
    ``swim_tables_update``'s arguments after ``consts``), with the timer
    plane at ``plane_dtype`` and the budget plane at ``tx_dtype`` (default
    the same). With ``pig_k > 0`` the channels are packed [n, pig_k] entry
    lists, whose entries often share a hash class within one packet. With
    ``ties``, the inputs where a lane-parallel merge can part from the
    sequential one (``_swim_tie_heavy``)."""
    import torch

    from corrosion_tpu_torch import random as prng

    ks = iter(prng.split(prng.key(seed), 64))

    def ri(shape, lo, hi):
        return prng.randint(next(ks), shape, lo, hi, dev)

    def coin(shape, p):
        return prng.uniform(next(ks), shape, dev) < p

    iarr = torch.arange(n, dtype=torch.int32, device=dev)
    self_slot = iarr % m
    mem_id = torch.where(coin((n, m), 0.2), -1, ri((n, m), 0, n))
    own = coin((n,), 0.5)
    rows = iarr.long()
    mem_id[rows[own], self_slot.long()[own]] = iarr[own]
    mem_view = ri((n, m), -1, 64)
    old_id = torch.where(coin((n, m), 0.8), mem_id, ri((n, m), -1, n))
    old_view = torch.where(coin((n, m), 0.8), mem_view, ri((n, m), -1, 64))
    chans = [[], [], [], [], [], []]
    for _ in range(4):
        if pig_k:
            nk = (n, pig_k)
            chans[0].append(torch.where(coin(nk, 0.15), -1, ri(nk, 0, n)))
            chans[1].append(ri(nk, -1, 64))
            chans[2].append(torch.ones(nk, dtype=torch.bool, device=dev))
        else:
            chans[0].append(torch.where(coin((n, m), 0.5), mem_id, ri((n, m), -1, n)))
            chans[1].append(ri((n, m), -1, 64))
            chans[2].append(coin((n, m), 0.7))
        chans[3].append(coin((n,), 0.8))
        chans[4].append(ri((n,), 0, n))
        chans[5].append(ri((n,), 0, 8))
    args = (
        mem_id, mem_view, old_id, old_view,
        ri((n, m), 0, 12).to(plane_dtype), ri((n, m), 0, 14).to(tx_dtype or plane_dtype),
        coin((n,), 0.9), ri((n,), 0, 8), iarr, self_slot,
        ri((n,), -1, 40), ri((n,), 0, 4), ri((n,), 0, m), ri((n,), 0, 40),
        coin((n,), 0.3), *chans,
    )
    return _swim_tie_heavy(args, pig_k, seed) if ties else args


def _swim_tie_heavy(args, pig_k: int, seed: int):
    """``args`` with tie-heavy distributions: each row has a crowded hash
    class whose slot holds one of three ids of that class, and its packets
    (``pig_k > 0``) carry many live entries of those ids, the same id again
    with other views; views are small keys, often DOWN in the table and
    ALIVE in the packets (takes, then merges on the new id), sometimes -1,
    with equal keys common; senders sit on the self slot, on the crowded
    class, are the node itself or are negative; the failed probe's slot is
    often the self slot; timers and budgets are 0, 1 or 2 (timers expire,
    budgets run out), and the heard suspicion ties the incarnation's
    keys."""
    import torch

    from corrosion_tpu_torch import random as prng

    (mem_id, mem_view, old_id, old_view, timer, tx, alive, inc, node_id,
     self_slot, sus_heard, sends, probe_slot, suspect_key, probe_failed,
     ch_id, ch_view, ch_send, ch_valid, ch_snd, ch_snd_inc) = args
    n, m = mem_id.shape
    dev = mem_id.device
    ks = iter(prng.split(prng.fold_in(prng.key(seed), 1), 128))

    def ri(shape, lo, hi):
        return prng.randint(next(ks), shape, lo, hi, dev)

    def coin(shape, p):
        return prng.uniform(next(ks), shape, dev) < p

    crowd = ri((n, 1), 0, m)

    def in_crowd(shape):
        return crowd + m * ri(shape, 0, 3)

    def key(shape, common):
        state = torch.where(coin(shape, 0.5), common, ri(shape, 0, 4))
        return torch.where(coin(shape, 0.1), -1, ri(shape, 0, 3) * 4 + state)

    nm = (n, m)
    cols = torch.arange(m, dtype=torch.int32, device=dev)
    mem_id = torch.where(cols[None, :] == crowd, in_crowd(nm), mem_id)
    mem_view = key(nm, 2)
    old_id = torch.where(coin(nm, 0.7), mem_id, old_id)
    old_view = torch.where(coin(nm, 0.7), mem_view, key(nm, 1))
    inc = ri((n,), 0, 3)
    ids, views = [], []
    for ch in range(4):
        if pig_k:
            nk = (n, pig_k)
            ids.append(torch.where(coin(nk, 0.6), in_crowd(nk),
                                   torch.where(coin(nk, 0.3), -1, ch_id[ch])))
            views.append(key(nk, 0))
        else:
            # the table's id, another id, or the id an earlier channel took
            other = torch.where(coin(nm, 0.5), mem_id + m, ch_id[ch])
            got = torch.where(coin(nm, 0.4), mem_id, other)
            ids.append(torch.where(coin(nm, 0.3), ids[-1], got) if ids else got)
            views.append(key(nm, 0))
    snd = [torch.where(coin((n,), 0.3), node_id,
                       torch.where(coin((n,), 0.5), self_slot + m * ri((n,), 0, 3),
                                   in_crowd((n, 1))[:, 0]))
           for _ in range(4)]
    # a negative sender takes its slot by floor modulo, as Python's %
    snd = [torch.where(coin((n,), 0.1), -1 - ri((n,), 0, 2 * m), x) for x in snd]
    return (
        mem_id, mem_view, old_id, old_view,
        ri(nm, 0, 3).to(timer.dtype), ri(nm, 0, 3).to(tx.dtype),
        alive, inc, node_id, self_slot,
        torch.where(coin((n,), 0.6), inc * 4 + ri((n,), 0, 3), -1), ri((n,), 0, 3),
        torch.where(coin((n,), 0.5), self_slot, crowd[:, 0]), ri((n,), 0, 3) * 4 + 1,
        coin((n,), 0.6), ids, views, ch_send, ch_valid, snd,
        [ri((n,), 0, 3) for _ in range(4)],
    )


def _swim_collisions(args, pig_k: int) -> int:
    """Rows with a same-class collision: two live entries of valid packets
    in one hash class (``pig_k > 0``), or, on aligned rows, two row-addressed
    steps (a valid sender's slot, the failed probe's slot, the self slot)
    on one column."""
    import torch

    (mem_id, _, _, _, _, _, _, _, _, self_slot, _, _, probe_slot, _, probe_failed,
     ch_id, _, _, ch_valid, ch_snd, _) = args
    m = mem_id.shape[1]
    if pig_k:
        slots = [torch.where(v[:, None] & (i >= 0), i % m, -1) for i, v in zip(ch_id, ch_valid)]
    else:
        slots = [torch.where(v, s % m, -1)[:, None] for s, v in zip(ch_snd, ch_valid)]
        slots += [torch.where(probe_failed, probe_slot, -1)[:, None], self_slot[:, None]]
    slots = torch.cat(slots, dim=1)
    # an inactive step gets a distinct negative slot of its own
    idx = torch.arange(slots.shape[1], dtype=slots.dtype, device=slots.device)
    slots = torch.where(slots >= 0, slots, -1 - idx)
    s = torch.sort(slots, dim=1).values
    return int((s[:, 1:] == s[:, :-1]).any(dim=1).sum())


def _swim_bytes(args, out, pig_k: int = 0) -> int:
    """Bytes the swim kernel must move on these operands: every plane once,
    except what it skips by the data. A failed probe's slot and key are
    read only where the probe failed. A channel is read only on the rows
    where it is valid (its sender and sender incarnation too); there its
    view only where the id is live and sendable, its send flag only where
    the id is live. A packed channel (``pig_k > 0``) has no send flags, and
    its view is read where its entry's id is live. Every output is written
    once."""
    (mem_id, mem_view, old_id, old_view, timer, tx, alive, inc, node_id,
     self_slot, sus_heard, sends, probe_slot, suspect_key, probe_failed,
     ch_id, ch_view, ch_send, ch_valid, ch_snd, ch_snd_inc) = args
    m = mem_id.shape[1]
    total = _nbytes((mem_id, mem_view, old_id, old_view, timer, tx, alive, inc,
                     node_id, self_slot, sus_heard, sends, probe_failed))
    total += (probe_slot.element_size() + suspect_key.element_size()) * _count(probe_failed)
    for ch in range(4):
        valid = ch_valid[ch]
        rows = _count(valid)
        live = valid[:, None] & (ch_id[ch] >= 0)
        total += _nbytes((valid,))
        total += rows * (ch_snd[ch].element_size() + ch_snd_inc[ch].element_size()
                         + (pig_k or m) * ch_id[ch].element_size())
        if pig_k:
            total += _count(live) * ch_view[ch].element_size()
            continue
        total += _count(live) * ch_send[ch].element_size()
        total += _count(live & ch_send[ch]) * ch_view[ch].element_size()
    return total + _nbytes(_flat(out))


# The ingest kernel's forms: (messages per row from cfg, emit, enqueue_all,
# no drift reject, the messages' origin and version ranges and live share).
# "receive" is the scale round's piggyback batch, "receive_full" the full
# view's mailbox of recv_slots messages (versions mostly past the seen
# window, origins below n_origins, so that many rows record more messages
# than the queue holds), "write" the local write of
# ``broadcast.local_write``, "write_emit" the scale round's local write.
INGEST_FORMS = {
    "receive": (lambda cfg: 4 * cfg.pig_changes, False, False, False, (64, 40, 0.7)),
    "receive_full": (lambda cfg: cfg.recv_slots, False, False, False, (16, 4000, 0.9)),
    "write": (lambda cfg: 1, False, True, True, (64, 40, 0.7)),
    "write_emit": (lambda cfg: 1, True, True, True, (64, 40, 0.7)),
}


def _ingest_inputs(cfg, n: int, form: str, seed: int, dev, ties: bool = False):
    """Random valid operands of the ingest kernel in ``form`` at ``cfg``'s
    widths and queue-plane dtypes. With ``ties``, the inputs where a
    lane-parallel rank can part from the sequential loops: queue counters
    and budgets from {1, 2}, uniforms on a grid of quarters (equal float32
    draws), each row's messages on two cells with equal (clp, ver, val,
    site) and store cells that tie them, repeated (origin, dbv) pairs and
    repeated versions across origins in a row, live and dead, and a payload
    budget of a few slots."""
    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.ops.megakernel import IngestInputs, IngestParams
    from corrosion_tpu_torch.sim.broadcast import (
        CHANGE_WIRE_BYTES,
        HLC_MAX_DRIFT_ROUNDS,
        HLC_ROUND_BITS,
        plane_dtypes,
    )

    msgs, emit, enqueue_all, no_drift, (o_hi, dbv_hi, p_live) = INGEST_FORMS[form]
    m = msgs(cfg)
    ks = iter(prng.split(prng.key(seed), 64))

    def ri(shape, lo, hi):
        return prng.randint(next(ks), shape, lo, hi, dev)

    def coin(shape, p):
        return prng.uniform(next(ks), shape, dev) < p

    o, c, q = cfg.n_origins, cfg.n_cells, cfg.bcast_queue
    cdt, qdt = plane_dtypes(cfg)
    w = max(1, -(-cfg.buf_slots // 32))
    now = 50
    head = ri((n, o), 0, 30)
    seen_bits = torch.where(coin((n, o * w), 0.3), ri((n, o * w), 0, 8),
                            ri((n, o * w), -(1 << 31), (1 << 31) - 1))
    p = IngestParams(
        n_origins=o, n_cells=c, q_slots=q, seen_words=w,
        hlc_round_bits=HLC_ROUND_BITS,
        hlc_max_drift=(1 << 20) if no_drift else HLC_MAX_DRIFT_ROUNDS,
        pig_r=cfg.pig_changes if emit else 0,
        budget_bytes=cfg.bcast_budget_bytes, wire_bytes=CHANGE_WIRE_BYTES,
        keep_rounds=cfg.org_keep_rounds, enqueue_all=enqueue_all,
    )
    x = IngestInputs(
        live=coin((n, m), p_live), origin=ri((n, m), -1, o_hi), dbv=ri((n, m), 0, dbv_hi),
        cell=ri((n, m), -1, c + 1), ver=ri((n, m), 0, 8), val=ri((n, m), 0, 4),
        site=ri((n, m), 0, 4), clp=ri((n, m), 0, 2),
        ts=ri((n, m), (now - 3) << HLC_ROUND_BITS, (now + 4) << HLC_ROUND_BITS),
        budget=torch.full((n, m), 2, dtype=torch.int32, device=dev),
        store=(ri((n, c), 0, 8), ri((n, c), 0, 4), ri((n, c), 0, 4),
               ri((n, c), 0, 40), ri((n, c), 0, 2)),
        head=head, km=head + ri((n, o), 0, 10), seen=seen_bits,
        org_id=torch.where(coin((n, o), 0.8),
                           torch.arange(o, dtype=torch.int32, device=dev).expand(n, o),
                           ri((n, o), -1, 64)),
        org_last=ri((n, o), 0, 60),
        q_origin=torch.where(coin((n, q), 0.5), -1, ri((n, q), 0, 64)),
        q_dbv=ri((n, q), 0, 40), q_cell=ri((n, q), 0, c).to(cdt),
        q_ver=ri((n, q), 0, 8), q_val=ri((n, q), 0, 4), q_site=ri((n, q), 0, 4),
        q_clp=ri((n, q), 0, 2), q_ts=ri((n, q), 0, now << HLC_ROUND_BITS),
        q_tx=ri((n, q), 0, 4).to(qdt),
        hlc=ri((n,), 0, now << HLC_ROUND_BITS),
        now=torch.tensor(now, dtype=torch.int32, device=dev),
        rand=prng.uniform(next(ks), (n, q), dev) if emit else None,
        carried=ri((n,), 0, 5) if emit else None,
    )
    if ties:
        # a budget that lets 1 to 3 live slots through the payload mask
        p = p._replace(budget_bytes=3 * CHANGE_WIRE_BYTES)
        x = _tie_heavy(x, c, ri, coin)
    return p, x


def _tie_heavy(x, c: int, ri, coin):
    """``x`` with the tie-heavy distributions of ``_ingest_inputs``."""
    import torch

    n, m = x.origin.shape
    q = x.q_origin.shape[1]
    dev = x.origin.device
    idx = torch.arange(m, device=dev).expand(n, m)
    # an earlier message of the row, up to 8 back
    back = torch.clamp(idx - ri((n, m), 1, 9).long(), min=0)
    rep = coin((n, m), 0.3) & (idx > 0)
    origin = torch.where(rep, x.origin.gather(1, back), x.origin)
    dbv = torch.where(rep, x.dbv.gather(1, back), x.dbv)
    # the same version from another origin: a full five-key LWW tie
    back2 = torch.clamp(idx - ri((n, m), 1, 9).long(), min=0)
    dbv = torch.where(coin((n, m), 0.2) & (idx > 0), dbv.gather(1, back2), dbv)
    cell_a = ri((n, 1), 0, c)
    cell_b = (cell_a + ri((n, 1), 1, c)) % c
    cell = torch.where(coin((n, m), 0.5), cell_a, cell_b)
    cell = torch.where(coin((n, m), 0.05), -1, cell)
    keys = (5, 1, 2, 1)  # ver, val, site, clp of every message

    def const(t, v):
        return torch.full_like(t, v)

    store = list(x.store)
    for i, v in zip((0, 1, 2, 4), keys):
        store[i] = torch.where(coin(store[i].shape, 0.5), const(store[i], v), store[i])
    rand = None if x.rand is None else torch.floor(x.rand * 4) / 4
    return x._replace(
        origin=origin, dbv=dbv, cell=cell, ver=const(x.ver, keys[0]),
        val=const(x.val, keys[1]), site=const(x.site, keys[2]),
        clp=const(x.clp, keys[3]), budget=ri((n, m), 1, 3),
        store=tuple(store), q_tx=ri((n, q), 1, 3).to(x.q_tx.dtype), rand=rand)


def _ingest_bytes(x, out) -> int:
    """Bytes the ingest kernel must move on these operands: every plane
    once, except a message's cell, version, value, site, causal length and
    budget, which it reads only for fresh messages (only they are applied or
    enqueued). Every output is written once."""
    lazy = (x.cell, x.ver, x.val, x.site, x.clp, x.budget)
    lazy_ids = {id(t) for t in lazy}
    total = _nbytes(t for t in _flat(tuple(x)) if id(t) not in lazy_ids)
    total += _count(out.fresh) * sum(t.element_size() for t in lazy)
    return total + _nbytes(_flat(tuple(out)))


def _hold(name, got, want) -> int:
    err = _max_abs_err(_flat(tuple(got)), _flat(tuple(want)))
    if err != 0:
        raise AssertionError(f"{name}: kernel != plain version (max abs err {err})")
    return err


def _time_form(name, kernel, run, plain, nbytes, ops) -> dict:
    """Hold one form of ``kernel`` against its plain version, then time both
    (20 calls of the kernel, 3 of the plain version)."""
    import torch

    got, want = run(), plain()
    torch.cuda.synchronize()
    r = dict(kernel=kernel, max_abs_err=_hold(name, got, want), ms=_cuda_ms(run, 20),
             device_ms=_device_ms(run, 20, f"{kernel.removesuffix('_emit')}_kernel"),
             plain_ms=_cuda_ms(plain, 3), bytes=nbytes(got), ops=ops(got))
    del got, want
    r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["ops"])
    print(f"[kernels] {name}: max_abs_err={r['max_abs_err']} "
          f"kernel {r['ms']!r} ms (device {r['device_ms']!r} ms), plain "
          f"{r['plain_ms']!r} ms, {r['bytes']} bytes, {r['ops']} int32 ops, bound "
          f"{r['bound_ms']!r} ms by {r['bound_by']}", flush=True)
    return r


def _swim_form(name, cfg, seed, dev, **kw) -> dict:
    """One swim kernel form at ``cfg``'s shapes, held and timed."""
    from corrosion_tpu_torch.ops import megakernel as mk

    n, m, k = cfg.n_nodes, cfg.m_slots, kw.get("pig_k", 0)
    consts = (m, cfg.suspicion_rounds, cfg.down_purge_rounds,
              cfg.max_transmissions, k)
    args = _swim_inputs(n, m, cfg.timer_dtype, seed, dev, **kw)

    def run():
        return mk.swim_tables_fused(consts, *args)

    def plain():
        return mk.swim_tables_plain(consts, *args)

    r = _time_form(name, "swim_tables", run, plain,
                   lambda got: _swim_bytes(args, got, k), lambda got: _swim_ops(args, k))
    r["replaces"] = "corrosion_tpu/ops/megakernel.py:1063"
    _hold_swim_ties(name, cfg, seed, dev, **kw)
    return r


def _hold_swim_ties(name, cfg, seed, dev, **kw) -> None:
    """The swim form on tie-heavy inputs (``_swim_inputs(ties=True)``), its
    own seed, N three past the configuration's so that the last block of
    rows is partial: held bitwise against the plain version, untimed; at
    least one row must have a same-class collision."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk

    n, m, k = cfg.n_nodes + 3, cfg.m_slots, kw.get("pig_k", 0)
    consts = (m, cfg.suspicion_rounds, cfg.down_purge_rounds, cfg.max_transmissions, k)
    args = _swim_inputs(n, m, cfg.timer_dtype, seed + 1000, dev, ties=True, **kw)
    got, want = mk.swim_tables_fused(consts, *args), mk.swim_tables_plain(consts, *args)
    torch.cuda.synchronize()
    _hold(f"{name} (tie-heavy)", got, want)
    rows = _swim_collisions(args, k)
    print(f"[kernels] {name}: tie-heavy inputs at N={n} bitwise equal "
          f"({rows} rows with a same-class collision)", flush=True)
    if rows <= 0:
        raise AssertionError(f"{name}: no row with a same-class collision")


def _owned(p, x, out):
    """Messages on a book slot that tracks their origin after the claim."""
    import torch

    slot = (torch.clamp(x.origin, min=0) % p.n_origins).long()
    return (x.origin >= 0) & (torch.gather(out.org_id, 1, slot) == x.origin)


def _recorded_past_queue(p, x, out) -> int:
    """Rows whose recorded messages (fresh and owned) outnumber the queue's
    slots."""
    return int(((out.fresh & _owned(p, x, out)).sum(dim=1) > p.q_slots).sum())


def _ingest_form(name, cfg, form, seed, dev) -> dict:
    """One ingest kernel form at ``cfg``'s shapes, held and timed."""
    from corrosion_tpu_torch.ops import megakernel as mk

    p, x = _ingest_inputs(cfg, cfg.n_nodes, form, seed, dev)
    r = _time_form(
        name, "ingest_emit" if p.pig_r else "ingest",
        lambda: mk.ingest(p, x), lambda: mk.ingest_plain(p, x),
        lambda got: _ingest_bytes(x, got), lambda got: _ingest_ops(p, x, got))
    r["replaces"] = "corrosion_tpu/ops/megakernel.py:" + ("960" if form.startswith("write") else "795")
    if form == "receive_full":
        _require_past_queue(name, p, x, mk.ingest_plain(p, x))
    _hold_ties(name, cfg, form, seed, dev)
    return r


def _require_past_queue(name, p, x, out) -> None:
    rows = _recorded_past_queue(p, x, out)
    print(f"[kernels] {name}: {rows} of {x.origin.shape[0]} rows recorded more "
          f"messages than the queue's {p.q_slots} slots", flush=True)
    if rows <= 0:
        raise AssertionError(f"{name}: no row recorded more than Q messages")


def _hold_ties(name, cfg, form, seed, dev) -> None:
    """The form on tie-heavy inputs (``_ingest_inputs(ties=True)``), its own
    seed, N three past the configuration's so that the last block of rows
    is partial: held bitwise against the plain version, untimed."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk

    n = cfg.n_nodes + 3
    p, x = _ingest_inputs(cfg, n, form, seed + 1000, dev, ties=True)
    got, want = mk.ingest(p, x), mk.ingest_plain(p, x)
    torch.cuda.synchronize()
    _hold(f"{name} (tie-heavy)", got, want)
    if form == "receive_full":
        _require_past_queue(f"{name} (tie-heavy)", p, x, want)
    print(f"[kernels] {name}: tie-heavy inputs at N={n} bitwise equal "
          f"({_count(want.fresh)} fresh messages)", flush=True)


def _bits(dtype) -> str:
    return str(dtype)[len("torch.int"):]


def phase_kernels(dev) -> dict:
    """Each kernel form against its plain version, held bitwise and timed, at
    the shapes of the path that runs it. Each result names that path and its
    launch-count key (``FORM_LAUNCHES``), or no path for the forms no path
    here runs (timed at the shapes of the configuration they belong to)."""
    import torch

    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    flag = scale_sim_config(FLAGSHIP_NODES)
    wide = scale_sim_config(FLAGSHIP_NODES, narrow_dtypes=False)
    big = million_config(MILLION_NODES)
    full = full_view_config(FULL_NODES)
    k = big.pig_members
    forms = [  # name, path, launch key, measurement
        ("swim_tables", "flagship", ("swim_tables", "aligned/16/16"),
         lambda n: _swim_form(n, flag, 11, dev)),
        ("ingest", "flagship", ("ingest", "16/16"),
         lambda n: _ingest_form(n, flag, "receive", 27, dev)),
        ("ingest_emit", "flagship", ("ingest_emit", "16/16"),
         lambda n: _ingest_form(n, flag, "write_emit", 32, dev)),
        ("swim_tables_packed_i8", "million", ("swim_tables", "packed/16/8"),
         lambda n: _swim_form(n, big, 13, dev, tx_dtype=torch.int8, pig_k=k)),
        ("ingest_q_i8", "million", ("ingest", "16/8"),
         lambda n: _ingest_form(n, big, "receive", 41, dev)),
        ("ingest_emit_q_i8", "million", ("ingest_emit", "16/8"),
         lambda n: _ingest_form(n, big, "write_emit", 42, dev)),
        ("ingest_full", "full", ("ingest", "32/32/m96"),
         lambda n: _ingest_form(n, full, "receive_full", 51, dev)),
        ("ingest_write_full", "full", ("ingest", "32/32"),
         lambda n: _ingest_form(n, full, "write", 52, dev)),
        ("ingest_empty", "pig0", ("ingest", "16/16/m0"),
         lambda n: _ingest_form(n, scale_sim_config(FLAGSHIP_NODES, pig_changes=0),
                                "receive", 53, dev)),
    ]
    for c, form, seed in ((wide, "receive", 36), (wide, "write", 37),
                          (wide, "write_emit", 38), (flag, "write", 39),
                          (big, "write", 40)):
        name = (f"ingest_{form}_{_bits(c.timer_dtype)}_{_bits(c.q_dtype)}"
                f"_n{c.n_nodes}")
        forms.append((name, None, None,
                      lambda n, c=c, form=form, seed=seed: _ingest_form(n, c, form, seed, dev)))
    for c, kw, seed in ((wide, {}, 12),
                        (scale_sim_config(MILLION_NODES),
                         dict(tx_dtype=torch.int16, pig_k=k), 15),
                        (scale_sim_config(MILLION_NODES, narrow_dtypes=False),
                         dict(pig_k=k), 16),
                        (scale_sim_config(MILLION_NODES), dict(tx_dtype=torch.int8), 17)):
        name = (f"swim_tables_{'packed' if kw.get('pig_k') else 'aligned'}_"
                f"{_bits(c.timer_dtype)}_{_bits(kw.get('tx_dtype', c.timer_dtype))}"
                f"_n{c.n_nodes}")
        forms.append((name, None, None,
                      lambda n, c=c, kw=kw, seed=seed: _swim_form(n, c, seed, dev, **kw)))
    out = {}
    for name, path, key, measure in forms:
        out[name] = measure(name)
        out[name].update(path=path, launch_key=key)
    return out


def _trajectory_setup(cfg, rounds: int, dev):
    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.sim.scale_step import ScaleSimState, make_write_inputs
    from corrosion_tpu_torch.sim.transport import NetModel

    n = cfg.n_nodes
    k_w, k_in = prng.split(prng.key(7))
    inputs = make_write_inputs(
        cfg, k_in, rounds, prng.uniform(k_w, (rounds, n), "cpu") < 0.02, "cpu")
    kill = torch.zeros((rounds, n), dtype=torch.bool)
    revive = torch.zeros((rounds, n), dtype=torch.bool)
    kill[4, 100:132] = True
    revive[10, 100:116] = True
    inputs = inputs._replace(kill=kill, revive=revive)
    inputs = type(inputs)(*(a.to(dev) for a in inputs))
    st = ScaleSimState.create(cfg, dev)
    net = NetModel.create(n, drop_prob=0.05, device=dev)
    return st, net, prng.key(3), inputs


def phase_trajectory(dev, label, make_cfg, rounds: int = 16, tag: str = "trajectory"):
    """The card == the CPU, for ``make_cfg(TRAJECTORY_NODES, ...)``: the
    kernel route on the card against the plain versions on the CPU (and the
    plain route on both where the config takes it). Returns the card's
    launch counts per form, and the info sums."""
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import ScaleRoundInput, scale_run_rounds_carry

    cfg = make_cfg(TRAJECTORY_NODES, sync_interval=2, sync_sweep_every=2)
    runs = {d: _trajectory_setup(cfg, rounds, d) for d in ("cpu", dev)}
    carry = {d: (runs[d][0], runs[d][2]) for d in runs}
    t0 = time.perf_counter()
    mk.reset_launches()
    sums = {}
    for r in range(rounds):
        infos = {}
        for d, (_, net, _, inputs) in runs.items():
            one = ScaleRoundInput(*(a[r:r + 1] for a in inputs))
            st, key = carry[d]
            carry[d], infos[d] = scale_run_rounds_carry(cfg, st, net, key, one)
        a, b = _flat(carry["cpu"][0]), [t.cpu() for t in _flat(carry[dev][0])]
        err = _max_abs_err(a, b)
        ierr = _max_abs_err(_flat(infos["cpu"]), [t.cpu() for t in _flat(infos[dev])])
        if err or ierr:
            raise AssertionError(f"{label} round {r}: cuda != cpu (state {err}, info {ierr})")
        for k, v in infos["cpu"].items():
            sums[k] = sums.get(k, 0) + int(v.sum())
    forms = dict(mk.FORM_LAUNCHES)
    print(f"[{tag}] N={cfg.n_nodes} {label}: {rounds} rounds, "
          f"every leaf and info bitwise equal cuda vs cpu "
          f"({time.perf_counter() - t0:.1f} s); card launches {forms}", flush=True)
    return forms, sums


#: the tx-trajectory configurations: (label, overrides)
TX_TRAJECTORIES = (("tx4", dict(tx_max_cells=4)),
                   ("wirebudget", dict(bcast_wire_budget=True)),
                   ("pig0", dict(pig_changes=0)))


def phase_tx_trajectory(dev) -> dict:
    """Phase 3's trajectory for multi-cell transactions, the wire-budget
    lane and ``pig_changes=0``, with the launches their routes imply."""
    from corrosion_tpu_torch.sim.broadcast import plane_dtypes
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    out = {}
    for label, over in TX_TRAJECTORIES:
        rounds = 16
        forms, sums = phase_trajectory(
            dev, label, lambda n, **kw: scale_sim_config(n, **kw, **over),
            rounds, "tx-trajectory")
        cfg = scale_sim_config(TRAJECTORY_NODES, **over)
        swim = sum(v for (k, _), v in forms.items() if k == "swim_tables")
        ingest = {f: v for (k, f), v in forms.items() if k != "swim_tables"}
        cdt, qdt = plane_dtypes(cfg)
        q = f"{_bits(cdt)}/{_bits(qdt)}"
        want = ({q: rounds, f"{q}/m0": rounds} if label == "pig0" else {})
        if swim != rounds or ingest != want:
            raise AssertionError(f"{label}: swim launches {swim} != {rounds} or ingest "
                                 f"launches {ingest} != {want}")
        if label == "tx4" and sums["tx_completed"] <= 0:
            raise AssertionError(f"{label}: no transaction completed ({sums})")
        if label != "pig0" and sums["fresh"] <= 0:
            raise AssertionError(f"{label}: nothing fresh ({sums})")
        out[label] = {"forms": forms}
    return out


def phase_flagship(dev) -> dict:
    """bench.py's flagship workload through the port's entry points."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        scale_run_rounds_carry,
        scale_sim_config,
    )

    cfg = scale_sim_config(FLAGSHIP_NODES)
    # three timed batches of 8 rounds show the spread within one run
    n, warm, batch, reps = cfg.n_nodes, 2, 8, 3
    rounds = batch * reps
    total = warm + rounds
    st, net, key, inputs = flagship_workload(cfg, total, dev)

    def part(lo, hi):
        return ScaleRoundInput(*(a[lo:hi] for a in inputs))

    (st, key), _ = scale_run_rounds_carry(cfg, st, net, key, part(0, warm))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    rates, batch_infos = [], []
    for lo in range(warm, total, batch):
        t0 = time.perf_counter()
        (st, key), infos = scale_run_rounds_carry(cfg, st, net, key, part(lo, lo + batch))
        torch.cuda.synchronize()
        rates.append(batch / (time.perf_counter() - t0))
        batch_infos.append(infos)
    launches, forms = dict(mk.LAUNCHES), dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"swim_tables": rounds, "ingest": rounds, "ingest_emit": rounds}
    want_forms = {("swim_tables", "aligned/16/16"): rounds, ("ingest", "16/16"): rounds,
                  ("ingest_emit", "16/16"): rounds}
    if launches != want or forms != want_forms:
        raise AssertionError(f"launch counts {launches} {forms} != {want}")
    sums = {k: sum(int(i[k].sum()) for i in batch_infos) for k in batch_infos[0]}
    if sums["fresh"] <= 0 or sums["delivered"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"flagship run moved nothing: {sums}")
    if int(st.crdt.now) != total or st.swim.mem_id.shape != (n, cfg.m_slots):
        raise AssertionError("flagship state has the wrong round or shape")
    median = sorted(rates)[len(rates) // 2]
    print(f"[flagship] N={n}: {reps} batches of {batch} rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {median!r}; peak device "
          f"memory {peak} bytes; launches {launches}; info sums {sums}", flush=True)
    return {"rounds_per_s": median, "peak_bytes": peak, "forms": forms}


def phase_million(dev) -> dict:
    """The 1M point (bounded member piggyback, int8 budget and queue-counter
    planes) with the flagship's workload, through the port's entry points."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        million_config,
        scale_run_rounds_carry,
    )

    cfg = million_config(MILLION_NODES)
    n, warm, batch, reps = cfg.n_nodes, 2, 4, 3
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    st, state_bytes, rates, batch_infos = _timed_batches(
        lambda: flagship_workload(cfg, total, dev),
        lambda s, net, k, i: scale_run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: ScaleRoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    launches, forms = dict(mk.LAUNCHES), dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"swim_tables": total, "ingest": total, "ingest_emit": total}
    want_forms = {("swim_tables", "packed/16/8"): total, ("ingest", "16/8"): total,
                  ("ingest_emit", "16/8"): total}
    if launches != want or forms != want_forms:
        raise AssertionError(f"1M launch counts {launches} {forms} != {want_forms}")
    sums = {k: sum(int(i[k].sum()) for i in batch_infos) for k in batch_infos[0]}
    sync_rounds = sum(int((i["syncs"] > 0).sum()) for i in batch_infos)
    if sums["fresh"] <= 0 or sums["delivered"] <= 0 or sync_rounds != 1:
        raise AssertionError(f"1M run: {sync_rounds} sync rounds, sums {sums}")
    if (int(st.crdt.now) != total or st.swim.mem_tx.dtype != torch.int8
            or st.crdt.q_tx.dtype != torch.int8 or _nbytes(_flat(st)) != state_bytes):
        raise AssertionError("1M state has the wrong round, dtypes or size")
    median = sorted(rates)[len(rates) // 2]
    print(f"[million] N={n} pig_members={cfg.pig_members} int8 mem_tx/q_tx: {reps} batches of {batch} rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {median!r}; peak device "
          f"memory {peak} bytes; carried state {state_bytes} bytes "
          f"({state_bytes / n!r} B/node); launches {forms}; info sums {sums}",
          flush=True)
    return {"rounds_per_s": median, "peak_bytes": peak, "forms": forms}


def phase_full_trajectory(dev) -> None:
    """The full-view round on the card == on the CPU, every leaf and info
    value after every round, at ``FULL_TRAJECTORY_NODES``, with the full
    view's workload (``scenario.full_view_workload``: churn, conflict-heavy
    writes, 1 % loss)."""
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scenario import full_view_workload
    from corrosion_tpu_torch.sim.step import RoundInput, run_rounds_carry

    cfg = full_view_config(FULL_TRAJECTORY_NODES)
    rounds = 16
    runs = {d: full_view_workload(cfg, rounds, d) for d in ("cpu", dev)}
    carry = {d: (runs[d][0], runs[d][2]) for d in runs}
    t0 = time.perf_counter()
    sums = {}
    for r in range(rounds):
        infos = {}
        for d, (_, net, _, inputs) in runs.items():
            one = RoundInput(*(a[r:r + 1] for a in inputs))
            st, key = carry[d]
            carry[d], infos[d] = run_rounds_carry(cfg, st, net, key, one)
        a, b = _flat(carry["cpu"][0]), [t.cpu() for t in _flat(carry[dev][0])]
        err = _max_abs_err(a, b)
        ierr = _max_abs_err(_flat(infos["cpu"]), [t.cpu() for t in _flat(infos[dev])])
        if err or ierr:
            raise AssertionError(f"full view round {r}: cuda != cpu (state {err}, info {ierr})")
        for k, v in infos["cpu"].items():
            sums[k] = sums.get(k, 0) + int(v.sum())
    if sums["fresh"] <= 0 or sums["syncs"] <= 0 or sums["failed_probes"] <= 0:
        raise AssertionError(f"full view trajectory moved nothing: {sums}")
    print(f"[full-trajectory] N={cfg.n_nodes}: {rounds} rounds of full_mix, every "
          f"leaf and info bitwise equal cuda vs cpu ({time.perf_counter() - t0:.1f} s); "
          f"info sums {sums}", flush=True)


def _with_transactions(cfg, inputs, dev):
    """``inputs`` with one transaction a round for each writing origin: each
    origin writes with probability 1/2, ``tx_len`` uniform in 1..K, cells
    (with replacement) and values uniform, all drawn from key 13."""
    import torch

    from corrosion_tpu_torch import random as prng

    rounds, n = inputs.kill.shape
    k = cfg.tx_max_cells
    k_w, k_len, k_cell, k_val = prng.split(prng.key(13), 4)
    writer = torch.arange(n, device=dev) < cfg.n_origins
    return inputs._replace(
        tx_mask=(prng.uniform(k_w, (rounds, n), dev) < 0.5) & writer,
        tx_len=prng.randint(k_len, (rounds, n), 1, k + 1, dev),
        tx_cell=prng.randint(k_cell, (rounds, n, k), 0, cfg.n_cells, dev),
        tx_val=prng.randint(k_val, (rounds, n, k), 0, 1 << 20, dev),
    )


def _tx_workload(cfg, rounds: int, dev):
    """The full view's workload with :func:`_with_transactions`."""
    from corrosion_tpu_torch.sim.scenario import full_view_workload

    st, net, key, inputs = full_view_workload(cfg, rounds, dev)
    return st, net, key, _with_transactions(cfg, inputs, dev)


def phase_full_tx_trajectory(dev) -> None:
    """The full view at ``tx_max_cells=8`` on the card == on the CPU, every
    leaf and info value after every round, with seeded transactions; the
    plain route launches no kernel."""
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.config import wan_config
    from corrosion_tpu_torch.sim.step import RoundInput, run_rounds_carry

    cfg = wan_config(FULL_TRAJECTORY_NODES, n_origins=16)
    rounds = 16
    runs = {d: _tx_workload(cfg, rounds, d) for d in ("cpu", dev)}
    carry = {d: (runs[d][0], runs[d][2]) for d in runs}
    t0 = time.perf_counter()
    mk.reset_launches()
    sums = {}
    for r in range(rounds):
        infos = {}
        for d, (_, net, _, inputs) in runs.items():
            one = RoundInput(*(a[r:r + 1] for a in inputs))
            st, key = carry[d]
            carry[d], infos[d] = run_rounds_carry(cfg, st, net, key, one)
        err = _max_abs_err(_flat(carry["cpu"][0]), [t.cpu() for t in _flat(carry[dev][0])])
        ierr = _max_abs_err(_flat(infos["cpu"]), [t.cpu() for t in _flat(infos[dev])])
        if err or ierr:
            raise AssertionError(f"full view tx round {r}: cuda != cpu (state {err}, "
                                 f"info {ierr})")
        for k, v in infos["cpu"].items():
            sums[k] = sums.get(k, 0) + int(v.sum())
    forms = dict(mk.FORM_LAUNCHES)
    if sums["tx_completed"] <= 0 or sums["fresh"] <= 0 or sums["syncs"] <= 0 or forms:
        raise AssertionError(f"full view tx trajectory: sums {sums}, launches {forms}")
    print(f"[full-tx-trajectory] N={cfg.n_nodes} tx_max_cells={cfg.tx_max_cells} "
          f"partial_slots={cfg.partial_slots}: {rounds} rounds, every leaf and info "
          f"bitwise equal cuda vs cpu ({time.perf_counter() - t0:.1f} s); no kernel "
          f"launched; info sums {sums}", flush=True)


def _timed_batches(make, run, cut, warm: int, batch: int, reps: int):
    """Build the workload with ``make()`` (``(state, net, key, inputs)``),
    run ``warm`` rounds, then ``reps`` timed batches of ``batch`` rounds of
    ``run(state, net, key, cut(inputs, lo, hi))``. Only this frame holds
    the state, so the first round's input state is freed as in a plain
    loop and the peak memory is the run's own. Returns ``(final state,
    the initial state's bytes, rates, infos of the warm-up and of every
    batch)``."""
    import torch

    st, net, key, inputs = make()
    state_bytes = _nbytes(_flat(st))
    (st, key), warm_infos = run(st, net, key, cut(inputs, 0, warm))
    torch.cuda.synchronize()
    rates, infos = [], [warm_infos]
    for lo in range(warm, warm + batch * reps, batch):
        t0 = time.perf_counter()
        (st, key), got = run(st, net, key, cut(inputs, lo, lo + batch))
        torch.cuda.synchronize()
        rates.append(batch / (time.perf_counter() - t0))
        infos.append(got)
    return st, state_bytes, rates, infos


def _spread(rates) -> tuple:
    """(median, first quartile, third quartile) of the batch rates."""
    import statistics

    q1, med, q3 = statistics.quantiles(rates, n=4, method="inclusive")
    return med, q1, q3


def phase_scale_point(dev, name: str, **over) -> dict:
    """``scale_sim_config(FLAGSHIP_NODES, n_origins=16, **over)`` with the
    flagship's workload: ten timed batches of 2 rounds after 2 warm-up
    rounds; the swim kernel once a round, the ingest kernel never."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        scale_run_rounds_carry,
        scale_sim_config,
    )

    cfg = scale_sim_config(FLAGSHIP_NODES, n_origins=16, **over)
    n, warm, batch, reps = cfg.n_nodes, 2, 2, 10
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    st, _, rates, infos = _timed_batches(
        lambda: flagship_workload(cfg, total, dev),
        lambda s, net, k, i: scale_run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: ScaleRoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    launches, forms = dict(mk.LAUNCHES), dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"swim_tables": total, "ingest": 0, "ingest_emit": 0}
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches} != {want}")
    sums = {k: sum(int(i[k].sum()) for i in infos) for k in infos[0]}
    if sums["fresh"] <= 0 or sums["delivered"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"{name} run moved nothing: {sums}")
    if cfg.tx_max_cells > 1 and sums["tx_completed"] <= 0:
        raise AssertionError(f"{name}: no transaction completed: {sums}")
    if int(st.crdt.now) != total or st.crdt.partials.cell.shape[2] != cfg.tx_max_cells:
        raise AssertionError(f"{name} state has the wrong round or partial buffer")
    med, q1, q3 = _spread(rates)
    print(f"[{name}] N={n} {over}: {reps} batches of {batch} rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles {q1!r}-{q3!r}); "
          f"peak device memory {peak} bytes; launches {forms}; info sums {sums}",
          flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def phase_full_tx(dev) -> dict:
    """The full view at ``wan_config(FULL_NODES, n_origins=16)``
    (``tx_max_cells=8``) with seeded transactions: ten timed batches of one
    round after 2 warm-up rounds; no kernel launches."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.config import wan_config
    from corrosion_tpu_torch.sim.step import RoundInput, crdt_metrics, run_rounds_carry

    cfg = wan_config(FULL_NODES, n_origins=16)
    n, warm, batch, reps = cfg.n_nodes, 2, 1, 10
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    st, state_bytes, rates, infos = _timed_batches(
        lambda: _tx_workload(cfg, total, dev),
        lambda s, net, k, i: run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: RoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    forms = dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sums = {k: sum(int(i[k].sum()) for i in infos) for k in infos[0]}
    if forms or sums["tx_completed"] <= 0 or sums["fresh"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"full view tx run: launches {forms}, sums {sums}")
    if int(st.crdt.now) != total or _nbytes(_flat(st)) != state_bytes:
        raise AssertionError("full view tx state has the wrong round or size")
    metrics = {k: v.item() for k, v in crdt_metrics(cfg, st).items()}
    med, q1, q3 = _spread(rates)
    print(f"[full-tx] N={n} tx_max_cells={cfg.tx_max_cells} partial_slots="
          f"{cfg.partial_slots} recv_slots={cfg.recv_slots}: {reps} batches of {batch} "
          f"round at {[repr(x) for x in rates]} rounds/s, median {med!r} (quartiles "
          f"{q1!r}-{q3!r}); peak device memory {peak} bytes; carried state "
          f"{state_bytes} bytes; launches {forms}; info sums {sums}; metrics {metrics}",
          flush=True)
    return {"rounds_per_s": med, "peak_bytes": peak, "forms": forms}


def phase_full(dev) -> dict:
    """The full view at ``FULL_NODES`` through the port's entry points: the
    ingest kernel launches once a round as the local write (m=1) and once as
    the recv_slots-wide receive batch, and the swim kernel never."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scenario import full_view_workload
    from corrosion_tpu_torch.sim.step import RoundInput, crdt_metrics, run_rounds_carry

    cfg = full_view_config(FULL_NODES)
    n, warm, batch, reps = cfg.n_nodes, 2, 4, 3
    total = warm + batch * reps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    st, state_bytes, rates, batch_infos = _timed_batches(
        lambda: full_view_workload(cfg, total, dev),
        lambda s, net, k, i: run_rounds_carry(cfg, s, net, k, i),
        lambda inputs, lo, hi: RoundInput(*(a[lo:hi] for a in inputs)),
        warm, batch, reps)
    forms = dict(mk.FORM_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want_forms = {("ingest", "32/32"): total,
                  ("ingest", f"32/32/m{cfg.recv_slots}"): total}
    if forms != want_forms:
        raise AssertionError(f"full view launch counts {forms} != {want_forms}")
    sums = {k: sum(int(i[k].sum()) for i in batch_infos) for k in batch_infos[0]}
    if sums["fresh"] <= 0 or sums["sent"] <= 0 or sums["syncs"] <= 0:
        raise AssertionError(f"full view run moved nothing: {sums}")
    if (int(st.crdt.now) != total or st.swim.view.shape != (n, n)
            or _nbytes(_flat(st)) != state_bytes):
        raise AssertionError("full view state has the wrong round, shape or size")
    metrics = {k: v.item() for k, v in crdt_metrics(cfg, st).items()}
    median = sorted(rates)[len(rates) // 2]
    print(f"[full] N={n} recv_slots={cfg.recv_slots} Q={cfg.bcast_queue} "
          f"fanout={cfg.bcast_fanout}: {reps} batches of {batch} rounds at "
          f"{[repr(x) for x in rates]} rounds/s, median {median!r} (spread "
          f"{min(rates)!r}-{max(rates)!r}); peak device memory {peak} bytes; "
          f"carried state {state_bytes} bytes ({state_bytes / n!r} B/node); "
          f"launches {forms}; info sums {sums}; metrics {metrics}", flush=True)
    return {"rounds_per_s": median, "peak_bytes": peak, "forms": forms}


def phase_quiet(dev) -> None:
    """The quiet round on the card == the dense round on the card and the
    quiet round on the CPU, on a settled trace (the JAX package's quiet-test
    shape, with the 1M point's tiers and bounded packets of 4 entries). Its
    fixpoint branch runs, and launches no kernel: each kernel launches once
    in every dense round of the card's quiet run."""
    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleSimState,
        make_write_inputs,
        million_config,
        scale_run_rounds,
    )
    from corrosion_tpu_torch.sim.transport import NetModel

    n, rounds = 48, 48
    shape = dict(m_slots=8, n_origins=4, n_rows=4, n_cols=2, sync_interval=4,
                 pig_members=4)

    def run(quiet, d):
        cfg = million_config(n, quiet=quiet, **shape)
        inputs = make_write_inputs(cfg, prng.key(8), rounds,
                                   torch.zeros((rounds, n), dtype=torch.bool), d)
        return scale_run_rounds(cfg, ScaleSimState.create(cfg, d),
                                NetModel.create(n, device=d), prng.key(0), inputs)

    st_d, i_d = run("off", dev)
    mk.reset_launches()
    st_q, i_q = run("on", dev)
    torch.cuda.synchronize()
    forms = dict(mk.FORM_LAUNCHES)
    st_c, i_c = run("on", "cpu")
    cheap = int(i_q["quiet_round"].sum())
    dense = rounds - cheap
    want_forms = {("swim_tables", "packed/16/8"): dense, ("ingest", "16/8"): dense,
                  ("ingest_emit", "16/8"): dense}
    err = _max_abs_err(_flat(st_d), _flat(st_q))
    ierr = _max_abs_err(_flat(i_d), _flat({k: i_q[k] for k in i_d}))
    cerr = _max_abs_err(_flat(st_c), [t.cpu() for t in _flat(st_q)])
    cierr = _max_abs_err(_flat(i_c), [t.cpu() for t in _flat(i_q)])
    if err or ierr or cerr or cierr or cheap <= 0 or forms != want_forms:
        raise AssertionError(
            f"quiet round: vs dense state err {err}, info err {ierr}; vs cpu state "
            f"err {cerr}, info err {cierr}; {cheap} fixpoint rounds; launches "
            f"{forms} != {want_forms}")
    print(f"[quiet] N={n}: {rounds} rounds, quiet == dense on the card and == quiet "
          f"on the cpu, bitwise; {cheap} fixpoint rounds, "
          f"{int(i_q['quiet_backstop'].sum())} backstop rounds; launches {forms}",
          flush=True)


#: the parity phase's scripts: (label, generator, its arguments after
#: (n_nodes, n_origins), run_sim_script keywords, the check that applies)
PARITY_SCRIPTS = (
    ("single_writer", "random_single_writer", (PARITY_CELLS, PARITY_ROUNDS),
     dict(seed=3), dict(seed=3, quiet="off"), "bitwise"),
    ("single_writer_loss", "random_single_writer", (PARITY_CELLS, PARITY_ROUNDS),
     dict(seed=3), dict(seed=11, drop_prob=0.05), "bitwise"),
    ("transactions_tx4", "random_transactions", (PARITY_CELLS, PARITY_ROUNDS),
     dict(tx_cells=4, seed=3), dict(seed=3), "bitwise"),
    ("conflicting", "random_conflicting", (PARITY_CELLS, PARITY_ROUNDS),
     dict(seed=5, hot_cells=2), dict(seed=5), "agreement"),
    ("delete_resurrect", "random_delete_resurrect", (16, 4, PARITY_ROUNDS),
     dict(seed=9), dict(seed=9), "agreement"),
    ("full_mix", "random_full_mix", (PARITY_CELLS, PARITY_ROUNDS),
     dict(seed=9), dict(seed=9), "agreement"),
)


def _same_run(a, b) -> bool:
    """Two ``run_sim_script`` results (planes, alive, rounds-taken) equal."""
    import numpy as np

    return (a[2] == b[2] and np.array_equal(a[1], b[1])
            and all(np.array_equal(p, q) for p, q in zip(a[0], b[0], strict=True)))


def phase_parity(dev) -> dict:
    """BASELINE's state-parity check at N = ``PARITY_NODES``: each script
    through the pure-Python oracle cluster and through the port's
    ``run_sim_script`` on the card, which must converge, equal the oracle
    (bitwise for single writers, agreement and validity otherwise), equal
    the same script on the CPU route bitwise, and launch each kernel once
    a round on the kernel route (the swim kernel alone on the plain route
    of multi-cell transactions). The single writer's script with
    ``PARITY_QUIET_TAIL`` empty rounds appended gives the same result under
    ``quiet="on"`` as under ``"off"`` with some rounds quiet (no swim
    launch) and some dense."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim import parity

    n, o = PARITY_NODES, PARITY_ORIGINS
    out = {}
    for label, gen, args, gen_kw, kw, check in PARITY_SCRIPTS:
        script = getattr(parity.WorkloadScript, gen)(n, o, *args, **gen_kw)
        oc = parity.OracleCluster(n, o, script.n_cells, seed=1)
        t0 = time.perf_counter()
        o_taken = oc.run(script, settle_rounds=512)
        o_s = time.perf_counter() - t0
        mk.reset_launches()
        t0 = time.perf_counter()
        card = parity.run_sim_script(script, settle_rounds=512, device=dev, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = dict(mk.LAUNCHES)
        t0 = time.perf_counter()
        cpu = parity.run_sim_script(script, settle_rounds=512, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        planes, alive, taken = card
        if check == "bitwise":
            problems = parity.check_bitwise_parity(oc, planes, alive)
        else:
            problems = parity.check_agreement_validity(script, planes, alive)
        # the round steps run: the script, the final revive-all, the settle
        steps = taken + (1 if script.faults else 0)
        kernel = script.max_tx_cells == 1
        want = {"swim_tables": steps, "ingest": steps if kernel else 0,
                "ingest_emit": steps if kernel else 0}
        if (o_taken <= 0 or taken <= 0 or problems or not _same_run(card, cpu)
                or launches != want):
            raise AssertionError(
                f"parity {label}: oracle rounds {o_taken}, card rounds {taken}, "
                f"card == cpu {_same_run(card, cpu)}, problems {problems[:4]}, "
                f"launches {launches} != {want}")
        if gen == "random_full_mix" and not {"kill", "partition"} <= {
                e[0] for evs in script.faults for e in evs}:
            raise AssertionError(f"parity {label}: the script has no kill or partition")
        line = (f"[parity] N={n} {label} ({check}): oracle {o_taken} rounds in "
                f"{o_s:.2f} s; card {taken} rounds in {card_s:.2f} s, cpu "
                f"{cpu[2]} rounds in {cpu_s:.2f} s, card == cpu bitwise; "
                f"launches {launches}")
        if label == "single_writer":
            # the same writes, then empty rounds: the cluster settles inside
            # the script, so some rounds take the quiet branch
            tail = getattr(parity.WorkloadScript, gen)(n, o, *args, **gen_kw)
            tail.writes += [[] for _ in range(PARITY_QUIET_TAIL)]
            off = parity.run_sim_script(tail, settle_rounds=512, device=dev, **kw)
            mk.reset_launches()
            t0 = time.perf_counter()
            on = parity.run_sim_script(tail, settle_rounds=512, device=dev,
                                       **{**kw, "quiet": "on"})
            torch.cuda.synchronize()
            on_s = time.perf_counter() - t0
            dense = mk.LAUNCHES["swim_tables"]
            if off[2] <= 0 or not _same_run(on, off) or not 0 < dense < off[2]:
                raise AssertionError(
                    f"parity {label}: with {PARITY_QUIET_TAIL} empty rounds, "
                    f"quiet='on' != 'off' ({on[2]} vs {off[2]} rounds) or "
                    f"{dense} dense rounds of {off[2]}")
            line += (f"; with {PARITY_QUIET_TAIL} empty rounds appended, quiet='on' "
                     f"== 'off' in {on_s:.2f} s, {dense} of {off[2]} rounds dense")
        print(line, flush=True)
        out[label] = {"oracle_rounds": o_taken, "rounds": taken, "card_s": card_s,
                      "cpu_s": cpu_s, "oracle_s": o_s, "launches": launches}
    return out


def _soak_arm(run):
    """``run()`` with the peak-memory and launch counters reset before it;
    returns (its result, seconds, peak device bytes, launches per form)."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0, torch.cuda.max_memory_allocated(), dict(
        mk.FORM_LAUNCHES)


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _check_soak(label, arms: dict) -> None:
    """Every arm's final state and infos equal the straight arm's bitwise,
    its launches per form equal, and its peak device bytes within 5 %."""
    want_st, want_infos, want_forms, want_peak = arms["straight"]
    for name, (st, infos, forms, peak) in arms.items():
        err = _max_abs_err(_flat(want_st), _flat(st))
        ierr = _max_abs_err(_flat(want_infos), _flat({k: infos[k] for k in want_infos}))
        if err or ierr or forms != want_forms or abs(peak - want_peak) > 0.05 * want_peak:
            raise AssertionError(
                f"{label} {name}: state err {err}, info err {ierr}, launches "
                f"{forms} vs {want_forms}, peak {peak} vs {want_peak} bytes")


def phase_soak(dev) -> dict:
    """The flagship (``scale_sim_config(FLAGSHIP_NODES)``, bench.py's
    workload) for ``SOAK_ROUNDS`` rounds three ways: straight; segmented in
    segments of ``SOAK_SEGMENT`` with the async writer (keep_last 2); and
    the first half segmented, then resumed from disk. All three equal
    bitwise (every leaf and info), launch the same kernels, and peak
    within 5 % of the straight run. Prints rounds/s, checkpoint stall and
    writer seconds, one checkpoint's bytes, and save, verify and load
    seconds."""
    import os
    import tempfile

    import torch

    from corrosion_tpu_torch.checkpoint import load_checkpoint, save_checkpoint, verify_checkpoint
    from corrosion_tpu_torch.resilience import resume_segmented, run_segmented
    from corrosion_tpu_torch.resilience.segments import host_copy
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        scale_run_rounds_carry,
        scale_sim_config,
    )

    cfg = scale_sim_config(FLAGSHIP_NODES)
    rounds, seg, half = SOAK_ROUNDS, SOAK_SEGMENT, SOAK_ROUNDS // 2
    with tempfile.TemporaryDirectory(prefix="soak-") as tmp:
        roots = {k: os.path.join(tmp, k) for k in ("segmented", "resumed", "single")}

        # each arm builds its own workload and hands the state into the run
        # (``w.pop(0)``), so no frame here holds the initial carry
        def straight():
            w = list(flagship_workload(cfg, rounds, dev))
            net, key, inputs = w[1:]
            (st, _), infos = scale_run_rounds_carry(cfg, w.pop(0), net, key, inputs)
            return host_copy(st), {k: v.cpu() for k, v in infos.items()}

        def segmented():
            w = list(flagship_workload(cfg, rounds, dev))
            net, key, inputs = w[1:]
            res = run_segmented(cfg, w.pop(0), net, key, inputs, seg,
                                checkpoint_root=roots["segmented"], keep_last=2)
            return (host_copy(res.state), {k: v.cpu() for k, v in res.infos.items()},
                    res.stats, res.checkpoint)

        def resumed():
            w = list(flagship_workload(cfg, rounds, dev))
            net, key, inputs = w[1:]
            first = run_segmented(cfg, w.pop(0), net, key,
                                  ScaleRoundInput(*(a[:half] for a in inputs)), seg,
                                  checkpoint_root=roots["resumed"], keep_last=2)
            infos, stats = first.infos, first.stats
            del first  # a resuming process holds no carry of its own
            rest = resume_segmented(cfg, net, inputs, seg,
                                    checkpoint_root=roots["resumed"], keep_last=2)
            return (host_copy(rest.state),
                    {k: torch.cat([infos[k], rest.infos[k]]).cpu() for k in infos},
                    (stats, rest.stats), rest.completed_rounds)

        (st, infos), s_straight, p_straight, f_straight = _soak_arm(straight)
        (sst, sinfos, sstats, last), s_seg, p_seg, f_seg = _soak_arm(segmented)
        (rst, rinfos, rstats, done), s_res, p_res, f_res = _soak_arm(resumed)
        if done != rounds or sstats["segments"] != rounds // seg or sstats["ckpt_written"] != rounds // seg:
            raise AssertionError(f"soak: resumed to {done}, segmented stats {sstats}")
        _check_soak("soak", {"straight": (st, infos, f_straight, p_straight),
                             "segmented": (sst, sinfos, f_seg, p_seg),
                             "resumed": (rst, rinfos, f_res, p_res)})
        want_forms = {("swim_tables", "aligned/16/16"): rounds, ("ingest", "16/16"): rounds,
                      ("ingest_emit", "16/16"): rounds}
        if f_straight != want_forms:
            raise AssertionError(f"soak launches {f_straight} != {want_forms}")
        ckpt_bytes = _dir_bytes(last)
        kept = sorted(os.listdir(roots["segmented"]))
        if kept != ["LATEST", f"seg-{rounds - seg:08d}", f"seg-{rounds:08d}"]:
            raise AssertionError(f"soak retention kept {kept}")
        # one checkpoint of the straight run's final state, timed alone
        path = os.path.join(roots["single"], "one")
        t0 = time.perf_counter()
        save_checkpoint(cfg, st, rounds, path=path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        verify_checkpoint(path)
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, loaded = load_checkpoint(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if _max_abs_err(_flat(st), [t.cpu() for t in _flat(loaded)]):
            raise AssertionError("soak: the loaded checkpoint differs from the state saved")
        del loaded
    state_bytes = _nbytes(_flat(st))
    rates = {k: rounds / s for k, s in (("straight", s_straight), ("segmented", s_seg),
                                         ("resumed", s_res))}
    print(f"[soak] N={cfg.n_nodes} {rounds} rounds, segments of {seg}: straight, "
          f"segmented and resumed bitwise equal in every leaf and info; launches "
          f"{f_straight} in each; rounds/s {rates}; peak device bytes straight "
          f"{p_straight}, segmented {p_seg}, resumed {p_res}; segmented "
          f"ckpt_stall_s {sstats['ckpt_stall_s']!r} vs ckpt_io_s {sstats['ckpt_io_s']!r} "
          f"({sstats['ckpt_written']} written, {sstats['ckpt_overlapped_segments']} "
          f"overlapped); resumed arm stall/io {rstats[0]['ckpt_stall_s']!r}/"
          f"{rstats[0]['ckpt_io_s']!r} then {rstats[1]['ckpt_stall_s']!r}/"
          f"{rstats[1]['ckpt_io_s']!r}; state {state_bytes} bytes, one checkpoint "
          f"{ckpt_bytes} bytes on disk; save {save_s!r} s, verify {verify_s!r} s, "
          f"load {load_s!r} s", flush=True)
    return {"rates": rates, "peaks": (p_straight, p_seg, p_res), "stats": sstats,
            "ckpt_bytes": ckpt_bytes, "save_s": save_s, "verify_s": verify_s,
            "load_s": load_s}


def phase_full_soak(dev) -> None:
    """The full view at ``full_view_config(FULL_TRAJECTORY_NODES)`` for 16
    rounds: the first segment of 8 checkpointed, then resumed from disk,
    equal to the straight ``run_rounds_carry`` bitwise, with the ingest
    kernel launched at m = 96 once a round in both."""
    import os
    import tempfile

    import torch

    from corrosion_tpu_torch.resilience import resume_segmented, run_segmented
    from corrosion_tpu_torch.resilience.segments import host_copy
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scenario import full_view_workload
    from corrosion_tpu_torch.sim.step import RoundInput, run_rounds_carry

    cfg = full_view_config(FULL_TRAJECTORY_NODES)
    rounds, seg = 16, 8

    def straight():
        w = list(full_view_workload(cfg, rounds, dev))
        net, key, inputs = w[1:]
        (st, _), infos = run_rounds_carry(cfg, w.pop(0), net, key, inputs)
        return host_copy(st), {k: v.cpu() for k, v in infos.items()}

    with tempfile.TemporaryDirectory(prefix="full-soak-") as tmp:
        root = os.path.join(tmp, "soak")

        def resumed():
            w = list(full_view_workload(cfg, rounds, dev))
            net, key, inputs = w[1:]
            first = run_segmented(cfg, w.pop(0), net, key,
                                  RoundInput(*(a[:seg] for a in inputs)), seg,
                                  checkpoint_root=root)
            infos = first.infos
            del first
            rest = resume_segmented(cfg, net, inputs, seg, checkpoint_root=root)
            return (host_copy(rest.state),
                    {k: torch.cat([infos[k], rest.infos[k]]).cpu() for k in infos})

        (st, infos), s_straight, p_straight, f_straight = _soak_arm(straight)
        (rst, rinfos), s_res, p_res, f_res = _soak_arm(resumed)
    _check_soak("full-soak", {"straight": (st, infos, f_straight, p_straight),
                              "resumed": (rst, rinfos, f_res, p_res)})
    want = {("ingest", "32/32"): rounds, ("ingest", f"32/32/m{cfg.recv_slots}"): rounds}
    if f_straight != want:
        raise AssertionError(f"full-soak launches {f_straight} != {want}")
    print(f"[full-soak] N={cfg.n_nodes} {rounds} rounds: segment of {seg} resumed from "
          f"disk == straight, bitwise in every leaf and info; launches {f_res}; "
          f"{s_straight:.2f} s straight, {s_res:.2f} s segmented and resumed; peak "
          f"{p_straight} / {p_res} bytes", flush=True)


_PTX_TYPES = {"a": "int8", "s": "int16", "i": "int32"}


def _ptxas_functions(log: str) -> dict:
    """ptxas' report (``-Xptxas -v``) per kernel: {mangled name: (stack
    frame, spill stores, spill loads, its register line)}."""
    import re

    out, name, frame = {}, None, None
    for line in log.splitlines():
        got = re.search(r"Function properties for (\S+)", line)
        if got:
            name, frame = got.group(1), None
            continue
        got = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", line)
        if got and name:
            frame = tuple(int(x) for x in got.groups())
            continue
        if "Used" in line and "registers" in line and name and frame:
            out[name] = (*frame, line.split(":", 1)[-1].strip())
            name = None
    return out


def _check_swim_ptxas(log: str) -> None:
    """Print ptxas' report for every swim kernel instantiation (the six
    timer/budget x form pairs, each at 1, 2 and 4 columns a lane) by name;
    each must have no stack frame and no spills."""
    import re

    seen, bad = set(), []
    for mangled, (frame, st, ld, regs) in sorted(_ptxas_functions(log).items()):
        got = re.search(r"swim_tables_kernelI([asi])([asi])Lb([01])ELi(\d+)E", mangled)
        if not got:
            continue
        tt, xt, packed, spl = got.groups()
        form = (_PTX_TYPES[tt], _PTX_TYPES[xt], "packed" if packed == "1" else "aligned")
        name = f"swim_tables_kernel<{', '.join(form)}, SPL={spl}>"
        print(f"[ptxas] {name}: {frame} bytes stack frame, {st} bytes spill stores, "
              f"{ld} bytes spill loads; {regs}", flush=True)
        if frame or st or ld:
            bad.append(name)
        seen.add((form, spl))
    want = {((t, x, f), spl) for t, x in (("int16", "int8"), ("int16", "int16"),
                                           ("int32", "int32"))
            for f in ("aligned", "packed") for spl in ("1", "2", "4")}
    if bad:
        raise AssertionError(f"stack frame or spills in ptxas' report: {bad}")
    if seen != want:
        raise AssertionError(f"swim ptxas report lacks {sorted(want - seen)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from corrosion_tpu_torch.ops import cuda_lib
    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_lib.build_all()
    print(f"[build] {len(cuda_lib.SOURCES)} kernels built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in cuda_lib.build_log("ingest").splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            print(f"[ptxas] ingest: {line.strip()}", flush=True)
    _check_swim_ptxas(cuda_lib.build_log("swim_tables"))

    t_phase = time.perf_counter()

    def done(name):
        nonlocal t_phase
        print(f"[time] {name}: {time.perf_counter() - t_phase:.1f} s", flush=True)
        t_phase = time.perf_counter()

    kern = phase_kernels(dev)
    done("kernels")
    phase_trajectory(dev, "flagship", scale_sim_config)
    phase_trajectory(dev, "1M point's tiers", million_config)
    done("trajectory")
    flag = phase_flagship(dev)
    done("flagship")
    million = phase_million(dev)
    done("million")
    phase_quiet(dev)
    done("quiet")
    phase_full_trajectory(dev)
    done("full-trajectory")
    full = phase_full(dev)
    done("full")
    tx_paths = phase_tx_trajectory(dev)
    done("tx-trajectory")
    phase_full_tx_trajectory(dev)
    done("full-tx-trajectory")
    phase_scale_point(dev, "tx", tx_max_cells=4)
    done("tx")
    phase_scale_point(dev, "wirebudget", bcast_wire_budget=True)
    done("wirebudget")
    phase_full_tx(dev)
    done("full-tx")
    phase_parity(dev)
    done("parity")
    phase_soak(dev)
    done("soak")
    phase_full_soak(dev)
    done("full-soak")

    # each form's launches are read from the path that runs it (0: no path
    # here runs the form)
    paths = {"flagship": flag, "million": million, "full": full, "pig0": tx_paths["pig0"]}
    source = {
        "swim_tables": "corrosion_tpu_torch/csrc/swim_tables.cu",
        "ingest": "corrosion_tpu_torch/csrc/ingest.cu",
        "ingest_emit": "corrosion_tpu_torch/csrc/ingest.cu",
    }
    record = {"kernels": [
        {
            "name": name, "route": "cuda", "source": source[r["kernel"]],
            "replaces": r["replaces"],
            "launches": (paths[r["path"]]["forms"].get(r["launch_key"], 0)
                         if r["path"] else 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        }
        for name, r in kern.items()
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
