#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's scale round on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build every kernel of the round from ``corrosion_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) and print ptxas' register report.
2. Hold each kernel against its plain PyTorch version on the card, at the
   flagship shapes (N = 100,000) on random valid inputs drawn from the
   port's PRNG: every output must be bitwise equal (tolerance 0). Time the
   kernel and the plain version with CUDA events. Then hold, untimed, the
   forms the flagship does not run but a caller can reach on the card: the
   wide planes (``narrow_dtypes=False``: int32 timer, budget and queue
   planes) for all three kernels, and the non-emitting local write
   (``broadcast.local_write``) at both plane dtypes.
3. Run 16 rounds of ``scale_sim_config(4096, sync_interval=2,
   sync_sweep_every=2)`` with writes, churn and 5 % message loss once on
   the card (kernels) and once on the CPU (plain versions); every state leaf
   and round-info value must be bitwise equal after every round. (The CPU
   route is held bitwise to the JAX package by ``tests/test_torch_*.py``.)
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

Phase 2 also holds the 1M point's kernel forms at N = 1,000,000: the
packed-entry swim kernel with int8 budgets and the ingest kernel with int8
q_tx (timed), and, untimed, the packed form at int16 and int32 budgets and
the aligned form with int8 budgets. Phase 3 also runs the 1M point's
configuration at 4096 nodes.

Each kernel's bound is the larger of the bytes it must move on these inputs
over the memory rate and its integer operations over the int32 rate.

The last lines are the card's name and power limit, the per-kernel JSON
record, and ``{"ok": true, "device": {...}}``. The script needs one CUDA
device and exits non-zero without printing a result when there is none.
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


def _swim_ops(n: int, m: int, pig_k: int = 0) -> int:
    """Integer operations of the swim kernel, counted from its loops: four
    channel merges of ~10 per slot (packed: ~14 per entry), ~30 per slot
    for timers, budget and stores, ~60 per row. An upper count: skipped
    channels count too."""
    merges = 4 * 14 * pig_k if pig_k else 4 * 10 * m
    return n * (merges + 30 * m + 60)


def _ingest_ops(n: int, m: int, o: int, w: int, c: int, q: int, r: int) -> int:
    """Integer operations of the ingest kernel, counted from its loops (an
    upper count: every message is taken as live and fresh)."""
    per_row = (
        12 * m + 20 * m + 2 * m * (m - 1)  # HLC fold, seen check, dedupe
        + o * (12 * m + 12) + 12 * m + o * (14 * w + 6)  # claim, record, head
        + 5 * c + m * (12 * m + 15)  # LWW apply
        + 10 * q + m * (3 * q + 12)  # enqueue
        + (4 * q + 3 * q * q + r * (3 * q + 15) if r else 0)  # payload
    )
    return n * per_row


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
                 pig_k: int = 0):
    """Random valid operands of the swim kernel (the order of
    ``swim_tables_update``'s arguments after ``consts``), with the timer
    plane at ``plane_dtype`` and the budget plane at ``tx_dtype`` (default
    the same). With ``pig_k > 0`` the channels are packed [n, pig_k] entry
    lists, whose entries often share a hash class within one packet."""
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
    return (
        mem_id, mem_view, old_id, old_view,
        ri((n, m), 0, 12).to(plane_dtype), ri((n, m), 0, 14).to(tx_dtype or plane_dtype),
        coin((n,), 0.9), ri((n,), 0, 8), iarr, self_slot,
        ri((n,), -1, 40), ri((n,), 0, 4), ri((n,), 0, m), ri((n,), 0, 40),
        coin((n,), 0.3), *chans,
    )


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
# no drift reject). "receive" is the piggyback batch, "write" the local write
# of ``broadcast.local_write``, "write_emit" the round's local write.
INGEST_FORMS = {
    "receive": (lambda cfg: 4 * cfg.pig_changes, False, False, False),
    "write": (lambda cfg: 1, False, True, True),
    "write_emit": (lambda cfg: 1, True, True, True),
}


def _ingest_inputs(cfg, n: int, form: str, seed: int, dev):
    """Random valid operands of the ingest kernel in ``form`` at ``cfg``'s
    widths and queue-plane dtypes."""
    import torch

    from corrosion_tpu_torch import random as prng
    from corrosion_tpu_torch.ops.megakernel import IngestInputs, IngestParams
    from corrosion_tpu_torch.sim.broadcast import (
        CHANGE_WIRE_BYTES,
        HLC_MAX_DRIFT_ROUNDS,
        HLC_ROUND_BITS,
    )

    msgs, emit, enqueue_all, no_drift = INGEST_FORMS[form]
    m = msgs(cfg)
    ks = iter(prng.split(prng.key(seed), 64))

    def ri(shape, lo, hi):
        return prng.randint(next(ks), shape, lo, hi, dev)

    def coin(shape, p):
        return prng.uniform(next(ks), shape, dev) < p

    o, c, q = cfg.n_origins, cfg.n_cells, cfg.bcast_queue
    cdt, qdt = cfg.timer_dtype, cfg.q_dtype
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
        live=coin((n, m), 0.7), origin=ri((n, m), -1, 64), dbv=ri((n, m), 0, 40),
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
    return p, x


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
             plain_ms=_cuda_ms(plain, 3), bytes=nbytes(got), ops=ops)
    del got, want
    r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["ops"])
    print(f"[kernels] {name}: max_abs_err={r['max_abs_err']} "
          f"kernel {r['ms']!r} ms, plain {r['plain_ms']!r} ms, "
          f"{r['bytes']} bytes, {r['ops']} int32 ops, bound "
          f"{r['bound_ms']!r} ms by {r['bound_by']}", flush=True)
    return r


def _swim_form(name, cfg, seed, dev, timed=True, **kw) -> dict:
    """One swim kernel form at ``cfg``'s shapes: timed, or only held."""
    from corrosion_tpu_torch.ops import megakernel as mk

    n, m, k = cfg.n_nodes, cfg.m_slots, kw.get("pig_k", 0)
    consts = (m, cfg.suspicion_rounds, cfg.down_purge_rounds,
              cfg.max_transmissions, k)
    args = _swim_inputs(n, m, cfg.timer_dtype, seed, dev, **kw)

    def run():
        return mk.swim_tables_fused(consts, *args)

    def plain():
        return mk.swim_tables_plain(consts, *args)

    if not timed:
        return _hold(name, run(), plain())
    return _time_form(name, "swim_tables", run, plain,
                      lambda got: _swim_bytes(args, got, k), _swim_ops(n, m, k))


def _ingest_form(name, cfg, form, seed, dev, timed=True):
    """One ingest kernel form at ``cfg``'s shapes: timed, or only held."""
    from corrosion_tpu_torch.ops import megakernel as mk

    p, x = _ingest_inputs(cfg, cfg.n_nodes, form, seed, dev)
    if not timed:
        return _hold(name, mk.ingest(p, x), mk.ingest_plain(p, x))
    return _time_form(
        name, "ingest_emit" if p.pig_r else "ingest",
        lambda: mk.ingest(p, x), lambda: mk.ingest_plain(p, x),
        lambda got: _ingest_bytes(x, got),
        _ingest_ops(cfg.n_nodes, x.origin.shape[1], p.n_origins, p.seen_words,
                    p.n_cells, p.q_slots, p.pig_r))


def phase_kernels(dev) -> dict:
    """Each kernel form against its plain version at the shapes of the path
    that runs it (the result's "path"), timed; then the forms no path here
    runs, untimed."""
    import torch

    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    flag = scale_sim_config(FLAGSHIP_NODES)
    big = million_config(MILLION_NODES)
    k = big.pig_members
    out = {
        "swim_tables": _swim_form("swim_tables", flag, 11, dev),
        "ingest": _ingest_form("ingest", flag, "receive", 27, dev),
        "ingest_emit": _ingest_form("ingest_emit", flag, "write_emit", 32, dev),
        "swim_tables_packed_i8": _swim_form(
            "swim_tables_packed_i8", big, 13, dev, tx_dtype=torch.int8, pig_k=k),
        "ingest_q_i8": _ingest_form("ingest_q_i8", big, "receive", 41, dev),
        "ingest_emit_q_i8": _ingest_form("ingest_emit_q_i8", big, "write_emit", 42, dev),
    }
    for name, r in out.items():
        r["path"] = "million" if name.endswith("_i8") else "flagship"

    wide = scale_sim_config(FLAGSHIP_NODES, narrow_dtypes=False)
    _swim_form("swim_tables wide", wide, 12, dev, timed=False)
    checked = [f"swim_tables aligned int32/int32 N={FLAGSHIP_NODES}"]
    for c, forms in ((wide, ("receive", "write", "write_emit")), (flag, ("write",)),
                     (big, ("write",))):
        for form in forms:
            label = (f"ingest {form} {str(c.timer_dtype)[6:]}/{str(c.q_dtype)[6:]} "
                     f"N={c.n_nodes}")
            _ingest_form(label, c, form, 31 + len(form), dev, timed=False)
            checked.append(label)
    for narrow, kw in ((True, dict(tx_dtype=torch.int16, pig_k=k)),
                       (False, dict(pig_k=k)), (True, dict(tx_dtype=torch.int8))):
        c = scale_sim_config(MILLION_NODES, narrow_dtypes=narrow)
        label = (f"swim_tables {'packed' if kw.get('pig_k') else 'aligned'} "
                 f"{str(c.timer_dtype)[6:]}/{str(kw.get('tx_dtype', c.timer_dtype))[6:]} "
                 f"N={MILLION_NODES}")
        _swim_form(label, c, 14 + len(checked), dev, timed=False, **kw)
        checked.append(label)
    print(f"[kernels] forms no path here runs, bitwise equal to plain: "
          f"{', '.join(checked)}", flush=True)
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


def phase_trajectory(dev, label, make_cfg) -> None:
    """The kernel route on the card == the plain route on the CPU, for
    ``make_cfg(TRAJECTORY_NODES, ...)``."""
    from corrosion_tpu_torch.sim.scale_step import ScaleRoundInput, scale_run_rounds_carry

    cfg = make_cfg(TRAJECTORY_NODES, sync_interval=2, sync_sweep_every=2)
    rounds = 16
    runs = {d: _trajectory_setup(cfg, rounds, d) for d in ("cpu", dev)}
    carry = {d: (runs[d][0], runs[d][2]) for d in runs}
    t0 = time.perf_counter()
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
            raise AssertionError(f"round {r}: cuda != cpu (state {err}, info {ierr})")
    print(f"[trajectory] N={cfg.n_nodes} {label}: {rounds} rounds, "
          f"every leaf and info bitwise equal cuda vs cpu "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


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
    return {"rounds_per_s": median, "peak_bytes": peak, "launches": launches}


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
    st, net, key, inputs = flagship_workload(cfg, total, dev)
    state_bytes = _nbytes(_flat(st))

    def part(lo, hi):
        return ScaleRoundInput(*(a[lo:hi] for a in inputs))

    mk.reset_launches()
    (st, key), warm_infos = scale_run_rounds_carry(cfg, st, net, key, part(0, warm))
    torch.cuda.synchronize()
    rates, batch_infos = [], [warm_infos]
    for lo in range(warm, total, batch):
        t0 = time.perf_counter()
        (st, key), infos = scale_run_rounds_carry(cfg, st, net, key, part(lo, lo + batch))
        torch.cuda.synchronize()
        rates.append(batch / (time.perf_counter() - t0))
        batch_infos.append(infos)
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
    return {"rounds_per_s": median, "peak_bytes": peak, "launches": launches}


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
    for name in cuda_lib.SOURCES:
        for line in cuda_lib.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

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

    # each form's launches are read from the path that runs it
    paths = {"flagship": flag, "million": million}
    replaces = {
        "swim_tables": "corrosion_tpu/ops/megakernel.py:1063",
        "ingest": "corrosion_tpu/ops/megakernel.py:795",
        "ingest_emit": "corrosion_tpu/ops/megakernel.py:960",
    }
    source = {
        "swim_tables": "corrosion_tpu_torch/csrc/swim_tables.cu",
        "ingest": "corrosion_tpu_torch/csrc/ingest.cu",
        "ingest_emit": "corrosion_tpu_torch/csrc/ingest.cu",
    }
    record = {"kernels": [
        {
            "name": name, "route": "cuda", "source": source[r["kernel"]],
            "replaces": replaces[r["kernel"]],
            "launches": paths[r["path"]]["launches"][r["kernel"]],
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
