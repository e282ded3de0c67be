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
TRAJECTORY_NODES = 4096  # small enough for the CPU route to keep pace


def _swim_ops(n: int, m: int) -> int:
    """Integer operations of the swim kernel, counted from its loops: four
    channel merges of ~10 per slot, ~30 per slot for timers, budget and
    stores, ~60 per row. An upper count: skipped channels count too."""
    return n * (70 * m + 60)


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


def _swim_inputs(n: int, m: int, plane_dtype, seed: int, dev):
    """Random valid operands of the swim kernel (the order of
    ``swim_tables_update``'s arguments after ``consts``), with the timer and
    budget planes at ``plane_dtype``."""
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
        chans[0].append(torch.where(coin((n, m), 0.5), mem_id, ri((n, m), -1, n)))
        chans[1].append(ri((n, m), -1, 64))
        chans[2].append(coin((n, m), 0.7))
        chans[3].append(coin((n,), 0.8))
        chans[4].append(ri((n,), 0, n))
        chans[5].append(ri((n,), 0, 8))
    return (
        mem_id, mem_view, old_id, old_view,
        ri((n, m), 0, 12).to(plane_dtype), ri((n, m), 0, 14).to(plane_dtype),
        coin((n,), 0.9), ri((n,), 0, 8), iarr, self_slot,
        ri((n,), -1, 40), ri((n,), 0, 4), ri((n,), 0, m), ri((n,), 0, 40),
        coin((n,), 0.3), *chans,
    )


def _swim_bytes(args, out) -> int:
    """Bytes the swim kernel must move on these operands: every plane once,
    except what it skips by the data. A failed probe's slot and key are
    read only where the probe failed. A channel is read only on the rows
    where it is valid (its sender and sender incarnation too); there its
    view only where the id is live and sendable, its send flag only where
    the id is live. Every output is written once."""
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
                         + m * ch_id[ch].element_size())
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
    widths and queue-plane dtype."""
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

    o, c, q, qdt = cfg.n_origins, cfg.n_cells, cfg.bcast_queue, cfg.q_dtype
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
        q_dbv=ri((n, q), 0, 40), q_cell=ri((n, q), 0, c).to(qdt),
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


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the flagship shapes, timed;
    then the forms the flagship does not run, untimed."""
    import torch

    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import scale_sim_config

    cfg = scale_sim_config(FLAGSHIP_NODES)
    n, m = cfg.n_nodes, cfg.m_slots
    consts = (m, cfg.suspicion_rounds, cfg.down_purge_rounds,
              cfg.max_transmissions, 0)
    out = {}

    args = _swim_inputs(n, m, cfg.timer_dtype, 11, dev)
    got = mk.swim_tables_fused(consts, *args)
    want = mk.swim_tables_plain(consts, *args)
    torch.cuda.synchronize()
    out["swim_tables"] = dict(
        max_abs_err=_hold("swim_tables", got, want),
        ms=_cuda_ms(lambda: mk.swim_tables_fused(consts, *args), 20),
        plain_ms=_cuda_ms(lambda: mk.swim_tables_plain(consts, *args), 3),
        bytes=_swim_bytes(args, got),
        ops=_swim_ops(n, m),
    )
    for name, form in (("ingest", "receive"), ("ingest_emit", "write_emit")):
        p, x = _ingest_inputs(cfg, n, form, 21 + len(name), dev)
        got = mk.ingest(p, x)
        want = mk.ingest_plain(p, x)
        torch.cuda.synchronize()
        out[name] = dict(
            max_abs_err=_hold(name, got, want),
            ms=_cuda_ms(lambda: mk.ingest(p, x), 20),
            plain_ms=_cuda_ms(lambda: mk.ingest_plain(p, x), 3),
            bytes=_ingest_bytes(x, got),
            ops=_ingest_ops(n, x.origin.shape[1], p.n_origins, p.seen_words,
                            p.n_cells, p.q_slots, p.pig_r),
        )
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["ops"])
        print(f"[kernels] {name}: max_abs_err={r['max_abs_err']} "
              f"kernel {r['ms']!r} ms, plain {r['plain_ms']!r} ms, "
              f"{r['bytes']} bytes, {r['ops']} int32 ops, bound "
              f"{r['bound_ms']!r} ms by {r['bound_by']}", flush=True)

    wide = scale_sim_config(FLAGSHIP_NODES, narrow_dtypes=False)
    args = _swim_inputs(n, m, wide.timer_dtype, 12, dev)
    _hold("swim_tables wide", mk.swim_tables_fused(consts, *args),
          mk.swim_tables_plain(consts, *args))
    checked = ["swim_tables int32"]
    for c, forms in ((wide, ("receive", "write", "write_emit")), (cfg, ("write",))):
        for form in forms:
            p, x = _ingest_inputs(c, n, form, 31 + len(form), dev)
            label = f"ingest {form} {str(c.q_dtype).split('.')[-1]}"
            _hold(label, mk.ingest(p, x), mk.ingest_plain(p, x))
            checked.append(label)
    print(f"[kernels] forms off the flagship path, bitwise equal to plain at "
          f"N={n}: {', '.join(checked)}", flush=True)
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


def phase_trajectory(dev) -> None:
    """The kernel route on the card == the plain route on the CPU."""
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        scale_run_rounds_carry,
        scale_sim_config,
    )

    cfg = scale_sim_config(TRAJECTORY_NODES, sync_interval=2, sync_sweep_every=2)
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
    print(f"[trajectory] N={cfg.n_nodes}: {rounds} rounds, every leaf and info "
          f"bitwise equal cuda vs cpu ({time.perf_counter() - t0:.1f} s)", flush=True)


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
    launches = dict(mk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"swim_tables": rounds, "ingest": rounds, "ingest_emit": rounds}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from corrosion_tpu_torch.ops import cuda_lib

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

    kern = phase_kernels(dev)
    phase_trajectory(dev)
    flag = phase_flagship(dev)

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
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name],
            "launches": flag["launches"][name],
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
