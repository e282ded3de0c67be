"""Where the flagship round's time goes on the card: ``torch.profiler`` over
a few rounds of ``scale_sim_config(100_000)`` with bench.py's workload
(``sim.scale_step.flagship_workload``, the one ``chip_smoke.py`` times), or
with ``--million`` of the 1M point (``sim.scale_step.million_config``), or
with ``--full`` of the full view at ``sim.config.full_view_config()``
(N = 8192) with its workload (``sim.scenario.full_view_workload``).

    python3 -m corrosion_tpu_torch.round_profile [--million | --full] [--out DIR]

Prints the card's name and power limit, the round's wall time with and
without the profiler, the device's busy share (kernel time over wall
time), kernel launches and host-side aten calls per round, the device time
of the int64 elementwise kernels (the threefry PRNG's draws), and the kernels
that take the most device time; writes that table and a Chrome trace under
``--out`` (default ``chiprun_out/``). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

N_NODES = 100_000
WARM_ROUNDS = 2
ROUNDS = 4  # timed without the profiler, then again under it


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from corrosion_tpu_torch.ops import cuda_lib
    from corrosion_tpu_torch.sim import step
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scenario import full_view_workload
    from corrosion_tpu_torch.sim.scale_step import (
        ScaleRoundInput,
        flagship_workload,
        million_config,
        scale_run_rounds_carry,
        scale_sim_config,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--million", action="store_true",
                       help="profile the 1M point instead of the 100k flagship")
    which.add_argument("--full", action="store_true",
                       help="profile the full view at N=8192 instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("round_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cuda_lib.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    warm, r = WARM_ROUNDS, ROUNDS
    total = warm + 2 * r
    if args.full:
        cfg = full_view_config()
        st, net, key, inputs = full_view_workload(cfg, total, dev)
        run, round_input = step.run_rounds_carry, step.RoundInput
    else:
        cfg = million_config() if args.million else scale_sim_config(N_NODES)
        st, net, key, inputs = flagship_workload(cfg, total, dev)
        run, round_input = scale_run_rounds_carry, ScaleRoundInput

    def part(lo, hi):
        return round_input(*(a[lo:hi] for a in inputs))

    def timed(carry, lo, hi):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = run(cfg, carry[0], net, carry[1], part(lo, hi))
        torch.cuda.synchronize()
        return carry, (time.perf_counter() - t0) / (hi - lo)

    carry, _ = timed((st, key), 0, warm)
    carry, plain_s = timed(carry, warm, warm + r)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        carry, prof_s = timed(carry, warm + r, total)

    # device-side rows only: an aten op's row also carries its kernels' time
    ka = prof.key_averages()
    kernels = sorted((e for e in ka if e.device_type == DeviceType.CUDA and _device_us(e) > 0),
                     key=lambda e: -_device_us(e))
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    aten = sum(1 for e in prof.events() if e.cpu_parent is None and e.name.startswith("aten::"))
    int64_us = sum(_device_us(e) for e in kernels
                   if "elementwise_kernel" in e.key and re.search(r"Functor\w*<long", e.key))
    lines = [
        smi,
        f"N={cfg.n_nodes} rounds={r}: {plain_s * 1e3:.3f} ms/round unprofiled, "
        f"{prof_s * 1e3:.3f} ms/round profiled",
        f"device busy {busy_us / r / 1e3:.3f} ms/round = "
        f"{busy_us / 1e6 / (plain_s * r):.3f} of unprofiled wall, "
        f"{busy_us / 1e6 / (prof_s * r):.3f} of profiled wall; "
        f"{launches / r:.1f} device kernels and copies/round; "
        f"{aten / r:.1f} top-level aten calls/round",
        f"int64 elementwise kernels (the threefry draws and int64 index math) "
        f"{int64_us / r / 1e3:.3f} ms/round = {int64_us / max(busy_us, 1e-9):.3f} "
        f"of device busy time",
        "top kernels by device time (ms/round, launches/round):",
    ]
    for e in kernels[:25]:
        lines.append(f"  {_device_us(e) / r / 1e3:9.4f} ms {e.count / r:8.1f}  {e.key[:110]}")
    text = "\n".join(lines)
    print(text)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = ("round_profile_1m" if args.million
            else "round_profile_full" if args.full else "round_profile")
    (out / f"{stem}.txt").write_text(text + "\n")
    prof.export_chrome_trace(str(out / f"{stem}_trace.json"))
    print(json.dumps({"ms_per_round": plain_s * 1e3, "busy_ms_per_round": busy_us / r / 1e3,
                      "device_ops_per_round": launches / r,
                      "aten_calls_per_round": aten / r, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
