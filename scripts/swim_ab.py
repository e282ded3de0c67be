"""The swim kernel built from two sources, timed in turns in one process on
one card: the checkout's ``csrc/swim_tables.cu`` (A) and a baseline copy of
it (B, for example a parent commit's, written out with ``git show``).

    python3 scripts/swim_ab.py BASELINE.cu [--reps 3]

It reads ``chip_smoke.py``'s input builder from the repository root. First
it prints whether ptxas' report (stack frame, spills, registers, shared
memory) of every instantiation both builds hold is identical. Then, for the
register forms that the flagship (aligned, m = 64, N = 100,000) and the 1M
point (packed, k = 16, int16/int8, N = 1,000,000) run, on
``chip_smoke.py``'s kernels-phase inputs, it holds both builds bitwise to
the plain version, times each through the wrapper with CUDA events over 20
calls, ``--reps`` times in ABBA order, and prints the card's name and power
limit, each time, and the medians. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path


def _build_baseline(src: Path) -> tuple[ctypes.CDLL, str]:
    """The baseline's library and nvcc's output for it."""
    from corrosion_tpu_torch.ops import cuda_lib

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = cuda_lib.BUILD_DIR / f"swim_tables-baseline-{digest}.so"
    if not out.exists() or not out.with_suffix(".log").exists():
        cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    if not hasattr(lib, "swim_tables_register_slots"):
        # a source from before the wide form holds at most 128 slots, the
        # width the wrapper's form label reads past
        lib.swim_tables_register_slots = lambda: 128
    return lib, out.with_suffix(".log").read_text()


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("baseline", type=Path)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("swim_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from corrosion_tpu_torch.ops import cuda_lib
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    baseline, baseline_log = _build_baseline(args.baseline)
    libs = {"A": cuda_lib.library("swim_tables"), "B": baseline}
    a, b = cs._ptxas_functions(cuda_lib.build_log("swim_tables")), cs._ptxas_functions(baseline_log)
    both = sorted(set(a) & set(b))
    differ = [k for k in both if a[k] != b[k]]
    print(f"[swim_ab] ptxas: {len(both)} instantiations in both builds ({len(a)} in A, "
          f"{len(b)} in B), {len(differ)} with another report", flush=True)
    for k in differ:
        print(f"[swim_ab]   {k}: A {a[k]}, B {b[k]}", flush=True)
    big = million_config(1_000_000)
    for name, cfg, kw, seed in (("swim_tables", scale_sim_config(100_000), {}, 11),
                                ("swim_tables_packed_i8", big,
                                 dict(tx_dtype=torch.int8, pig_k=big.pig_members), 13)):
        k = kw.get("pig_k", 0)
        consts = (cfg.m_slots, cfg.suspicion_rounds, cfg.down_purge_rounds,
                  cfg.max_transmissions, k)
        ops = cs._swim_inputs(cfg.n_nodes, cfg.m_slots, cfg.timer_dtype, seed, dev, **kw)
        want = mk.swim_tables_plain(consts, *ops)
        times = {"A": [], "B": []}
        for which in "AB":
            cuda_lib._loaded["swim_tables"] = libs[which]
            cs._hold(f"{name} ({which})", mk.swim_tables_fused(consts, *ops), want)
        for _ in range(args.reps):
            for which in "ABBA":
                cuda_lib._loaded["swim_tables"] = libs[which]
                times[which].append(cs._cuda_ms(lambda: mk.swim_tables_fused(consts, *ops), 20))
        cuda_lib._loaded["swim_tables"] = libs["A"]
        med = {w: sorted(v)[len(v) // 2] for w, v in times.items()}
        print(f"[swim_ab] {name} at N={cfg.n_nodes}: both bitwise equal to the plain "
              f"version; A (checkout) {times['A']} ms, B (baseline) {times['B']} ms; "
              f"medians A {med['A']!r}, B {med['B']!r}, A/B {med['A'] / med['B']!r}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
