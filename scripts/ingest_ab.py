"""The ingest kernel built from two sources, timed in turns in one process on
one card: the checkout's ``csrc/ingest.cu`` (A) and a baseline copy of it
(B, for example a parent commit's, written out with ``git show``).

    python3 scripts/ingest_ab.py BASELINE.cu [--reps 3]

It reads ``chip_smoke.py``'s input builder from the repository root. For
the ingest forms that the flagship, the 1M point and the full view run,
on ``chip_smoke.py``'s kernels-phase inputs, it holds both builds bitwise to
the plain version, then times each through the wrapper with CUDA events
over 20 calls, ``--reps`` times in ABBA order, and prints the card's name
and power limit, each time, and the medians. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path


def _build_baseline(src: Path) -> ctypes.CDLL:
    from corrosion_tpu_torch.ops import cuda_lib

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = cuda_lib.BUILD_DIR / f"ingest-baseline-{digest}.so"
    if not out.exists():
        cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out))


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("baseline", type=Path)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ingest_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from corrosion_tpu_torch.ops import cuda_lib
    from corrosion_tpu_torch.ops import megakernel as mk
    from corrosion_tpu_torch.sim.config import full_view_config
    from corrosion_tpu_torch.sim.scale_step import million_config, scale_sim_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    libs = {"A": cuda_lib.library("ingest"), "B": _build_baseline(args.baseline)}
    flag, big, full = (scale_sim_config(100_000), million_config(1_000_000),
                       full_view_config(8192))
    forms = (("ingest", flag, "receive", 27), ("ingest_emit", flag, "write_emit", 32),
             ("ingest_q_i8", big, "receive", 41), ("ingest_emit_q_i8", big, "write_emit", 42),
             ("ingest_full", full, "receive_full", 51),
             ("ingest_write_full", full, "write", 52))
    for name, cfg, form, seed in forms:
        p, x = cs._ingest_inputs(cfg, cfg.n_nodes, form, seed, dev)
        want = mk.ingest_plain(p, x)
        times = {"A": [], "B": []}
        for which in "AB":
            cuda_lib._loaded["ingest"] = libs[which]
            cs._hold(f"{name} ({which})", mk.ingest(p, x), want)
        for _ in range(args.reps):
            for which in "ABBA":
                cuda_lib._loaded["ingest"] = libs[which]
                times[which].append(cs._cuda_ms(lambda: mk.ingest(p, x), 20))
        cuda_lib._loaded["ingest"] = libs["A"]
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        print(f"[ingest_ab] {name} at N={cfg.n_nodes}: both bitwise equal to the plain "
              f"version; A (checkout) {times['A']} ms, B (baseline) {times['B']} ms; "
              f"medians A {med['A']!r}, B {med['B']!r}, A/B {med['A'] / med['B']!r}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
