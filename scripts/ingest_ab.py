"""The ingest kernel built from two sources, timed in turns in one process on
one card: the checkout's ``csrc/ingest.cu`` (A) and a baseline copy of it
(B, for example a parent commit's, written out with ``git show``).

    python3 scripts/ingest_ab.py BASELINE.cu [--reps 3]

It reads ``chip_smoke.py``'s input builder from the repository root. For
the ingest forms that the flagship, the 1M point and the full view run,
where the baseline takes rows past 256 cells (it exports
``ingest_staged_cells``) the large table's receive and emitting write at
4,096 cells a row and N = 100,000, and where it takes more than 64 queue
slots (it exports ``ingest_shallow_limits``) the deep queue's receive and
emitting write at N = 100,000, where it takes more than 128 messages
(it exports ``ingest_long_limits``) the wide packet's receive and emitting
write at N = 100,000, and where it takes more than 256 origins (it exports
``ingest_staged_origins``) more writers' receive and emitting write at N =
100,000, on ``chip_smoke.py``'s kernels-phase inputs, it holds both
builds bitwise to the plain version, then times each through the wrapper
with CUDA events over 20 calls, ``--reps`` times in ABBA order, and prints
the card's name and power limit, each time, and the medians. First it
prints whether ptxas' report (stack frame, spills, registers, shared
memory) of every instantiation both builds hold is identical. Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path


def _build_baseline(src: Path) -> tuple[ctypes.CDLL, str, bool, bool, bool, bool]:
    """The baseline's library, nvcc's output for it, whether it takes rows
    past 256 cells, whether it takes more than 64 queue slots, whether it
    takes more than 128 messages, and whether it takes more than 256
    origins."""
    from corrosion_tpu_torch.ops import cuda_lib

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = cuda_lib.BUILD_DIR / f"ingest-baseline-{digest}.so"
    if not out.exists() or not out.with_suffix(".log").exists():
        cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    tables = hasattr(lib, "ingest_staged_cells")
    if not tables:
        # a source from before the row in global memory stages every row it
        # takes (at most 256 cells), which the wrapper's form label asks
        lib.ingest_staged_cells = lambda: 256
    deep = hasattr(lib, "ingest_shallow_limits")
    if not deep:
        # a source from before the deep form holds at most 4 seen words and
        # 64 queue slots, in the forms the wrapper's label calls shallow
        def shallow(out):
            out[0], out[1] = 4, 64
            return 0

        lib.ingest_shallow_limits = shallow
    long_form = hasattr(lib, "ingest_long_limits")
    if not long_form:
        # a source from before the long form holds at most 128 messages and
        # 32 picks, the limits the wrapper's label reads past them
        def register(out):
            out[0], out[1] = 128, 32
            return 0

        lib.ingest_long_limits = register
    book = hasattr(lib, "ingest_staged_origins")
    return lib, out.with_suffix(".log").read_text(), tables, deep, long_form, book


def _same_ptxas(cs, log_a: str, log_b: str) -> None:
    """Print whether ptxas' report of each instantiation in both builds is
    identical (stack frame, spills, registers and shared memory). An
    instantiation is matched by its form (``chip_smoke._ingest_instantiation``),
    so that a source whose book argument is ``bool WO`` meets one whose is
    ``int BK``."""

    def by_form(log):
        return {cs._ingest_instantiation(k) or k: v
                for k, v in cs._ptxas_functions(log).items()}

    a, b = by_form(log_a), by_form(log_b)
    both = sorted(set(a) & set(b), key=str)
    differ = [k for k in both if a[k] != b[k]]
    print(f"[ingest_ab] ptxas: {len(both)} instantiations in both builds ({len(a)} in "
          f"A, {len(b)} in B), {len(differ)} with another report", flush=True)
    for k in differ:
        print(f"[ingest_ab]   {k}: A {a[k]}, B {b[k]}", flush=True)


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
    baseline, baseline_log, tables_too, deep_too, long_too, book_too = _build_baseline(
        args.baseline)
    libs = {"A": cuda_lib.library("ingest"), "B": baseline}
    _same_ptxas(cs, cuda_lib.build_log("ingest"), baseline_log)
    flag, big, full = (scale_sim_config(100_000), million_config(1_000_000),
                       full_view_config(8192))
    forms = (("ingest", flag, "receive", 27), ("ingest_emit", flag, "write_emit", 32),
             ("ingest_q_i8", big, "receive", 41), ("ingest_emit_q_i8", big, "write_emit", 42),
             ("ingest_full", full, "receive_full", 51),
             ("ingest_write_full", full, "write", 52))
    if tables_too:
        tables = scale_sim_config(100_000, **cs.TABLES)
        forms += (("ingest_tables", tables, "receive", 65),
                  ("ingest_emit_tables", tables, "write_emit", 66))
    if deep_too:
        queues = scale_sim_config(100_000, **cs.QUEUES)
        forms += (("ingest_queues", queues, "receive", 71),
                  ("ingest_emit_queues", queues, "write_emit", 72))
    if long_too:
        packets = scale_sim_config(100_000, **cs.PACKETS)
        forms += (("ingest_packets", packets, "receive", 76),
                  ("ingest_emit_packets", packets, "write_emit", 77))
    if book_too:
        origins = scale_sim_config(100_000, **cs.ORIGINS)
        forms += (("ingest_origins", origins, "receive", 92),
                  ("ingest_emit_origins", origins, "write_emit", 93))
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
