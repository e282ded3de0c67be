"""ctypes bindings for the native host oracle ``native/corro_host.cpp``
(port of ``corrosion_tpu/native/__init__.py``).

The C++ source lives at the repository root, outside both packages; this
module compiles it with ``g++`` into ``build/corro_host-<hash>.so`` (keyed
by a hash of the source and the flags, as ``ops/cuda_lib.py`` keys the
CUDA kernels) the first time it is needed, and loads it with ``ctypes``.
Where the JAX package's ``load()`` returns None and its callers fall back
to the pure-Python oracle, this one raises with the compiler's output:
the port never swaps one oracle for another on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "corro_host.cpp"
BUILD_DIR = _ROOT / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
_lock = threading.Lock()
_lib = None


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"corro_host-{digest}.so"


def _build(out: pathlib.Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler for native/corro_host.cpp "
                           "(g++ not on PATH and $CXX unset)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{' '.join(cmd)} did not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The loaded native library, built on first use; raises with the
    compiler's output when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.corro_lww_new.restype = p
        lib.corro_lww_new.argtypes = [i32]
        lib.corro_lww_free.argtypes = [p]
        lib.corro_lww_merge.restype = i32
        lib.corro_lww_merge.argtypes = [p, i32, i32, i32, i32, i32, i32]
        lib.corro_lww_get.argtypes = [p, i32, ip]
        lib.corro_lww_dump.argtypes = [p, ip, ip, ip, ip, ip]
        lib.corro_book_new.restype = p
        lib.corro_book_new.argtypes = [i32]
        lib.corro_book_free.argtypes = [p]
        lib.corro_book_record.restype = i32
        lib.corro_book_record.argtypes = [p, i32, i32]
        lib.corro_book_head.restype = i32
        lib.corro_book_head.argtypes = [p, i32]
        lib.corro_book_known_max.restype = i32
        lib.corro_book_known_max.argtypes = [p, i32]
        lib.corro_book_needs.restype = i64
        lib.corro_book_needs.argtypes = [p, i32]
        lib.corro_book_n_gaps.restype = i64
        lib.corro_book_n_gaps.argtypes = [p, i32]
        lib.corro_apply_batch.restype = i32
        lib.corro_apply_batch.argtypes = [p, p, ip, i32, ip]
        lib.corro_cluster_new.restype = p
        lib.corro_cluster_new.argtypes = [i32, i32, i32, i32, i32, i32, i64]
        lib.corro_cluster_free.argtypes = [p]
        lib.corro_cluster_write.argtypes = [p, i32, i32, i32, i32]
        lib.corro_cluster_write_tx.argtypes = [p, i32, ip, ip, ip, i32]
        lib.corro_cluster_round.argtypes = [p]
        lib.corro_cluster_kill.argtypes = [p, i32]
        lib.corro_cluster_revive.argtypes = [p, i32]
        lib.corro_cluster_set_partition.argtypes = [p, ip]
        lib.corro_cluster_converged.restype = i32
        lib.corro_cluster_converged.argtypes = [p]
        lib.corro_cluster_settle.restype = i32
        lib.corro_cluster_settle.argtypes = [p, i32]
        lib.corro_cluster_store.argtypes = [p, i32, ip, ip, ip, ip, ip]
        lib.corro_cluster_total_needs.restype = i64
        lib.corro_cluster_total_needs.argtypes = [p]
        _lib = lib
        return _lib


class NativeNode:
    """One simulated node backed by the C++ engine: LWW store + bookie.

    Mirrors ``sim/oracle.OracleNode`` exactly — the devcluster parity
    harness uses this for big host clusters where Python dicts are slow.
    """

    def __init__(self, n_cells: int, n_origins: int):
        self._lib = load()
        self.n_cells = n_cells
        self.n_origins = n_origins
        self._lww = self._lib.corro_lww_new(n_cells)
        self._book = self._lib.corro_book_new(n_origins)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            if getattr(self, "_lww", None):
                lib.corro_lww_free(self._lww)
            if getattr(self, "_book", None):
                lib.corro_book_free(self._book)

    def apply(self, changes) -> np.ndarray:
        """Apply [n, 7] int32 rows (cell, ver, val, site, origin, dbv,
        clp); returns per-change freshness flags."""
        arr = np.ascontiguousarray(changes, dtype=np.int32).reshape(-1, 7)
        fresh = np.zeros(arr.shape[0], dtype=np.int32)
        self._lib.corro_apply_batch(
            self._book,
            self._lww,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            arr.shape[0],
            fresh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return fresh.astype(bool)

    def record(self, origin: int, version: int) -> bool:
        return bool(self._lib.corro_book_record(self._book, origin, version))

    def head(self, origin: int) -> int:
        return self._lib.corro_book_head(self._book, origin)

    def known_max(self, origin: int) -> int:
        return self._lib.corro_book_known_max(self._book, origin)

    def needs(self, origin: int) -> int:
        return self._lib.corro_book_needs(self._book, origin)

    def n_gaps(self, origin: int) -> int:
        return self._lib.corro_book_n_gaps(self._book, origin)

    def store(self):
        """The (ver, val, site, dbv, clp) planes as [n_cells] int32."""
        planes = tuple(
            np.zeros(self.n_cells, dtype=np.int32) for _ in range(5)
        )
        ptrs = [
            pl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for pl in planes
        ]
        self._lib.corro_lww_dump(self._lww, *ptrs)
        return planes


class NativeCluster:
    """Whole-cluster round engine in C++ — the 256+-node devcluster
    oracle (same interface as ``sim/parity.OracleCluster``)."""

    def __init__(self, n_nodes: int, n_origins: int, n_cells: int,
                 fanout: int = 3, rebroadcast_budget: int = 3,
                 sync_peers: int = 2, seed: int = 0):
        self._lib = load()
        self.n_nodes = n_nodes
        self.n_origins = n_origins
        self.n_cells = n_cells
        self._h = self._lib.corro_cluster_new(
            n_nodes, n_origins, n_cells, fanout, rebroadcast_budget,
            sync_peers, seed,
        )

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.corro_cluster_free(self._h)

    def write(self, node: int, cell: int, value: int, clp: int = 0) -> None:
        self._lib.corro_cluster_write(self._h, node, cell, value, clp)

    def write_tx(self, node: int, cells) -> None:
        """Multi-statement transaction: ``cells`` = [(cell, value, clp)]
        commit atomically under one db_version (chunked dissemination)."""
        arr = np.ascontiguousarray(cells, dtype=np.int32).reshape(-1, 3)
        ip = ctypes.POINTER(ctypes.c_int32)
        c = np.ascontiguousarray(arr[:, 0])
        v = np.ascontiguousarray(arr[:, 1])
        l = np.ascontiguousarray(arr[:, 2])  # noqa: E741
        self._lib.corro_cluster_write_tx(
            self._h, node, c.ctypes.data_as(ip), v.ctypes.data_as(ip),
            l.ctypes.data_as(ip), arr.shape[0],
        )

    def round(self) -> None:
        self._lib.corro_cluster_round(self._h)

    # --- fault injection (kill, revive, partition, heal) -----------------
    def kill(self, node: int) -> None:
        self._lib.corro_cluster_kill(self._h, node)

    def revive(self, node: int) -> None:
        self._lib.corro_cluster_revive(self._h, node)

    def set_partition(self, groups) -> None:
        g = np.ascontiguousarray(groups, dtype=np.int32)
        if g.shape != (self.n_nodes,):
            raise ValueError(
                f"partition groups shape {g.shape} != ({self.n_nodes},)"
            )
        self._lib.corro_cluster_set_partition(
            self._h, g.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )

    def heal_partition(self) -> None:
        self.set_partition(np.zeros(self.n_nodes, np.int32))

    def apply_faults(self, events) -> None:
        """Apply one round's fault events: ("kill", node),
        ("revive", node), ("partition", groups), ("heal",)."""
        for ev in events:
            kind = ev[0]
            if kind == "kill":
                self.kill(ev[1])
            elif kind == "revive":
                self.revive(ev[1])
            elif kind == "partition":
                self.set_partition(ev[1])
            elif kind == "heal":
                self.heal_partition()
            else:
                raise ValueError(f"unknown fault event {ev!r}")

    def converged(self) -> bool:
        return bool(self._lib.corro_cluster_converged(self._h))

    def total_needs(self) -> int:
        return self._lib.corro_cluster_total_needs(self._h)

    def run(self, script, settle_rounds: int = 256) -> int:
        """Apply a WorkloadScript (writes + fault events) then settle;
        rounds taken or -1. Outstanding faults heal/revive before the
        settle phase so convergence is reachable."""
        from corrosion_tpu_torch.sim.parity import _as_tx

        faults = getattr(script, "faults", None) or []
        for r, batch in enumerate(script.writes):
            if r < len(faults):
                self.apply_faults(faults[r])
            for node, cells in (_as_tx(w) for w in batch):
                self.write_tx(node, cells)
            self.round()
        self.heal_partition()
        for node in range(self.n_nodes):
            self.revive(node)
        settled = self._lib.corro_cluster_settle(self._h, settle_rounds)
        return -1 if settled < 0 else len(script.writes) + settled

    def store_planes(self, node: int = 0):
        planes = tuple(np.zeros(self.n_cells, np.int32) for _ in range(5))
        ptrs = [pl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
                for pl in planes]
        self._lib.corro_cluster_store(self._h, node, *ptrs)
        return planes
