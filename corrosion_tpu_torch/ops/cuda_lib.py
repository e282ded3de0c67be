"""Build and load the port's CUDA kernels (plain-C shared libraries).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/<name>-<hash>.so`` at the repository root, keyed by a hash of the
source and the flags, and loaded with ``ctypes``. The build happens at
first use (or up front through :func:`build_all`, which starts one
``nvcc`` per source at once) and raises with the compiler's output when it
fails. Nothing is imported or compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("swim_tables", "ingest")
# --split-compile=0 runs the device optimizer on every core: on an 8-core
# host the ingest source's 54 instantiations built in 21.9 s instead of 40.8,
# with the same ptxas report for every kernel
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, cmd, proc


def _finish(out: Path, tmp: str, cmd, proc) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict:
    """Build every missing library, one ``nvcc`` per source, all started
    together. Returns ``{name: path}``."""
    jobs = [_start(n) for n in names if not library_path(n).exists()]
    try:
        for job in jobs:
            _finish(*job)
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return {n: library_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        path = build_all((name,))[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, spills) for a built library."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
