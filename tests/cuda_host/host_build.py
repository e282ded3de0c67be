"""Build one of the port's CUDA kernel sources (corrosion_tpu_torch/csrc) for
the host, against the stand-in runtime in this directory, and route the
kernel wrappers' launches to it.

The source's launches, ``kernel<<<grid, threads, 0, stream>>>(args);``, are
rewritten to ``host_launch(kernel, grid, threads, args);`` and the result is
compiled with g++ into a shared library with the same C interface, loaded
with ctypes. :func:`route_launches` then hands that library to the wrapper
in place of the nvcc build, so a test launches the source through the
wrapper's own argument packing.
"""

import ctypes
import re
import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

from corrosion_tpu_torch.ops import cuda_lib

HOST_INCLUDE = Path(__file__).resolve().parent
_LAUNCH = re.compile(r"(\w+<[^;]*?>)<<<(\w+), (\w+), 0, \w+>>>\((.*?)\);")


def build(name: str, out: Path) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built for the host into ``out``; skips the test
    when there is no g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source with")
    src = (cuda_lib.SRC_DIR / f"{name}.cu").read_text()
    src, n = _LAUNCH.subn(r"host_launch(\1, \2, \3, \4);", src)
    assert n > 0, "no kernel launch found to rewrite"
    (out / f"{name}_host.cpp").write_text(src)
    lib = out / f"{name}_host.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         "-I", str(HOST_INCLUDE), "-o", str(lib), str(out / f"{name}_host.cpp")],
        check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def route_launches(monkeypatch, lib: ctypes.CDLL) -> None:
    """Make the wrappers launch ``lib`` on stream 0."""
    monkeypatch.setattr(cuda_lib, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
