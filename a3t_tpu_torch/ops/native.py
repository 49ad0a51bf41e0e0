"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each library is compiled at first use from the sources in ``csrc/`` into
``a3t_tpu_torch/_build/`` (ignored by git), under a name keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused.  The sources expose plain C entry points: no PyTorch headers, no
ninja.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str, sources: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str, sources: tuple[str, ...]) -> str:
    """Compile ``sources`` (file names in csrc/) into one shared library
    unless it is already built; returns its path."""
    path = library_path(name, sources)
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{build_logs[name]}")
    os.replace(tmp, path)
    return path


def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """The built library, compiled on first use in this process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name, sources))
    return _loaded[name]
