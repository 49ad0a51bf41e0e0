"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each library is compiled at first use from the sources in ``csrc/`` into
``a3t_tpu_torch/_build/`` (ignored by git), under a name keyed by a hash of
the sources, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  The sources
expose plain C entry points: no PyTorch headers, no ninja.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
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
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, s) for s in sources] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str, sources: tuple[str, ...]):
    """Start nvcc for one library unless it is built: (path, tmp, process),
    the process None when there is nothing to do."""
    path = library_path(name, sources)
    if os.path.isfile(path):
        return path, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in sources)]
    return path, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


def build_all(libraries: dict[str, tuple[str, ...]]) -> dict[str, str]:
    """Compile every library of ``{name: sources}`` (file names in csrc/)
    that is not built yet, one nvcc each, all started together; returns
    ``{name: path}``.  Raises if any build fails."""
    started = {name: _start(name, srcs) for name, srcs in libraries.items()}
    failed = []
    for name, (path, tmp, proc) in started.items():
        if proc is None:
            continue
        build_logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"nvcc failed for {name}:\n{build_logs[name]}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: path for name, (path, _, _) in started.items()}


def build(name: str, sources: tuple[str, ...]) -> str:
    """Compile ``sources`` (file names in csrc/) into one shared library
    unless it is already built; returns its path."""
    return build_all({name: sources})[name]


def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """The built library, compiled on first use in this process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name, sources))
    return _loaded[name]


def bind(name: str, sources: tuple[str, ...], symbol: str, n_ptr: int,
         n_int: int):
    """The C entry point ``symbol`` of library ``name`` with the attention
    kernels' signature: ``n_ptr`` pointers, ``n_int`` ints, then scale,
    seed, threshold, keep_scale, dropout and the stream; it returns the
    CUDA error code."""
    fn = getattr(load(name, sources), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn
