"""ctypes binding of the native threaded WAV/FLAC batch loader
(``native/loader``): the port's counterpart of
``a3t_tpu/data/native_loader.py``, with the same C signatures.

The C++ thread pool decodes a whole batch of files straight into the
(B, max_samples) buffer the train step consumes.  The library is compiled
at first use with the host C++ compiler (the flags of
``native/loader/Makefile``) from the sources in ``native/loader/`` into
``a3t_tpu_torch/_build/``, under a name keyed by a hash of the sources and
the flags; nothing is written into ``native/loader/``.  A failed build
raises: there is no Python decoding to fall back to.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from a3t_tpu_torch import host_build

NATIVE_DIR = os.path.join(host_build.ROOT, "native", "loader")
SOURCES = ("loader.cc", "flac.cc", "flac.h")
BUILD_DIR = host_build.BUILD_DIR
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib = None


def library_path() -> str:
    return host_build.library_path("liba3t_loader", NATIVE_DIR, SOURCES,
                                   CXX_FLAGS, BUILD_DIR)


def build() -> str:
    """Compile the loader unless it is built; returns the library's path."""
    return host_build.build(library_path(), NATIVE_DIR, SOURCES, CXX_FLAGS)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.loader_new.restype = ctypes.c_void_p
        lib.loader_new.argtypes = [ctypes.c_int]
        lib.loader_free.restype = None
        lib.loader_free.argtypes = [ctypes.c_void_p]
        lib.loader_register.restype = ctypes.c_int
        lib.loader_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int64]
        lib.loader_probe.restype = ctypes.c_int
        lib.loader_probe.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        lib.loader_load_batch.restype = ctypes.c_int
        lib.loader_load_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64)]
        lib.loader_load_batch_i16.restype = ctypes.c_int
        lib.loader_load_batch_i16.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int64)]
        lib.loader_read_file.restype = ctypes.c_int
        lib.loader_read_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def probe_file(path: str) -> tuple[int, int]:
    """(n_samples, sample_rate) of one wav or flac file from its header."""
    ns, sr = ctypes.c_int64(), ctypes.c_int32()
    if not _load().loader_read_file(path.encode(), None, 0, ctypes.byref(ns),
                                    ctypes.byref(sr)):
        raise IOError(f"native probe failed: {path}")
    return int(ns.value), int(sr.value)


def read_file(path: str) -> tuple[int, np.ndarray]:
    """Single-file native decode (wav or flac): (fs, float32 in [-1, 1]).
    Raises IOError if the native library cannot parse the file."""
    n, _ = probe_file(path)
    out = np.empty(n, np.float32)
    ns, sr = ctypes.c_int64(), ctypes.c_int32()
    if not _load().loader_read_file(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, ctypes.byref(ns), ctypes.byref(sr)):
        raise IOError(f"native decode failed: {path}")
    return int(sr.value), out


class NativeWavLoader:
    """Thread-pooled batch decoding of registered wav paths."""

    def __init__(self, paths: Sequence[str], n_threads: int = 4):
        self.lib = _load()
        self.handle = self.lib.loader_new(n_threads)
        self.paths = list(paths)
        blob = b"\0".join(p.encode() for p in self.paths) + b"\0"
        n = self.lib.loader_register(self.handle, blob, len(blob))
        if n != len(self.paths):
            raise ValueError(f"registered {n} of {len(self.paths)} paths")

    def close(self):
        if self.handle:
            self.lib.loader_free(self.handle)
            self.handle = None

    def __del__(self):
        if getattr(self, "handle", None):
            self.close()

    def probe(self) -> tuple[np.ndarray, np.ndarray]:
        """(n_samples, sample_rate) arrays for all registered paths (parallel
        header reads)."""
        n = len(self.paths)
        ns = np.zeros(n, np.int64)
        sr = np.zeros(n, np.int32)
        errs = self.lib.loader_probe(
            self.handle, ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if errs:
            bad = [self.paths[i] for i in np.nonzero(ns < 0)[0][:3]]
            raise IOError(f"{errs} unreadable wavs, e.g. {bad}")
        return ns, sr

    def _load_batch(self, fn, dtype, cptr, indices, max_samples, out):
        idx = np.ascontiguousarray(indices, np.int32)
        b = len(idx)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.paths)):
            raise IndexError(f"indices outside 0..{len(self.paths) - 1}")
        if out is None:
            out = np.empty((b, max_samples), dtype)
        if (out.shape != (b, max_samples) or out.dtype != dtype
                or not out.flags.c_contiguous):
            raise ValueError(f"out must be a C-contiguous {np.dtype(dtype)} "
                             f"array of shape {(b, max_samples)}")
        lengths = np.zeros(b, np.int64)
        errs = fn(
            self.handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b, max_samples, out.ctypes.data_as(ctypes.POINTER(cptr)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if errs:
            raise IOError(f"{errs} failed reads in batch")
        return out, lengths.astype(np.int32)

    def load_batch(self, indices: Sequence[int], max_samples: int,
                   out: np.ndarray | None = None):
        """Decode ``indices`` into a (B, max_samples) float32 buffer."""
        return self._load_batch(self.lib.loader_load_batch, np.float32,
                                ctypes.c_float, indices, max_samples, out)

    def load_batch_i16(self, indices: Sequence[int], max_samples: int,
                       out: np.ndarray | None = None):
        """Decode ``indices`` into a (B, max_samples) int16 PCM buffer (the
        batcher's ``audio_int16`` format; 16-bit sources are copied)."""
        return self._load_batch(self.lib.loader_load_batch_i16, np.int16,
                                ctypes.c_int16, indices, max_samples, out)
