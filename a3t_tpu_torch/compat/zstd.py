"""Zstandard decompression for the orbax reader, through the port's own
decoder (``a3t_tpu_torch/native/zstd_decode.cc``, RFC 8878).

The library is compiled at first use with the host C++ compiler into
``a3t_tpu_torch/_build/`` (``host_build``), under a name keyed by a hash of
the source and the flags; a failed build raises.  The decoder takes no
dictionary.  ctypes releases the interpreter lock for the call, so several
arrays decode at once on a thread pool.  The same library gives the CRC-32C
that OCDBT nodes carry.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from a3t_tpu_torch import host_build

NATIVE_DIR = os.path.join(host_build.ROOT, "a3t_tpu_torch", "native")
SOURCES = ("zstd_decode.cc",)
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None
_DST_TOO_SMALL = -8  # zstd_decode.cc's kDstTooSmall


def library_path() -> str:
    return host_build.library_path("liba3t_zstd", NATIVE_DIR, SOURCES,
                                   CXX_FLAGS)


def build() -> str:
    """Compile the decoder unless it is built; returns the library's path."""
    return host_build.build(library_path(), NATIVE_DIR, SOURCES, CXX_FLAGS)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.a3t_zstd_decompress.restype = ctypes.c_longlong
        lib.a3t_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                            ctypes.c_void_p, ctypes.c_size_t]
        lib.a3t_zstd_content_size.restype = ctypes.c_longlong
        lib.a3t_zstd_content_size.argtypes = [ctypes.c_char_p,
                                              ctypes.c_size_t]
        lib.a3t_zstd_error_name.restype = ctypes.c_char_p
        lib.a3t_zstd_error_name.argtypes = [ctypes.c_int]
        lib.a3t_xxh64.restype = ctypes.c_ulonglong
        lib.a3t_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_ulonglong]
        lib.a3t_crc32c.restype = ctypes.c_uint
        lib.a3t_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        _lib = lib
    return _lib


def _error(code: int) -> ValueError:
    return ValueError(f"zstd: {_load().a3t_zstd_error_name(code).decode()}")


def content_size(src: bytes) -> Optional[int]:
    """The first frame's stated content size, or None when it states none."""
    n = _load().a3t_zstd_content_size(src, len(src))
    if n < -1:
        raise _error(n)
    return None if n == -1 else n


def _decode(src: bytes, dst, cap: int) -> int:
    """Decodes ``src`` into ``cap`` bytes at ``dst`` (a ctypes buffer or an
    address); returns the bytes written."""
    n = _load().a3t_zstd_decompress(src, len(src), dst, cap)
    if n < 0:
        raise _error(n)
    return n


def decompress(src: bytes, size: Optional[int] = None) -> bytes:
    """The decoded bytes of the frames in ``src``.  ``size`` is the exact
    decoded size when the caller knows it (a zarr chunk's, from its
    ``.zarray``); else it comes from the frame header, which must state it.
    Malformed input, or output of another size, raises ``ValueError``."""
    src = bytes(src)
    if size is None:
        size = content_size(src)
        if size is None:
            raise ValueError("zstd: the frame states no content size; pass "
                             "the decoded size")
    out = ctypes.create_string_buffer(size)
    n = _decode(src, out, size)
    if n != size:
        raise ValueError(f"zstd: decoded {n} bytes, expected {size}")
    return out.raw


def decompress_into(src: bytes, out) -> None:
    """Decodes ``src`` straight into ``out``, a C-contiguous numpy array or
    CPU tensor whose size in bytes is the decoded size exactly."""
    if isinstance(out, np.ndarray):
        if not out.flags.c_contiguous or not out.flags.writeable:
            raise ValueError("zstd: the output array must be C-contiguous "
                             "and writable")
        ptr, size = out.ctypes.data, out.nbytes
    else:  # a torch tensor
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("zstd: the output tensor must be a contiguous "
                             "CPU tensor")
        ptr, size = out.data_ptr(), out.numel() * out.element_size()
    n = _decode(bytes(src), ptr, size)
    if n != size:
        raise ValueError(f"zstd: decoded {n} bytes, expected {size}")


def decompress_bounded(src: bytes, limit: int) -> bytes:
    """The decoded bytes of frames that state no content size, at most
    ``limit`` of them (more raises ``ValueError``).  The output buffer
    starts at 16 times the input and grows fourfold up to ``limit``."""
    src = bytes(src)
    cap = min(limit, max(1 << 16, 16 * len(src)))
    while True:
        out = ctypes.create_string_buffer(cap)
        n = _load().a3t_zstd_decompress(src, len(src), out, cap)
        if n != _DST_TOO_SMALL or cap == limit:
            break
        cap = min(limit, 4 * cap)
    if n < 0:
        raise _error(n)
    return out.raw[:n]


def xxh64(data: bytes, seed: int = 0) -> int:
    return _load().a3t_xxh64(data, len(data), seed)


def crc32c(data: bytes) -> int:
    return _load().a3t_crc32c(data, len(data))
