"""ctypes binding of the native C++ letter-to-sound engine (``native/g2p``):
the port's counterpart of ``a3t_tpu/text/native_g2p.py``, with the same C
signature.

The engine applies NRL-style context-sensitive rules and is the OOV path of
the sedit CLIs.  The library is compiled at first use with the host C++
compiler (the flags of ``native/g2p/Makefile``) from ``native/g2p/g2p.cc``
into ``a3t_tpu_torch/_build/``, under a name keyed by a hash of the source
and the flags; nothing is written into ``native/g2p/``.  A failed build
raises: there is no Python rule engine to fall back to.
"""

from __future__ import annotations

import ctypes
import os

from a3t_tpu_torch import host_build

NATIVE_DIR = os.path.join(host_build.ROOT, "native", "g2p")
SOURCES = ("g2p.cc",)
BUILD_DIR = host_build.BUILD_DIR
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None


def library_path() -> str:
    return host_build.library_path("liba3t_g2p", NATIVE_DIR, SOURCES,
                                   CXX_FLAGS, BUILD_DIR)


def build() -> str:
    """Compile the engine unless it is built; returns the library's path."""
    return host_build.build(library_path(), NATIVE_DIR, SOURCES, CXX_FLAGS)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.g2p_word.restype = ctypes.c_int
        lib.g2p_word.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int]
        _lib = lib
    return _lib


def letter_to_sound(word: str) -> list[str]:
    """Word -> ARPAbet phones via the native rule engine (``AH0`` when the
    engine gives none)."""
    buf = ctypes.create_string_buffer(1024)
    n = _load().g2p_word(word.encode(), buf, 1024)
    if n <= 0:
        return ["AH0"]
    return buf.value.decode().split()
