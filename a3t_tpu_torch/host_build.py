"""Shared libraries compiled from the repo's ``native/`` C++ sources with the
host C++ compiler.

Each library is built at first use into ``a3t_tpu_torch/_build/`` (ignored
by git), under a name keyed by a hash of its sources and flags, so an edited
source rebuilds and an unchanged one is reused; nothing is written into
``native/``.  A failed build raises: nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(ROOT, "a3t_tpu_torch", "_build")


def compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found (CXX, c++, g++) to build the "
                       "native libraries")


def library_path(name: str, src_dir: str, sources: Sequence[str],
                 flags: Sequence[str], build_dir: str = BUILD_DIR) -> str:
    """``build_dir/<name>_<hash of the sources and flags>.so``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(os.path.join(src_dir, src), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"{name}_{h.hexdigest()[:16]}.so")


def build(path: str, src_dir: str, sources: Sequence[str],
          flags: Sequence[str]) -> str:
    """Compile ``sources`` (the ``.cc`` files among them) into ``path``
    unless it exists; returns ``path``.  Concurrent builds each link to their
    own temporary name and rename it into place, so a reader never maps a
    half-written file."""
    if os.path.isfile(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [compiler(), *flags, "-o", tmp,
           *(os.path.join(src_dir, s) for s in sources if s.endswith(".cc"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {os.path.relpath(src_dir, ROOT)} "
                           f"failed:\n{proc.stderr}")
    os.replace(tmp, path)
    return path
