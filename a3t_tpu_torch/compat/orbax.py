"""Orbax checkpoints read without orbax, tensorstore or JAX: the port's
counterpart of ``a3t_tpu/train/checkpoint.py::restore_portable``.

A checkpoint directory written by orbax's ``StandardCheckpointer`` (or
``PyTreeCheckpointer``) with OCDBT holds ``_METADATA`` (the tree: each
leaf's key path, with dict keys and sequence indices) and an OCDBT store
(:mod:`a3t_tpu_torch.compat.ocdbt`) mapping each leaf's dotted name to a zarr
v2 array: ``<name>/.zarray`` (JSON metadata) and its chunks.  The arrays
orbax writes are one chunk each (chunks == shape), C order, zstd-compressed;
any other layout raises, naming the leaf.

bfloat16 leaves come back as ``torch.bfloat16`` tensors holding the stored
bits (numpy has no bfloat16); every other leaf is a numpy array of its
stored dtype.  Leaves that orbax saved as ``None`` (empty optimizer states)
come back as ``None``, sequences as lists.
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from a3t_tpu_torch.compat import zstd
from a3t_tpu_torch.compat.ocdbt import OcdbtStore

_SEQUENCE_KEY = 1  # key_type of a list or tuple index in _METADATA
_WORKERS = 8  # threads that decode the leaves (ctypes releases the GIL)


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is an orbax checkpoint directory (it holds the tree
    metadata ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, "_METADATA"))


def _leaf(store: OcdbtStore, name: str):
    where = f"orbax leaf {name!r} of {store.base}"
    meta = json.loads(store.read(f"{name}/.zarray".encode()))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr format {meta.get('zarr_format')}")
    shape = tuple(meta["shape"])
    if tuple(meta["chunks"]) != shape:
        raise ValueError(f"{where}: chunks {meta['chunks']} for shape "
                         f"{list(shape)} (only single-chunk arrays are read)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{where}: order {meta['order']!r}")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']}")
    comp = meta.get("compressor") or {}
    if comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {meta.get('compressor')}")
    if meta["dtype"] == "bfloat16":
        out = torch.empty(shape, dtype=torch.bfloat16)
    else:
        out = np.empty(shape, np.dtype(meta["dtype"]))
    if math.prod(shape):
        sep = meta.get("dimension_separator", ".")
        chunk = f"{name}/{sep.join(['0'] * max(len(shape), 1))}".encode()
        if chunk not in store:
            raise ValueError(f"{where}: no chunk (fill value "
                             f"{meta.get('fill_value')!r} not taken)")
        zstd.decompress_into(store.read(chunk), out)
    return out


def _nest(items: list):
    """[(key path, value)] -> nested dicts, sequences as lists."""
    root: dict = {}
    kinds: dict = {}
    for path, value in items:
        node = root
        for depth, (key, kind) in enumerate(path):
            kinds[id(node)] = kind
            if depth == len(path) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        if kinds.get(id(node)) == _SEQUENCE_KEY:
            return [build(node[k]) for k in sorted(node, key=int)]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def restore_portable(path: str, only: Optional[Sequence[str]] = None):
    """The tree of the orbax checkpoint at ``path`` (see the module's
    docstring for the leaves' types), or of its top-level entries named in
    ``only``; the leaves decode on ``_WORKERS`` threads."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"no orbax checkpoint at {path} (no "
                                "_METADATA)")
    with open(meta_path, encoding="utf-8") as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3"):
        raise ValueError(f"{path}: only OCDBT checkpoints of zarr v2 "
                         "arrays are read")
    store = OcdbtStore(path)
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [(str(k["key"]), k["key_type"]) for k in entry["key_metadata"]]
        if only is not None and keys[0][0] not in only:
            continue
        skip = entry["value_metadata"].get("skip_deserialize", False)
        leaves.append((keys, None if skip else ".".join(k for k, _ in keys)))
    names = [name for _, name in leaves if name is not None]
    with ThreadPoolExecutor(max(1, min(_WORKERS, len(names)))) as pool:
        values = dict(zip(names, pool.map(lambda n: _leaf(store, n), names)))
    return _nest([(keys, None if name is None else values[name])
                  for keys, name in leaves])
