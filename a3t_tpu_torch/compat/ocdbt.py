"""A read-only OCDBT key-value store: the on-disk format that orbax writes
through tensorstore, read without either.

An OCDBT store is a directory holding ``manifest.ocdbt`` and data files
(``d/<hex>``; orbax adds per-process sub-stores ``ocdbt.process_N/`` whose
data files the top store's nodes name).  The manifest holds the store's
config and its version tree; the newest version names the root of a b-tree
whose leaves map each key to a value held inline or as a (data file,
offset, length) reference.  Every structure is a sequence of varints and
column arrays; manifests and nodes carry a header (magic, length, format
version, compression) and a CRC-32C footer, and their bodies are
zstd-compressed (:mod:`a3t_tpu_torch.compat.zstd`).

:class:`OcdbtStore` walks the newest version's tree once when it opens and
keeps every key's value location.  A node whose magic, length, checksum,
height or layout is wrong raises ``ValueError``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional

from a3t_tpu_torch.compat import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
MISSING = (1 << 64) - 1  # offset and length of an empty tree's root
# a manifest holds the config and at most 2^arity versions and version
# node references
MANIFEST_LIMIT = 1 << 24


class _Reader:
    """Cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def fail(self, why: str):
        raise ValueError(f"OCDBT {self.what}: {why}")

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("truncated varint")
            c = self.data[self.pos]
            self.pos += 1
            out |= (c & 0x7F) << shift
            if c < 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> list:
        return list(self.raw(n))

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes after the end")


@dataclass(frozen=True)
class Ref:
    """A byte range of a data file, relative to the store's directory."""
    path: str
    offset: int
    length: int


def _frame(blob: bytes, magic: int, what: str, limit: int) -> bytes:
    """Checks a manifest's or node's header and footer; returns its body."""
    if len(blob) < 12 + 2 + 4:
        raise ValueError(f"OCDBT {what}: {len(blob)} bytes is too short")
    (got_magic,) = struct.unpack_from(">I", blob)
    (length,) = struct.unpack_from("<Q", blob, 4)
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    if length != len(blob):
        raise ValueError(f"OCDBT {what}: states {length} bytes, holds "
                         f"{len(blob)}")
    crc = struct.unpack_from("<I", blob, len(blob) - 4)[0]
    if zstd.crc32c(blob[:-4]) != crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Reader(blob[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version}")
    compression = head.varint()
    body = blob[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise ValueError(f"OCDBT {what}: compression format {compression}")
    size = zstd.content_size(body)
    if size is None:
        return zstd.decompress_bounded(body, limit)
    if size > limit:
        raise ValueError(f"OCDBT {what}: {size} decoded bytes exceed the "
                         f"limit {limit}")
    return zstd.decompress(body, size)


def _strings(r: _Reader, prefix: list, suffix: list) -> list:
    """Strings stored as the length of the prefix each shares with the one
    before it and the suffix's bytes, which follow the length columns."""
    out, prev = [], b""
    for p, n in zip(prefix, suffix):
        if p > len(prev):
            r.fail("bad shared prefix")
        prev = prev[:p] + r.raw(n)
        out.append(prev)
    return out


def _data_files(r: _Reader) -> list:
    """The data file table: each path (relative to the store's directory)
    a base path and a relative path, stored joined."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    paths = _strings(r, prefix, suffix)
    if any(b > len(p) for b, p in zip(base, paths)):
        r.fail("bad data file table")
    return [p.decode() for p in paths]


def _refs(r: _Reader, files: list, n: int) -> list:
    ids = r.varints(n)
    offsets = r.varints(n)
    lengths = r.varints(n)
    out = []
    for i, o, ln in zip(ids, offsets, lengths):
        if o == MISSING and ln == MISSING:
            out.append(None)
            continue
        if i >= len(files):
            r.fail(f"data file id {i} of {len(files)}")
        out.append(Ref(files[i], o, ln))
    return out


def _keys(r: _Reader, n: int, interior: bool):
    """A node's keys and, in an interior node, the length of the prefix
    that each child's keys share (and leave out)."""
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys = _strings(r, prefix, suffix)
    if interior and any(c > len(k) for c, k in zip(common, keys)):
        r.fail("bad subtree prefix")
    return keys, common


@dataclass(frozen=True)
class Version:
    generation: int
    root: Optional[Ref]
    height: int
    num_keys: int


def _versions(r: _Reader, files: list) -> list:
    """A version tree leaf's entries (also the manifest's inline ones)."""
    n = r.varint()
    gens = r.varints(n)
    heights = r.u8s(n)
    roots = _refs(r, files, n)
    num_keys = r.varints(n)
    r.varints(n)  # tree bytes
    r.varints(n)  # indirect value bytes
    r.raw(8 * n)  # commit times
    return [Version(g, root, h, k)
            for g, root, h, k in zip(gens, roots, heights, num_keys)]


def _version_refs(r: _Reader, files: list, child_height: Optional[int]):
    """References to version tree nodes: (last generation, ref, height).
    The manifest stores each one's height; an interior node's children
    are all ``child_height`` high."""
    n = r.varint()
    gens = r.varints(n)
    refs = _refs(r, files, n)
    r.varints(n)  # number of generations below
    r.raw(8 * n)  # commit times
    hs = r.u8s(n) if child_height is None else [child_height] * n
    return list(zip(gens, refs, hs))


class OcdbtStore:
    """``list()`` and ``read(key)`` over the newest version of the OCDBT
    store in directory ``base``.  ``heights`` records the height of every
    b-tree node read (0 for leaves)."""

    def __init__(self, base: str):
        self.base = os.path.abspath(base)
        self.heights: list = []
        self.version_heights: list = []
        self._values: dict = {}
        body = _frame(self._read_file("manifest.ocdbt"), MANIFEST_MAGIC,
                      f"manifest {base}", MANIFEST_LIMIT)
        r = _Reader(body, f"manifest {base}")
        self.uuid = r.raw(16).hex()
        kind = r.varint()
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.raw(1)[0]
        compression = r.varint()
        if compression == 1:
            self.zstd_level = struct.unpack("<i", r.raw(4))[0]
        elif compression != 0:
            r.fail(f"compression method {compression}")
        if kind != 0:
            r.fail(f"manifest kind {kind} (only single-file manifests are "
                   "read)")
        files = _data_files(r)
        inline = _versions(r, files)
        nodes = _version_refs(r, files, None)
        r.end()
        newest = self._newest(inline, nodes)
        self.generation = newest.generation if newest else 0
        if newest is not None and newest.root is not None:
            self._walk(newest.root, newest.height, b"")
        if newest is not None and len(self._values) != newest.num_keys:
            raise ValueError(f"OCDBT {base}: read {len(self._values)} keys, "
                             f"the version states {newest.num_keys}")

    # -- files and nodes

    def _read_file(self, rel: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        path = os.path.join(self.base, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f"OCDBT: {rel} ends before {offset + length}")
        return data

    def _node(self, ref: Ref, magic: int, what: str) -> bytes:
        return _frame(self._read_file(ref.path, ref.offset, ref.length),
                      magic, f"{what} at {ref.path}:{ref.offset}",
                      self.max_decoded_node_bytes)

    def _newest(self, inline: list, nodes: list) -> Optional[Version]:
        if inline:
            return max(inline, key=lambda v: v.generation)
        if not nodes:
            return None
        _, ref, height = max(nodes, key=lambda n: n[0])
        while True:  # descend the version tree along its newest entries
            body = self._node(ref, VERSION_TREE_MAGIC, "version tree node")
            r = _Reader(body, "version tree node")
            r.raw(1)  # arity
            got = r.raw(1)[0]
            self.version_heights.append(got)
            if got != height:
                r.fail(f"height {got}, expected {height}")
            files = _data_files(r)
            if height == 0:
                versions = _versions(r, files)
                r.end()
                return max(versions, key=lambda v: v.generation)
            children = _version_refs(r, files, height - 1)
            r.end()
            _, ref, height = max(children, key=lambda n: n[0])

    def _walk(self, ref: Ref, height: int, prefix: bytes):
        body = self._node(ref, BTREE_MAGIC, "b-tree node")
        r = _Reader(body, f"b-tree node at {ref.path}:{ref.offset}")
        got = r.raw(1)[0]
        if got != height:
            r.fail(f"height {got}, expected {height}")
        self.heights.append(height)
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            r.fail("no entries")
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            children = _refs(r, files, n)
            r.varints(3 * n)  # keys, tree bytes, indirect bytes below
            r.end()
            for k, c, child in zip(keys, common, children):
                if child is None:
                    r.fail("missing child")
                self._walk(child, height - 1, prefix + k[:c])
            return
        lengths = r.varints(n)
        kinds = r.u8s(n)
        if any(k > 1 for k in kinds):
            r.fail("bad value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids = r.varints(len(indirect))
        offsets = r.varints(len(indirect))
        for i, fid, off in zip(indirect, ids, offsets):
            if fid >= len(files):
                r.fail(f"data file id {fid} of {len(files)}")
            self._values[prefix + keys[i]] = Ref(files[fid], off, lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self._values[prefix + keys[i]] = r.raw(lengths[i])
        r.end()

    # -- the key-value interface

    def list(self) -> list:
        """Every key, sorted."""
        return sorted(self._values)

    def location(self, key: bytes):
        """The value's bytes when held inline, else its :class:`Ref`."""
        try:
            return self._values[key]
        except KeyError:
            raise KeyError(f"OCDBT {self.base}: no key {key!r}") from None

    def read(self, key: bytes) -> bytes:
        loc = self.location(key)
        if isinstance(loc, Ref):
            return self._read_file(loc.path, loc.offset, loc.length)
        return loc

    def __contains__(self, key: bytes) -> bool:
        return key in self._values
