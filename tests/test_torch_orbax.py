"""The port's orbax reader (a3t_tpu_torch/compat/ocdbt.py and
compat/orbax.py) against tensorstore and the JAX package.

* ``OcdbtStore`` lists and reads the same keys and bytes as tensorstore's
  ``ocdbt`` kvstore on the trained stashes (``artifacts/soak12k_params``,
  ``artifacts/spemb_params``, ``artifacts/vocoder/state``) and on
  checkpoints that orbax's ``StandardCheckpointer`` writes here: mixed
  dtypes, scalars, lists and None, and a tree of 3,000 small leaves written
  with a 4 KiB node limit, whose b-tree has interior nodes (orbax's own
  limit, 100 MB, keeps every tree it writes in one leaf node).
* ``restore_portable`` equals ``a3t_tpu.train.checkpoint.restore_portable``
  leaf for leaf and bit for bit (bfloat16 through its uint16 view).
* A corrupted node, a wrong stated length and unread layouts raise."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from a3t_tpu.train.checkpoint import restore_portable as jax_restore
from a3t_tpu_torch.compat.ocdbt import OcdbtStore
from a3t_tpu_torch.compat.orbax import is_orbax_checkpoint, restore_portable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = [os.path.join(ROOT, "artifacts", p) for p in
             ("soak12k_params", "spemb_params", os.path.join("vocoder",
                                                             "state"))]


def ts_store(path):
    return ts.KvStore.open({"driver": "ocdbt", "base":
                            f"file://{os.path.abspath(path)}/"}).result()


def assert_same_store(path):
    mine = OcdbtStore(path)
    ref = ts_store(path)
    keys = sorted(ref.list().result())
    assert mine.list() == keys
    for k in keys:
        assert mine.read(k) == ref.read(k).result().value, k
    return mine


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)[0]


def assert_same_tree(mine, ref):
    got, want = _leaves(mine), _leaves(ref)
    assert [jax.tree_util.keystr(k) for k, _ in got] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        if b is None:
            assert a is None, k
            continue
        b = np.asarray(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, k
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy().view(np.uint16), b.view(np.uint16))
            continue
        assert isinstance(a, np.ndarray) and a.shape == b.shape, k
        if a.dtype == np.int64 and b.dtype == np.int32:  # JAX without x64
            assert np.array_equal(a.astype(np.int32), b), k
            continue
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_artifact_stores_equal_tensorstore(path):
    store = assert_same_store(path)
    assert store.heights == [0]


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_artifact_trees_equal_jax(path):
    assert is_orbax_checkpoint(path)
    assert_same_tree(restore_portable(path), jax_restore(path))


def _save(path, tree):
    import orbax.checkpoint as ocp

    ckpt = ocp.StandardCheckpointer()
    ckpt.save(os.path.abspath(path), tree)
    ckpt.wait_until_finished()


def test_mixed_dtypes_scalars_and_sequences(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {
        "w": jnp.asarray(rng.standard_normal((7, 5)), jnp.bfloat16),
        "f32": rng.standard_normal((3, 4, 2)).astype(np.float32),
        "i32": rng.integers(-9, 9, (6,)).astype(np.int32),
        "u8": rng.integers(0, 255, (5, 3)).astype(np.uint8),
        "mask": rng.random((4, 4)) > 0.5,
        "f16": rng.standard_normal(9).astype(np.float16),
        "big": rng.standard_normal((300, 200)).astype(np.float32)},
        "step": jnp.asarray(17, jnp.int32),
        "scale": np.float32(0.25),
        "opt": [None, {"count": jnp.asarray(3, jnp.int32)},
                [jnp.zeros((2,)), None]]}
    path = tmp_path / "mixed"
    _save(path, tree)
    assert_same_store(path)
    mine = restore_portable(str(path))
    assert_same_tree(mine, jax_restore(str(path)))
    assert isinstance(mine["opt"], list) and mine["opt"][0] is None
    assert mine["params"]["w"].dtype == torch.bfloat16
    only = restore_portable(str(path), only=("step",))
    assert list(only) == ["step"] and int(only["step"]) == 17


@pytest.fixture
def small_nodes(monkeypatch):
    """orbax writes its OCDBT stores with a 4 KiB node limit."""
    from orbax.checkpoint._src.serialization import tensorstore_utils as tu

    orig = tu.add_ocdbt_write_options

    def add(spec, target_data_file_size=None):
        orig(spec, target_data_file_size)
        spec["config"]["max_decoded_node_bytes"] = 4096

    monkeypatch.setattr(tu, "add_ocdbt_write_options", add)


def test_multi_level_btree(tmp_path, small_nodes):
    tree = {f"layer_{i:04d}": {"kernel": np.full((2, 3), i, np.float32),
                               "bias": np.arange(i % 5 + 1, dtype=np.int32)}
            for i in range(1500)}
    path = tmp_path / "many"
    _save(path, tree)
    top = assert_same_store(path)
    proc = assert_same_store(path / "ocdbt.process_0")
    for store in (top, proc):
        assert len(store.list()) == 6000
        assert sorted(set(store.heights)) == [0, 1, 2]
        assert store.heights.count(2) == 1  # one root
    assert_same_tree(restore_portable(str(path)), jax_restore(str(path)))


def test_corruption_raises(tmp_path):
    src = tmp_path / "ok"
    _save(src, {"a": np.arange(10, dtype=np.float32), "b": {"c": np.ones(3)}})
    for what in ("crc", "length", "magic", "manifest"):
        path = tmp_path / what
        shutil.copytree(src, path)
        if what == "manifest":
            target = os.path.join(path, "manifest.ocdbt")
        else:  # the top store's root node: a file of its own
            d = os.path.join(path, "d")
            target = os.path.join(d, os.listdir(d)[0])
        with open(target, "rb") as f:
            blob = bytearray(f.read())
        if what == "length":  # the header's stated length
            blob[4] ^= 0x01
        elif what == "magic":
            blob[0] ^= 0xFF
        else:
            blob[len(blob) // 2] ^= 0x04
        with open(target, "wb") as f:
            f.write(blob)
        with pytest.raises(ValueError, match={
                "crc": "CRC", "length": "states", "magic": "magic",
                "manifest": "CRC"}[what]):
            OcdbtStore(str(path))


def test_unread_layouts_raise(tmp_path):
    path = tmp_path / "layouts"
    _save(path, {"a": np.arange(6, dtype=np.float32).reshape(2, 3)})
    with pytest.raises(FileNotFoundError):
        restore_portable(str(tmp_path / "nothing"))
    meta = path / "_METADATA"
    m = json.loads(meta.read_text())
    m["use_zarr3"] = True
    meta.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="zarr v2"):
        restore_portable(str(path))


@pytest.mark.parametrize("field,value,match", [
    ("chunks", [1, 3], "single-chunk"),
    ("order", "F", "order"),
    ("filters", [{"id": "delta", "dtype": "<f4"}], "filters"),
    ("compressor", {"id": "blosc"}, "compressor")])
def test_unread_array_metadata_raises(tmp_path, monkeypatch, field, value,
                                      match):
    """A leaf whose .zarray the reader does not take raises, naming it."""
    from a3t_tpu_torch.compat import ocdbt

    path = tmp_path / "meta"
    _save(path, {"leaf": np.arange(6, dtype=np.float32).reshape(2, 3)})
    read = ocdbt.OcdbtStore.read

    def patched(self, key):
        out = read(self, key)
        if key == b"leaf/.zarray":
            meta = json.loads(out)
            meta[field] = value
            out = json.dumps(meta).encode()
        return out

    monkeypatch.setattr(ocdbt.OcdbtStore, "read", patched)
    with pytest.raises(ValueError, match=match) as e:
        restore_portable(str(path))
    assert "'leaf'" in str(e.value)


def test_missing_chunk_raises(tmp_path, monkeypatch):
    from a3t_tpu_torch.compat import ocdbt

    path = tmp_path / "fill"
    _save(path, {"leaf": np.arange(4, dtype=np.int32)})
    monkeypatch.setattr(ocdbt.OcdbtStore, "__contains__",
                        lambda self, key: False)
    with pytest.raises(ValueError, match="no chunk"):
        restore_portable(str(path))


def test_version_tree_nodes(tmp_path):
    """A store of 41 versions at version-tree arity 4 keeps 40 of them in
    version-tree nodes (heights 2 and 1) and the newest inline; with the
    inline version taken out of its manifest (rewritten uncompressed, with
    its CRC-32C) the reader descends the nodes to generation 40, whose keys
    and values equal tensorstore's at that version."""
    import google_crc32c

    from a3t_tpu_torch.compat import ocdbt, zstd

    base = tmp_path / "versions"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{base}/",
                          "config": {"version_tree_arity_log2": 2}}).result()
    for i in range(40):
        kv.write(b"k%02d" % i, b"value %d" % i).result()
    assert OcdbtStore(str(base)).generation == 41
    ref = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{base}/",
                           "version": 40}).result()
    want = {k: ref.read(k).result().value for k in ref.list().result()}
    assert len(want) == 39
    manifest = base / "manifest.ocdbt"
    blob = manifest.read_bytes()
    body = ocdbt._frame(blob, ocdbt.MANIFEST_MAGIC, "manifest", 1 << 20)
    r = ocdbt._Reader(body, "manifest")
    r.raw(16)
    r.varints(3)
    r.raw(1)
    if r.varint() == 1:
        r.raw(4)
    ocdbt._data_files(r)
    start = r.pos
    assert len(ocdbt._versions(r, [""] * 8)) == 1
    refs = r.pos
    nodes = ocdbt._version_refs(r, [""] * 8, None)
    assert [h for _, _, h in nodes] == [2, 1]
    body = body[:start] + b"\x00" + body[refs:]  # no inline version
    head = b"\x0c\xdb\x3a\x2a" + (len(body) + 18).to_bytes(8, "little") \
        + b"\x00\x00"
    crc = zstd.crc32c(head + body)
    assert crc == google_crc32c.value(head + body)
    manifest.write_bytes(head + body + crc.to_bytes(4, "little"))
    store = OcdbtStore(str(base))
    assert store.generation == 40 and store.version_heights == [1, 0]
    assert store.list() == sorted(want)
    for k, v in want.items():
        assert store.read(k) == v
