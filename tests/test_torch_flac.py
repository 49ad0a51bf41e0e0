"""The port's FLAC codec (a3t_tpu_torch/data/flac.py) and read_wav's FLAC
routing (a3t_tpu_torch/data/fileio.py) against the JAX package's
(a3t_tpu/data/flac.py, a3t_tpu/data/fileio.py).  Inputs from numpy with a
seed.

Every comparison is exact: the port's encoder is a copy of JAX's, so the
same input gives the same bytes, and both decoders return integers (or the
same integers scaled by one power of two).
"""

import os

import numpy as np
import pytest

from a3t_tpu.data import fileio as jax_fileio
from a3t_tpu.data import flac as jax_flac
from a3t_tpu_torch.data import fileio, flac


def _speechlike(rng, n):
    t = np.arange(n)
    x = (6000 * np.sin(t * 0.021) + 900 * np.sin(t * 0.37)
         + rng.normal(0, 60, n))
    return np.clip(x, -32768, 32767).astype(np.int16)


def _stereo(rng):
    x = _speechlike(rng, 6007)
    st = np.stack([x, np.roll(x, 2) + rng.integers(-40, 40, len(x))], 1)
    return np.clip(st, -32768, 32767).astype(np.int16)


# name -> (data from a seeded rng, write_flac keywords)
CASES = {
    "mono": (lambda r: _speechlike(r, 20011), {}),
    "mono-22050": (lambda r: _speechlike(r, 3000), {"fs": 22050}),
    **{f"stereo-{m}": (_stereo, {"stereo_mode": m})
       for m in ("independent", "left_side", "right_side", "mid_side",
                 "auto")},
    "24bit": (lambda r: r.integers(-(1 << 23), 1 << 23, 4099)
              .astype(np.int32), {"bps": 24}),
    "constant": (lambda r: np.concatenate(
        [np.full(4096, 77, np.int16), np.zeros(4096, np.int16),
         np.full(33, -9, np.int16)]), {}),
    "noise-verbatim": (lambda r: r.integers(-32768, 32768, 3001)
                       .astype(np.int16), {}),
    "wasted-bits": (lambda r: (r.integers(-1024, 1024, 4096) * 32)
                    .astype(np.int16), {}),
    "partition-order-4": (lambda r: (1200 * np.sin(np.arange(8192) * 0.04))
                          .astype(np.int16), {"partition_order": 4}),
    "fixed-only": (lambda r: (1200 * np.sin(np.arange(8192) * 0.04))
                   .astype(np.int16), {"lpc_order": 0}),
    "small-blocks": (lambda r: r.integers(-300, 300, 16 * 140)
                     .astype(np.int16), {"block_size": 16}),
    "float": (lambda r: r.uniform(-0.99, 0.99, 2000).astype(np.float32), {}),
    "float-stereo": (lambda r: r.uniform(-0.5, 0.5, (3001, 2))
                     .astype(np.float32), {}),
}


def _write_both(tmp_path, name, seed=0):
    make, kw = CASES[name]
    kw = dict(kw)
    fs = kw.pop("fs", 16000)
    data = make(np.random.default_rng(seed))
    ours, theirs = str(tmp_path / "port.flac"), str(tmp_path / "jax.flac")
    flac.write_flac(ours, fs, data, **kw)
    jax_flac.write_flac(theirs, fs, data, **kw)
    return ours, theirs, fs, data


@pytest.mark.parametrize("name", sorted(CASES))
def test_write_flac_same_bytes_and_decode(tmp_path, name):
    """The same bytes as JAX's encoder; read_flac and probe_flac equal
    JAX's on them, and decode the input back."""
    ours, theirs, fs, data = _write_both(tmp_path, name)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got = flac.read_flac(ours)
    want = jax_flac.read_flac(ours)
    assert got[0] == want[0] == fs and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype
    if data.dtype.kind != "f":
        np.testing.assert_array_equal(got[1], data)
    assert flac.probe_flac(ours) == jax_flac.probe_flac(ours) \
        == (len(data), fs)
    assert flac.is_flac(ours) and not flac.is_flac(__file__)


@pytest.mark.parametrize("name,always_float", [
    ("mono", True), ("mono", False), ("stereo-auto", True),
    ("stereo-mid_side", False), ("24bit", True), ("24bit", False),
    ("float-stereo", True)])
def test_read_wav_routes_flac_as_jax(tmp_path, name, always_float):
    """read_wav on mono (the native decoder), stereo and integer FLAC equals
    JAX's read_wav: the same fs, shape, dtype and samples."""
    ours, _, fs, _ = _write_both(tmp_path, name)
    got_fs, got = fileio.read_wav(ours, always_float=always_float)
    want_fs, want = jax_fileio.read_wav(ours, always_float=always_float)
    assert got_fs == want_fs == fs
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_corrupt_flac_raises_in_both(tmp_path):
    """A flipped byte fails the CRC in both decoders; a file that is not
    FLAC is refused by both."""
    ours, _, _, _ = _write_both(tmp_path, "mono")
    buf = bytearray(open(ours, "rb").read())
    buf[len(buf) // 2] ^= 0x55
    for read in (flac.read_flac, jax_flac.read_flac):
        with pytest.raises(ValueError):
            read(bytes(buf))
        with pytest.raises(ValueError):
            read(b"RIFFnotflac")


def test_failed_native_decode_raises(tmp_path):
    """A mono FLAC that the native decoder rejects raises in the port's
    read_wav (no fallback to the Python decoder), while JAX's read_wav
    falls back to its Python decoder, which rejects it too."""
    ours, _, _, _ = _write_both(tmp_path, "mono")
    buf = bytearray(open(ours, "rb").read())
    buf[len(buf) // 2] ^= 0x55  # a frame's CRC fails
    bad = str(tmp_path / "bad.flac")
    with open(bad, "wb") as f:
        f.write(bytes(buf))
    with pytest.raises(IOError, match="native"):
        fileio.read_wav(bad)
    with pytest.raises(ValueError):
        jax_fileio.read_wav(bad)


def test_npy_scp_reader(tmp_path):
    """NpyScpReader equals JAX's item by item."""
    rng = np.random.default_rng(3)
    lines = []
    for i in range(3):
        p = str(tmp_path / f"u{i}.npy")
        np.save(p, rng.standard_normal((i + 2, 4)).astype(np.float32))
        lines.append(f"u{i} {p}\n")
    scp = str(tmp_path / "feats.scp")
    with open(scp, "w") as f:
        f.writelines(lines)
    ours, theirs = fileio.NpyScpReader(scp), jax_fileio.NpyScpReader(scp)
    assert list(ours.keys()) == list(theirs.keys()) and len(ours) == 3
    assert "u1" in ours and "x" not in ours
    for k in ours.keys():
        np.testing.assert_array_equal(ours[k], theirs[k])
