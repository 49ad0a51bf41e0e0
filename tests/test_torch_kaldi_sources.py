"""The port's Kaldi-ark reader and writer (a3t_tpu_torch/data/kaldi_ark.py)
and its named-source dataset (a3t_tpu_torch/data/dataset.py: the hdf5,
rand_float, kaldi_ark, npy, sound and text loaders) against the JAX
package's (a3t_tpu/data/kaldi_ark.py, a3t_tpu/data/dataset.py).  Inputs from
numpy with a seed.  Every comparison is exact: the same bytes on disk and
the same arrays, rand_float's draws included (both seed numpy's generator
with the uid's CRC-32).
"""

import numpy as np
import pytest

from a3t_tpu.data import dataset as jax_dataset
from a3t_tpu.data import kaldi_ark as jax_ark
from a3t_tpu_torch.data import dataset, kaldi_ark
from a3t_tpu_torch.data.fileio import (write_2column_text,
                                       write_num_sequence_text, write_wav)


def _mats(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "utt1": rng.standard_normal((1, 512)).astype(np.float32),
        "utt2": rng.standard_normal((3, 8)).astype(np.float32),
        "utt3": rng.standard_normal(16).astype(np.float32),  # a vector
        "utt4": rng.standard_normal((2, 5)),  # float64, written as float32
    }


def test_write_kaldi_ark_same_bytes(tmp_path):
    """The same ark bytes and scp offsets as JAX's writer; every entry reads
    back equal through both readers."""
    mats = _mats()
    ours, theirs = str(tmp_path / "a.ark"), str(tmp_path / "b.ark")
    scp = kaldi_ark.write_kaldi_ark(ours, mats)
    jscp = jax_ark.write_kaldi_ark(theirs, mats)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    assert {k: v.rsplit(":", 1)[1] for k, v in scp.items()} \
        == {k: v.rsplit(":", 1)[1] for k, v in jscp.items()}
    for uid, where in scp.items():
        got = kaldi_ark.read_kaldi_mat(where)
        want = jax_ark.read_kaldi_mat(where)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.float32(mats[uid]))


@pytest.mark.parametrize("token,dtype", [(b"DM", np.float64),
                                         (b"DV", np.float64),
                                         (b"FM", np.float32)])
def test_read_kaldi_mat_matches_jax(tmp_path, token, dtype):
    """Double-precision and matrix entries written by hand at an offset read
    the same in both; a bad header or token raises in both."""
    import struct

    rng = np.random.default_rng(1)
    arr = rng.standard_normal((4, 3) if token.endswith(b"M") else 7) \
        .astype(dtype)
    path = str(tmp_path / "x.ark")
    with open(path, "wb") as f:
        f.write(b"pad_bytes ")
        offset = f.tell()
        f.write(b"\x00B" + token + b" ")
        for n in arr.shape:
            f.write(b"\x04" + struct.pack("<i", n))
        f.write(arr.tobytes())
    got = kaldi_ark.read_kaldi_mat(f"{path}:{offset}")
    want = jax_ark.read_kaldi_mat(f"{path}:{offset}")
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)
    for read in (kaldi_ark.read_kaldi_mat, jax_ark.read_kaldi_mat):
        with pytest.raises(ValueError):
            read(f"{path}:0")


def test_spk2xvector_from_kaldi_matches_jax(tmp_path):
    """Per-speaker means equal JAX's bit for bit (an utterance without a
    speaker is its own)."""
    rng = np.random.default_rng(2)
    mats = {u: rng.standard_normal((1, 512)).astype(np.float32)
            for u in ("utt1", "utt2", "utt5")}
    mats["utt3"] = rng.standard_normal(16).astype(np.float32)
    path = str(tmp_path / "xvector.scp")
    write_2column_text(path, kaldi_ark.write_kaldi_ark(
        str(tmp_path / "x.ark"), mats))
    utt2spk = {"utt1": "spkA", "utt2": "spkB", "utt5": "spkA"}
    got = kaldi_ark.spk2xvector_from_kaldi(path, utt2spk)
    want = jax_ark.spk2xvector_from_kaldi(path, utt2spk)
    assert sorted(got) == sorted(want) == ["spkA", "spkB", "utt3"]
    for spk in got:
        assert got[spk].dtype == want[spk].dtype
        np.testing.assert_array_equal(got[spk], want[spk])
    reader = kaldi_ark.KaldiArkReader(path)
    assert list(reader.keys()) == list(jax_ark.KaldiArkReader(path).keys())
    assert len(reader) == 4


@pytest.fixture
def sources(tmp_path):
    """One directory of every loader type over uids u0-u3 (u3 missing from
    the hdf5 file, so the dataset holds u0-u2)."""
    import h5py

    d = tmp_path
    rng = np.random.default_rng(4)
    uids = ["u0", "u1", "u2", "u3"]
    mats = {u: rng.standard_normal((i + 2, 4)).astype(np.float32)
            for i, u in enumerate(uids)}
    write_2column_text(str(d / "feat.scp"),
                       kaldi_ark.write_kaldi_ark(str(d / "feat.ark"), mats))
    with h5py.File(d / "x.h5", "w") as f:
        for i, u in enumerate(uids[:3]):
            f[u] = rng.standard_normal(i + 3).astype(np.float32)
    write_2column_text(str(d / "rand.scp"),
                       {u: f"{i + 5}" for i, u in enumerate(uids)})
    write_2column_text(str(d / "rand2.scp"),
                       {u: f"{i + 2},3" for i, u in enumerate(uids)})
    npy = {}
    for u in uids:
        npy[u] = str(d / f"{u}.npy")
        np.save(npy[u], rng.standard_normal(6).astype(np.float32))
    write_2column_text(str(d / "npy.scp"), npy)
    wavs = {}
    for u in uids:
        wavs[u] = str(d / f"{u}.wav")
        write_wav(wavs[u], 16000, rng.uniform(-0.5, 0.5, 800))
    write_2column_text(str(d / "wav.scp"), wavs)
    write_2column_text(str(d / "text"), {u: f"A B {u}" for u in uids})
    write_num_sequence_text(str(d / "ints"),
                            {u: np.arange(i + 1) for i, u in enumerate(uids)})
    write_num_sequence_text(str(d / "floats"),
                            {u: rng.uniform(0, 1, 3) for u in uids})
    return {
        "feats": (str(d / "feat.scp"), "kaldi_ark"),
        "emb": (str(d / "x.h5"), "hdf5"),
        "noise": (str(d / "rand.scp"), "rand_float"),
        "noise2": (str(d / "rand2.scp"), "rand_float"),
        "vec": (str(d / "npy.scp"), "npy"),
        "speech": (str(d / "wav.scp"), "sound"),
        "text": (str(d / "text"), "text"),
        "ints": (str(d / "ints"), "text_int"),
        "floats": (str(d / "floats"), "text_float"),
    }


def test_named_source_dataset_matches_jax(sources):
    """NamedSourceDataset over every loader type equals JAX's item by item:
    the same uids (those every source holds), keys, dtypes and values."""
    assert sorted(dataset.LOADERS) == sorted(jax_dataset.LOADERS)
    ours = dataset.NamedSourceDataset(sources)
    theirs = jax_dataset.NamedSourceDataset(sources)
    try:
        assert ours.uids == theirs.uids == ["u0", "u1", "u2"]
        assert len(ours) == len(theirs) == 3
        for uid in ours.uids:
            got, want = ours[uid], theirs[uid]
            assert sorted(got) == sorted(want)
            assert got["speech_fs"] == want["speech_fs"] == 16000
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    assert got[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
                else:
                    assert got[k] == v, k
            assert got["noise"].shape == (int(uid[1]) + 5,)
            assert got["noise2"].shape == (int(uid[1]) + 2, 3)
            np.testing.assert_array_equal(got["noise"], ours[uid]["noise"])
    finally:
        ours.close()
        theirs.close()


def test_rand_float_draws_match_jax(tmp_path):
    """rand_float draws the same float32 values as JAX's for any uid: numpy's
    default generator seeded with the uid's CRC-32."""
    import zlib

    uids = ["utt_a", "spk1-0001", "x" * 40]
    write_2column_text(str(tmp_path / "r.scp"), {u: "17" for u in uids})
    ours = dataset._RandFloatReader(str(tmp_path / "r.scp"))
    theirs = jax_dataset._RandFloatReader(str(tmp_path / "r.scp"))
    for u in uids:
        want = np.random.default_rng(zlib.crc32(u.encode())) \
            .standard_normal(17).astype(np.float32)
        np.testing.assert_array_equal(ours[u], theirs[u])
        np.testing.assert_array_equal(ours[u], want)
