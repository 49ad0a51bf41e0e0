"""Kaldi-style data-directory IO: a copy of ``a3t_tpu/data/fileio.py``.

The files a data directory holds (egs2/vctk/sedit/, dump/raw/{set}/):

* ``wav.scp``       — ``uttid /path/to/file.wav`` (sound)
* ``text``          — ``uttid PHN1 PHN2 ...``
* ``mfa_start``     — ``uttid 0.12 0.31 ...`` (seconds per phone)
* ``mfa_end``       — same
* ``utt2spk``       — ``uttid spk``
* ``feats.scp``-style npy pointers (npy)

WAV is read with scipy.  FLAC is dispatched on the container magic, so scp
entries may mix formats: mono files read as float go through the native
decoder (``native/loader/flac.cc`` by way of
:mod:`a3t_tpu_torch.data.native_loader`), multi-channel files and integer
reads through the port's Python codec (:mod:`a3t_tpu_torch.data.flac`).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def read_2column_text(path: str) -> dict[str, str]:
    """uttid<space>rest-of-line -> {uttid: rest} (fileio/read_text.py:10)."""
    out: dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(maxsplit=1)
            if not parts:
                continue
            out[parts[0]] = parts[1] if len(parts) == 2 else ""
    return out


def load_num_sequence_text(path: str, dtype=np.float32) -> dict[str, np.ndarray]:
    """uttid v1 v2 ... -> {uttid: array} (fileio/read_text.py:38)."""
    return {k: np.asarray([float(x) for x in v.replace(",", " ").split()],
                          dtype=dtype)
            for k, v in read_2column_text(path).items()}


def write_num_sequence_text(path: str, data: dict[str, np.ndarray]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for k in sorted(data):
            vals = " ".join(str(x) for x in np.asarray(data[k]).tolist())
            f.write(f"{k} {vals}\n")


def write_2column_text(path: str, data: dict[str, str]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for k in sorted(data):
            f.write(f"{k} {data[k]}\n")


def flac_channels(path: str) -> int:
    """A FLAC file's channel count from its STREAMINFO block (0 when the
    first metadata block is not STREAMINFO)."""
    with open(path, "rb") as f:
        head = f.read(21)
    if len(head) < 21 or (head[4] & 0x7F) != 0:
        return 0
    return ((head[20] >> 1) & 0x07) + 1


def read_wav(path: str, always_float: bool = True) -> tuple[int, np.ndarray]:
    """Read a PCM/float WAV or a FLAC; returns (fs, float32 in [-1, 1]), or
    the file's own integer samples with ``always_float=False``.  A
    multi-channel FLAC comes back as (n, ch), for ``to_mono`` to downmix.

    Mono FLAC read as float goes to the native decoder, which emits channel
    0 only; other FLAC goes to the Python decoder, as in JAX's ``read_wav``
    (``a3t_tpu/data/fileio.py:70``).  One difference: where the native
    decoder fails on a mono file, this raises, while JAX's tries the Python
    decoder next; a broken build or a file that decoder rejects is not
    hidden here.
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        if always_float and flac_channels(path) == 1:
            from a3t_tpu_torch.data.native_loader import read_file

            return read_file(path)
        from a3t_tpu_torch.data.flac import read_flac

        fs, data, bps = read_flac(path)
        if always_float:
            data = data.astype(np.float32) / float(1 << (bps - 1))
        return fs, data

    from scipy.io import wavfile

    fs, data = wavfile.read(path)
    if always_float and data.dtype.kind == "i":
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max + 1)
    elif always_float and data.dtype.kind == "u":  # uint8 wav
        data = (data.astype(np.float32) - 128.0) / 128.0
    elif data.dtype != np.float32:
        data = data.astype(np.float32)
    return int(fs), data


def write_wav(path: str, fs: int, data: np.ndarray, pcm16: bool = True):
    from scipy.io import wavfile

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if pcm16:
        clipped = np.clip(np.asarray(data), -1.0, 1.0)
        wavfile.write(path, fs, (clipped * 32767.0).astype(np.int16))
    else:
        wavfile.write(path, fs, np.asarray(data, np.float32))


class SoundScpReader:
    """wav.scp reader: reader[uttid] -> (fs, float32 waveform)."""

    def __init__(self, path: str):
        self.data = read_2column_text(path)

    def __getitem__(self, key: str) -> tuple[int, np.ndarray]:
        return read_wav(self.data[key])

    def __contains__(self, key):
        return key in self.data

    def __len__(self):
        return len(self.data)

    def keys(self) -> Iterator[str]:
        return iter(self.data)


class NpyScpReader:
    """scp of .npy paths: reader[uttid] -> ndarray."""

    def __init__(self, path: str):
        self.data = read_2column_text(path)

    def __getitem__(self, key: str) -> np.ndarray:
        return np.load(self.data[key])

    def __contains__(self, key):
        return key in self.data

    def __len__(self):
        return len(self.data)

    def keys(self) -> Iterator[str]:
        return iter(self.data)
