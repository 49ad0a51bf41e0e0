"""Minimal Kaldi binary ark/scp reader and writer (kaldiio replacement): a
copy of ``a3t_tpu/data/kaldi_ark.py``.

The reference reads per-utterance x-vectors from Kaldi ``xvector.scp``
(aggregate_output/generate_spk2xv.py via kaldiio).  This reader supports the
subset those files use: binary-mode FloatMatrix/FloatVector entries
addressed as ``path/to/file.ark:offset``.

Format per entry (after the scp offset): ``\\0B`` binary header, then
``FM``/``FV``/``DM``/``DV`` token, then for each dimension a
``\\x04 <int32>`` size, then raw row-major data.
"""

from __future__ import annotations

import struct

import numpy as np

from a3t_tpu_torch.data.fileio import read_2column_text


def _read_token(f) -> str:
    tok = b""
    while True:
        ch = f.read(1)
        if not ch or ch == b" ":
            break
        tok += ch
    return tok.decode()


def _read_int32(f) -> int:
    size_marker = f.read(1)
    if size_marker != b"\x04":
        raise ValueError(f"expected int32 marker, got {size_marker!r}")
    return struct.unpack("<i", f.read(4))[0]


def read_kaldi_mat(path_with_offset: str) -> np.ndarray:
    """'file.ark:1234' -> float32/float64 matrix or vector."""
    if ":" in path_with_offset:
        path, offset = path_with_offset.rsplit(":", 1)
        offset = int(offset)
    else:
        path, offset = path_with_offset, 0
    with open(path, "rb") as f:
        f.seek(offset)
        if f.read(2) != b"\x00B":
            raise ValueError(f"not a Kaldi binary entry at {path_with_offset}")
        token = _read_token(f)
        if token in ("FM", "DM"):
            dtype = np.float32 if token == "FM" else np.float64
            rows = _read_int32(f)
            cols = _read_int32(f)
            data = np.frombuffer(
                f.read(rows * cols * dtype().itemsize), dtype=dtype)
            return data.reshape(rows, cols).copy()
        if token in ("FV", "DV"):
            dtype = np.float32 if token == "FV" else np.float64
            n = _read_int32(f)
            return np.frombuffer(
                f.read(n * dtype().itemsize), dtype=dtype).copy()
        raise ValueError(f"unsupported Kaldi token {token!r}")


def write_kaldi_ark(path: str, data: dict[str, np.ndarray]) -> dict[str, str]:
    """Write a binary ark; returns {uid: 'path:offset'} for the scp."""
    scp = {}
    with open(path, "wb") as f:
        for uid in sorted(data):
            f.write(uid.encode() + b" ")
            scp[uid] = f"{path}:{f.tell()}"
            f.write(b"\x00B")
            arr = np.asarray(data[uid], np.float32)
            if arr.ndim == 2:
                f.write(b"FM ")
                f.write(b"\x04" + struct.pack("<i", arr.shape[0]))
                f.write(b"\x04" + struct.pack("<i", arr.shape[1]))
            else:
                f.write(b"FV ")
                f.write(b"\x04" + struct.pack("<i", arr.shape[0]))
            f.write(arr.tobytes())
    return scp


class KaldiArkReader:
    """xvector.scp-style reader: reader[uid] -> ndarray."""

    def __init__(self, scp_path: str):
        self.data = read_2column_text(scp_path)

    def __getitem__(self, uid: str) -> np.ndarray:
        return read_kaldi_mat(self.data[uid])

    def keys(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)


def spk2xvector_from_kaldi(scp_path: str, utt2spk: dict[str, str]) -> dict:
    """Collapse per-utt Kaldi x-vectors to per-speaker means
    (aggregate_output/generate_spk2xv.py:1-42)."""
    reader = KaldiArkReader(scp_path)
    sums: dict[str, np.ndarray] = {}
    counts: dict[str, int] = {}
    for uid in reader.keys():
        spk = utt2spk.get(uid, uid)
        v = np.asarray(reader[uid], np.float32).reshape(-1)
        if spk in sums:
            sums[spk] += v
            counts[spk] += 1
        else:
            sums[spk] = v.copy()
            counts[spk] = 1
    return {s: sums[s] / counts[s] for s in sums}
