"""Key-addressed datasets over Kaldi-style data directories: the port of
``a3t_tpu/data/dataset.py``.

    <data_dir>/
        wav.scp       uttid -> wav path
        text          uttid -> "PHN1 PHN2 ..." (aligned phones)
        mfa_start     uttid -> "0.12 0.34 ..." (seconds per phone)
        mfa_end       uttid -> "0.34 0.55 ..."
        utt2spk       uttid -> speaker (optional)

:class:`A3TDataset` is purpose-built for the A3T task (audio + phones +
alignments); ``speech_only=True`` reads ``wav.scp`` alone (speech-only
pretraining corpora, the reference collate fn's branch without text,
collate_fn.py:222-231): no phones, ``num_phones`` 0.
:class:`NamedSourceDataset` covers the generic case of the reference's
ESPnetDataset (espnet2/train/dataset.py:273), over the loader types of
:data:`LOADERS`.
"""

from __future__ import annotations

import os
import wave
import zlib
from typing import Optional

import numpy as np

from a3t_tpu_torch.data.fileio import (NpyScpReader, SoundScpReader,
                                       load_num_sequence_text,
                                       read_2column_text)
from a3t_tpu_torch.text import TokenIDConverter


class _H5Reader:
    """uid-keyed HDF5 file (reference DATA_TYPES 'hdf5', dataset.py:137);
    h5py is imported when one is opened."""

    def __init__(self, path: str):
        import h5py

        self.f = h5py.File(path, "r")

    def keys(self):
        return self.f.keys()

    def __getitem__(self, uid: str) -> np.ndarray:
        return np.asarray(self.f[uid])

    def close(self):
        self.f.close()

    def __del__(self):
        try:
            self.f.close()
        except Exception:
            pass


class _RandFloatReader:
    """uid -> deterministic random float vector; the scp file maps
    uid -> length (reference DATA_TYPES 'rand_float': dummy inputs).  The
    seed is the uid's CRC-32, as in JAX, so both draw the same values."""

    def __init__(self, path: str):
        self.shapes = load_num_sequence_text(path, np.int64)

    def keys(self):
        return self.shapes.keys()

    def __getitem__(self, uid: str) -> np.ndarray:
        # stable across processes (builtin str hash is salted per interpreter)
        rng = np.random.default_rng(zlib.crc32(uid.encode()))
        return rng.standard_normal(tuple(self.shapes[uid])).astype(np.float32)


def _kaldi_ark_loader(path):
    from a3t_tpu_torch.data.kaldi_ark import KaldiArkReader

    return KaldiArkReader(path)


LOADERS = {
    "sound": SoundScpReader,
    "npy": NpyScpReader,
    "text": read_2column_text,
    "text_int": lambda p: load_num_sequence_text(p, np.int64),
    "text_float": lambda p: load_num_sequence_text(p, np.float32),
    "kaldi_ark": _kaldi_ark_loader,
    "hdf5": _H5Reader,
    "rand_float": _RandFloatReader,
}


class NamedSourceDataset:
    """Generic dataset: {name: (path, loader_type)} -> per-utt dict over the
    uids that every source holds."""

    def __init__(self, sources: dict[str, tuple[str, str]]):
        self.readers = {
            name: LOADERS[typ](path) for name, (path, typ) in sources.items()
        }
        keysets = [set(r.keys()) for r in self.readers.values()]
        self.uids = sorted(set.intersection(*keysets)) if keysets else []

    def __len__(self):
        return len(self.uids)

    def __getitem__(self, uid: str) -> dict:
        out = {}
        for name, reader in self.readers.items():
            v = reader[uid]
            if isinstance(v, tuple):  # sound -> (fs, wave)
                out[f"{name}_fs"], out[name] = v
            else:
                out[name] = v
        return out

    def close(self):
        for reader in self.readers.values():
            if hasattr(reader, "close"):
                reader.close()


class A3TDataset:
    """Utterances with audio, phones and alignments for masked
    reconstruction.  Utterances missing from any file, or whose phone and
    alignment counts differ, are dropped (the batch aligner filters these at
    prep, align_english.py:293-318); a speech-only dataset keeps every
    utterance of ``wav.scp``."""

    def __init__(
        self,
        data_dir: str,
        token_converter: Optional[TokenIDConverter] = None,
        speech_only: bool = False,
        wav_scp: str = "wav.scp",
        text_file: str = "text",
        start_file: str = "mfa_start",
        end_file: str = "mfa_end",
    ):
        self.data_dir = data_dir
        self.speech_only = speech_only
        self.tokens = token_converter
        self.wav = SoundScpReader(os.path.join(data_dir, wav_scp))
        keys = set(self.wav.keys())
        if not speech_only:
            self.text = read_2column_text(os.path.join(data_dir, text_file))
            self.start = load_num_sequence_text(
                os.path.join(data_dir, start_file), np.float32)
            self.end = load_num_sequence_text(
                os.path.join(data_dir, end_file), np.float32)
            keys &= set(self.text) & set(self.start) & set(self.end)
            keys = {
                k for k in keys
                if len(self.text[k].split()) == len(self.start[k])
                == len(self.end[k]) and len(self.start[k]) > 0
            }
        spk_path = os.path.join(data_dir, "utt2spk")
        self.utt2spk = (read_2column_text(spk_path)
                        if os.path.exists(spk_path) else {})
        self.uids = sorted(keys)

    def __len__(self):
        return len(self.uids)

    def get_meta(self, uid: str) -> dict:
        """Everything except the decoded audio (the native-loader path)."""
        out = {"uid": uid}
        if not self.speech_only:
            phones = self.text[uid].split()
            out["phones"] = phones
            if self.tokens is not None:
                out["text_ids"] = np.asarray(self.tokens.tokens2ids(phones),
                                             np.int32)
            out["align_start_sec"] = self.start[uid]
            out["align_end_sec"] = self.end[uid]
        if uid in self.utt2spk:
            out["speaker"] = self.utt2spk[uid]
        return out

    def __getitem__(self, uid: str) -> dict:
        fs, audio = self.wav[uid]
        return {**self.get_meta(uid), "fs": fs, "audio": audio}

    def num_samples(self, uid: str) -> int:
        """Sample count from the file's header (WAV or FLAC)."""
        path = self.wav.data[uid]
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == b"fLaC":
            from a3t_tpu_torch.data.native_loader import probe_file

            return probe_file(path)[0]
        with wave.open(path, "rb") as w:
            return w.getnframes()

    def num_phones(self, uid: str) -> int:
        return 0 if self.speech_only else len(self.start[uid])
