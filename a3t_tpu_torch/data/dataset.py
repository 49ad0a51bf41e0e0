"""Audio + phones + forced alignments over a Kaldi-style data directory: the
port of ``a3t_tpu/data/dataset.py::A3TDataset`` (:123).

    <data_dir>/
        wav.scp       uttid -> wav path
        text          uttid -> "PHN1 PHN2 ..." (aligned phones)
        mfa_start     uttid -> "0.12 0.34 ..." (seconds per phone)
        mfa_end       uttid -> "0.34 0.55 ..."
        utt2spk       uttid -> speaker (optional)

``speech_only=True`` reads ``wav.scp`` alone (speech-only pretraining
corpora, the reference collate fn's branch without text,
collate_fn.py:222-231): no phones, ``num_phones`` 0.  The JAX module's
feature-source readers (HDF5, ``rand_float``, kaldi ark,
``NamedSourceDataset``) are not ported (ROADMAP A7-rest).
"""

from __future__ import annotations

import os
import wave
from typing import Optional

import numpy as np

from a3t_tpu_torch.data.fileio import (SoundScpReader, load_num_sequence_text,
                                       read_2column_text)
from a3t_tpu_torch.text import TokenIDConverter


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
