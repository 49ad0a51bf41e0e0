"""Packed record shards: the port of ``a3t_tpu/data/records.py``.

A prepared Kaldi-style data directory packs into a few large shard files
of raw little-endian int16 PCM, concatenated, beside one ``index.npz``
holding every utterance's shard, offset and length, token ids and
alignment seconds, and a ``meta.json``:

    python -m a3t_tpu_torch.bin.pack_records --data-dir dump/raw/tr_no_dev \
        --tokens exp/a3t/tokens.txt --out dump/records/tr_no_dev

The layout is the JAX package's, key for key, so shards packed by either
package read in the other.  :class:`RecordDataset` offers the interface the
bucket batcher reads (``uids``, ``num_samples``, ``num_phones``,
``get_meta``, ``__getitem__``) over memory-mapped shards, ``get_pcm16``
for int16 batches without a float round trip, and ``global_offset`` /
``flat_pcm`` for the corpus on the card (``BatcherConfig.device_audio``:
the flat corpus is uploaded once and each batch's audio is gathered there
by ``train_step.gather_audio``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_INDEX = "index.npz"
_META = "meta.json"


def pack_records(dataset, out_dir: str, shard_mb: int = 512) -> str:
    """Pack an :class:`~a3t_tpu_torch.data.dataset.A3TDataset` (or anything
    with its interface) into shards of at most ``shard_mb`` MiB under
    ``out_dir``; returns ``out_dir``.  Mixed sample rates raise."""
    os.makedirs(out_dir, exist_ok=True)
    shard_samples = shard_mb * 1024 * 1024 // 2  # int16
    uids, shard_ids, offsets, n_samples = [], [], [], []
    text_offsets = [0]
    phone_ids: list[np.ndarray] = []
    starts: list[np.ndarray] = []
    ends: list[np.ndarray] = []
    phones_lines, speakers = [], []
    shard_idx = cur_len = 0
    fs = None

    def open_shard(i):
        return open(os.path.join(out_dir, f"shard_{i:05d}.bin"), "wb")

    cur = open_shard(0)
    try:
        for uid in dataset.uids:
            item = dataset[uid]
            # round-to-nearest x32768, the /32768 decode's inverse:
            # PCM16-sourced audio keeps its int16 codes through the pack
            pcm = np.clip(np.rint(item["audio"] * 32768.0), -32768,
                          32767).astype("<i2")
            if fs is None:
                fs = int(item["fs"])
            elif int(item["fs"]) != fs:
                raise ValueError(f"mixed sample rates: {item['fs']} vs {fs}")
            if cur_len + len(pcm) > shard_samples and cur_len > 0:
                cur.close()
                shard_idx += 1
                cur = open_shard(shard_idx)
                cur_len = 0
            uids.append(uid)
            shard_ids.append(shard_idx)
            offsets.append(cur_len)
            n_samples.append(len(pcm))
            cur.write(pcm.tobytes())
            cur_len += len(pcm)
            if "text_ids" in item:
                phone_ids.append(np.asarray(item["text_ids"], np.int32))
                starts.append(np.asarray(item["align_start_sec"], np.float32))
                ends.append(np.asarray(item["align_end_sec"], np.float32))
                phones_lines.append(f"{uid} {' '.join(item['phones'])}")
                text_offsets.append(text_offsets[-1] + len(phone_ids[-1]))
            else:
                text_offsets.append(text_offsets[-1])
            speakers.append(item.get("speaker", ""))
    finally:
        cur.close()

    def cat(parts, dtype):
        return np.concatenate(parts) if parts else np.zeros(0, dtype)

    np.savez(
        os.path.join(out_dir, _INDEX),
        uids=np.asarray(uids),
        shard=np.asarray(shard_ids, np.int32),
        offset=np.asarray(offsets, np.int64),
        n_samples=np.asarray(n_samples, np.int64),
        text_offsets=np.asarray(text_offsets, np.int64),
        phone_ids=cat(phone_ids, np.int32),
        starts=cat(starts, np.float32),
        ends=cat(ends, np.float32),
        speakers=np.asarray(speakers),
    )
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump({"fs": fs, "n_shards": shard_idx + 1,
                   "n_utts": len(uids)}, f)
    if phones_lines:
        with open(os.path.join(out_dir, "text"), "w") as f:
            f.write("\n".join(phones_lines) + "\n")
    return out_dir


class RecordDataset:
    """The batcher's dataset interface over packed shards: audio reads are
    slices of memory-mapped shards, the metadata lives in memory from one
    npz load.  ``speech_only=True`` ignores the phones (``num_phones`` 0),
    as :class:`~a3t_tpu_torch.data.dataset.A3TDataset` does."""

    def __init__(self, record_dir: str, speech_only: bool = False):
        self.record_dir = record_dir
        self.speech_only = speech_only
        with open(os.path.join(record_dir, _META)) as f:
            meta = json.load(f)
        self.fs = int(meta["fs"])
        with np.load(os.path.join(record_dir, _INDEX),
                     allow_pickle=False) as idx:
            self.uids = [str(u) for u in idx["uids"]]
            self._shard = idx["shard"]
            self._offset = idx["offset"]
            self._n = idx["n_samples"]
            self._text_off = idx["text_offsets"]
            self._phone_ids = idx["phone_ids"]
            self._starts = idx["starts"]
            self._ends = idx["ends"]
            self._speakers = [str(s) for s in idx["speakers"]]
        self._pos = {u: i for i, u in enumerate(self.uids)}
        self._mm = [
            np.memmap(os.path.join(record_dir, f"shard_{i:05d}.bin"),
                      dtype="<i2", mode="r")
            for i in range(int(meta["n_shards"]))]
        # each shard's first sample in the flat corpus (flat_pcm)
        self._shard_base = np.concatenate(
            [[0], np.cumsum([len(m) for m in self._mm])[:-1]]).astype(
            np.int64)
        self._phones: Optional[dict] = None  # uid -> phones, read lazily

    def __len__(self):
        return len(self.uids)

    def num_samples(self, uid: str) -> int:
        return int(self._n[self._pos[uid]])

    def num_phones(self, uid: str) -> int:
        if self.speech_only:
            return 0
        i = self._pos[uid]
        return int(self._text_off[i + 1] - self._text_off[i])

    def get_meta(self, uid: str) -> dict:
        """Everything except the audio."""
        i = self._pos[uid]
        out = {"uid": uid}
        if not self.speech_only:
            lo, hi = int(self._text_off[i]), int(self._text_off[i + 1])
            out["text_ids"] = self._phone_ids[lo:hi]
            out["align_start_sec"] = self._starts[lo:hi]
            out["align_end_sec"] = self._ends[lo:hi]
            if self._phones is None:
                self._load_phones()
            if uid in self._phones:
                out["phones"] = self._phones[uid]
        if self._speakers[i]:
            out["speaker"] = self._speakers[i]
        return out

    def get_pcm16(self, uid: str) -> np.ndarray:
        """The utterance's int16 PCM, a view into its shard's memmap."""
        i = self._pos[uid]
        lo = int(self._offset[i])
        return self._mm[int(self._shard[i])][lo: lo + int(self._n[i])]

    def global_offset(self, uid: str) -> int:
        """The utterance's first sample in the flat corpus."""
        i = self._pos[uid]
        return int(self._shard_base[int(self._shard[i])] + self._offset[i])

    def flat_pcm(self, pad_samples: int = 0) -> np.ndarray:
        """The whole corpus as one int16 array followed by ``pad_samples``
        zeros, so that the last utterance's gather window stays inside it.
        The batches' int32 offsets need fewer than 2**31 samples in all
        (~37 h at 16 kHz); a larger corpus raises."""
        total = int(sum(len(m) for m in self._mm)) + int(pad_samples)
        if total >= 2 ** 31:
            raise ValueError(
                f"flat corpus of {total} samples overflows int32 offsets; "
                "split the record dir into multiple corpora")
        out = np.zeros(total, np.int16)
        pos = 0
        for m in self._mm:
            out[pos: pos + len(m)] = m[:]
            pos += len(m)
        return out

    def __getitem__(self, uid: str) -> dict:
        out = self.get_meta(uid)
        out["fs"] = self.fs
        out["audio"] = self.get_pcm16(uid).astype(np.float32) / 32768.0
        return out

    def _load_phones(self):
        self._phones = {}
        path = os.path.join(self.record_dir, "text")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    uid, _, rest = line.rstrip("\n").partition(" ")
                    self._phones[uid] = rest.split()
