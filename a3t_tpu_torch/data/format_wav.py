"""Audio formatting: resample and PCM-normalize a data directory (recipe
stage 2): the port of ``a3t_tpu/data/format_wav.py``.

The reference pipeline formats all audio before anything else touches it:
``mlm.sh`` stage 2 runs ``format_wav_scp.sh`` (egs2/vctk/sedit/mlm.sh:294),
which shells out to sox/flac to convert every source file to single-channel
PCM at the recipe's sample rate (``run.sh:11`` sets fs=24000 over the
48 kHz VCTK source).  Skipping it silently breaks every downstream stage:
the front-end's mel filterbank, the seconds-to-frames alignment conversion
and the vocoder all assume the configured fs.

Resampling is polyphase (``scipy.signal.resample_poly``, the algorithm
family sox uses) on the host at prep time.  FLAC goes through the port's
own codec (:mod:`a3t_tpu_torch.data.flac`), both for reading sources and as
the formatted output's storage (``audio_format="flac"``, the reference's
default); other containers need the optional ``soundfile`` package.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Optional

import numpy as np

from a3t_tpu_torch.data.fileio import (read_2column_text, read_wav,
                                       write_2column_text, write_wav)


def read_audio(path: str) -> tuple[int, np.ndarray]:
    """Read .wav (scipy) or .flac (the port's codec); multi-channel data
    comes back as (n, ch) so :func:`to_mono` can downmix."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".wav", ".flac"):
        return read_wav(path)  # dispatches on the container magic
    try:
        import soundfile  # optional: only where libsndfile is installed
    except ImportError as e:
        raise RuntimeError(
            f"{path}: {ext} audio needs libsndfile/soundfile, which this "
            "environment does not provide — convert to PCM WAV or FLAC "
            "upstream (the reference recipe's format_wav_scp.sh sox stage)"
        ) from e
    data, fs = soundfile.read(path, dtype="float32")
    return int(fs), np.asarray(data, np.float32)


def to_mono(wav: np.ndarray) -> np.ndarray:
    """Average channels (sox remix semantics)."""
    if wav.ndim == 2:
        return wav.mean(axis=1)
    return wav


def resample(wav: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Polyphase resampling fs_in -> fs_out (sox rate analogue)."""
    if fs_in == fs_out:
        return np.asarray(wav, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(fs_in, fs_out)
    out = resample_poly(np.asarray(wav, np.float64), fs_out // g, fs_in // g)
    return np.asarray(out, np.float32)


def format_data_dir(
    data_dir: str,
    out_dir: str,
    fs: int,
    wav_subdir: str = "formatted_wav",
    expected_source_fs: Optional[int] = None,
    audio_format: str = "wav",
) -> dict:
    """Format every utterance of a Kaldi-style data dir to mono PCM16 at fs.

    Copies ``text``/``utt2spk``/``spk2utt``/``mfa_*`` through unchanged
    (alignment times are in seconds, invariant under resampling) and
    rewrites ``wav.scp`` to the converted files.  ``audio_format`` selects
    wav or flac output.  Returns a report: the utterance count, the target
    fs and the count of sources at each fs.
    """
    if audio_format not in ("wav", "flac"):
        raise ValueError(f"audio_format {audio_format!r} (want wav|flac)")
    wav_dir = os.path.join(out_dir, wav_subdir)
    os.makedirs(wav_dir, exist_ok=True)

    scp = read_2column_text(os.path.join(data_dir, "wav.scp"))
    new_scp, fs_seen = {}, {}
    for uid, path in scp.items():
        fs_in, wav = read_audio(path)
        if expected_source_fs is not None and fs_in != expected_source_fs:
            raise ValueError(
                f"{uid}: source fs {fs_in} != expected {expected_source_fs}")
        fs_seen[fs_in] = fs_seen.get(fs_in, 0) + 1
        wav = resample(to_mono(wav), fs_in, fs)
        out_path = os.path.join(wav_dir, f"{uid}.{audio_format}")
        if audio_format == "flac":
            from a3t_tpu_torch.data.flac import write_flac

            write_flac(out_path, fs, wav)
        else:
            write_wav(out_path, fs, wav)
        new_scp[uid] = out_path
    write_2column_text(os.path.join(out_dir, "wav.scp"), new_scp)

    for name in ("text", "utt2spk", "spk2utt", "mfa_text", "mfa_start",
                 "mfa_end"):
        src = os.path.join(data_dir, name)
        if os.path.exists(src) and os.path.abspath(src) != os.path.abspath(
                os.path.join(out_dir, name)):
            shutil.copyfile(src, os.path.join(out_dir, name))

    return {"n_utts": len(new_scp), "target_fs": fs,
            "source_fs_counts": fs_seen}


def validate_data_dir_fs(data_dir: str, fs: int, n_check: int = 5):
    """Spot-check that a data dir's audio matches the configured fs: a
    48 kHz prep consumed by a 24 kHz training config would silently halve
    every alignment-derived frame index."""
    scp = read_2column_text(os.path.join(data_dir, "wav.scp"))
    for uid in list(scp)[:n_check]:
        fs_found, _ = read_audio(scp[uid])
        if fs_found != fs:
            raise ValueError(
                f"{data_dir}: utt {uid} has fs {fs_found} but the config "
                f"expects {fs} — run a3t_tpu_torch.bin.format_data first")
