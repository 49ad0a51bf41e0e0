"""Miniature corpus generator: a copy of ``a3t_tpu/data/miniature.py``.

Given the same arguments it writes the same files as the JAX package's.

The reference CI trains on a bundled seconds-long corpus
(egs2/mini_an4, ci/test_integration_espnet2.sh:18-62).  This module writes
an equivalent tiny Kaldi-style data directory from synthesized audio:
harmonic "vowels" with known phone boundaries, so forced alignments are
exact by construction.
"""

from __future__ import annotations

import os

import numpy as np

from a3t_tpu_torch.data.fileio import (write_2column_text,
                                      write_num_sequence_text, write_wav)

PHONES = ["AA", "IY", "UW", "EH", "OW", "AH", "EY", "AO"]


def generate_mini_corpus(
    out_dir: str,
    n_utts: int = 12,
    fs: int = 8000,
    n_phones_range: tuple[int, int] = (4, 9),
    phone_dur_range: tuple[float, float] = (0.08, 0.25),
    seed: int = 0,
) -> str:
    """Write wav.scp/text/mfa_start/mfa_end/utt2spk under ``out_dir``."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)

    formants = {p: 200.0 + 60.0 * i for i, p in enumerate(PHONES)}

    wav_scp, text, utt2spk = {}, {}, {}
    starts, ends = {}, {}
    for i in range(n_utts):
        uid = f"utt{i:03d}"
        n_ph = int(rng.integers(*n_phones_range))
        phs = [PHONES[int(k)] for k in rng.integers(0, len(PHONES), n_ph)]
        durs = rng.uniform(*phone_dur_range, n_ph)
        bounds = np.concatenate([[0.0], np.cumsum(durs)])

        total = int(bounds[-1] * fs) + 1
        t = np.arange(total) / fs
        wav = np.zeros(total, np.float32)
        for j, p in enumerate(phs):
            s, e = int(bounds[j] * fs), int(bounds[j + 1] * fs)
            f0 = formants[p]
            seg_t = t[s:e]
            wav[s:e] = 0.4 * np.sin(2 * np.pi * f0 * seg_t) + 0.1 * np.sin(
                2 * np.pi * 2.5 * f0 * seg_t
            )
        wav += 0.01 * rng.standard_normal(total).astype(np.float32)

        path = os.path.join(wav_dir, f"{uid}.wav")
        write_wav(path, fs, wav)
        wav_scp[uid] = path
        text[uid] = " ".join(phs)
        starts[uid] = np.round(bounds[:-1], 4)
        ends[uid] = np.round(bounds[1:], 4)
        utt2spk[uid] = f"spk{i % 3}"

    write_2column_text(os.path.join(out_dir, "wav.scp"), wav_scp)
    write_2column_text(os.path.join(out_dir, "text"), text)
    write_num_sequence_text(os.path.join(out_dir, "mfa_start"), starts)
    write_num_sequence_text(os.path.join(out_dir, "mfa_end"), ends)
    write_2column_text(os.path.join(out_dir, "utt2spk"), utt2spk)
    return out_dir


# --- speech-like corpus (formant synthesis) ---------------------------------
#
# Richer fixture for quality soaks: multi-speaker utterances whose phones
# have speech-like spectra (formant-filtered harmonics for voiced sounds,
# band-shaped noise for fricatives, closure+burst for stops), with an F0
# declination contour per utterance and per-speaker F0/vocal-tract scaling.
# The phone -> spectral-envelope mapping is deterministic given the speaker,
# so masked-span reconstruction has real structure to learn, while oracle
# boundaries stay exact by construction (aligner ground truth).

# (F1, F2, F3) targets in Hz, male-reference values.
_VOWELS = {
    "AA": (730, 1090, 2440), "IY": (270, 2290, 3010), "UW": (300, 870, 2240),
    "EH": (530, 1840, 2480), "OW": (570, 840, 2410), "AH": (640, 1190, 2390),
    "AE": (660, 1720, 2410), "AO": (570, 840, 2410), "ER": (490, 1350, 1690),
    "IH": (390, 1990, 2550),
}
_NASALS = {"M": (250, 1000, 2200), "N": (250, 1700, 2600)}
# (low, high) noise band in Hz
_FRICATIVES = {"S": (4000, 7800), "SH": (2000, 5500), "F": (1000, 7800),
               "HH": (500, 3000)}
_STOPS = {"T": (3000, 7000), "K": (1500, 4000), "P": (500, 2500)}

SPEECHLIKE_PHONES = (
    list(_VOWELS) + list(_NASALS) + list(_FRICATIVES) + list(_STOPS))


def _formant_envelope(freqs, formants, scale):
    """Spectral envelope: Gaussian formant bumps + 1/f tilt."""
    env = np.zeros_like(freqs)
    for amp, bw, f in zip((1.0, 0.6, 0.3), (90.0, 140.0, 220.0), formants):
        fc = f * scale
        env += amp * np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
    tilt = 1.0 / np.maximum(freqs / 500.0, 1.0)
    return (env + 1e-3) * tilt


def _voiced_segment(f0, fs, formants, scale):
    """Additive harmonics with formant-shaped amplitudes; f0 is per-sample."""
    phase0 = 2.0 * np.pi * np.cumsum(f0) / fs
    nyq = min(fs / 2.0 - 200.0, 5000.0)
    n_harm = max(int(nyq / max(float(f0.mean()), 1.0)), 1)
    k = np.arange(1, n_harm + 1, dtype=np.float32)
    amps = _formant_envelope(k * float(f0.mean()), formants, scale)
    wav = (np.sin(np.outer(k, phase0)) * amps[:, None]).sum(axis=0)
    return wav.astype(np.float32) / (np.abs(wav).max() + 1e-6)


def _noise_segment(band, fs, n, rng, scale):
    """FFT band-shaped white noise."""
    x = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    lo, hi = band[0] * scale, min(band[1] * scale, fs / 2.0 - 100.0)
    gain = np.exp(-0.5 * ((freqs - (lo + hi) / 2) / ((hi - lo) / 2.5)) ** 2)
    y = np.fft.irfft(spec * gain, n).astype(np.float32)
    return y / (np.abs(y).max() + 1e-6)


def generate_speechlike_corpus(
    out_dir: str,
    n_utts: int = 200,
    n_speakers: int = 8,
    fs: int = 16000,
    n_phones_range: tuple[int, int] = (8, 24),
    phone_dur_range: tuple[float, float] = (0.06, 0.22),
    seed: int = 0,
    speaker_seed: int | None = None,
) -> str:
    """Write a formant-synthesized multi-speaker data dir (same layout as
    ``generate_mini_corpus``: wav.scp/text/mfa_start/mfa_end/utt2spk).

    ``speaker_seed`` derives the per-speaker F0/vocal-tract parameters
    independently of the utterance stream, so a held-out split can share
    the training speaker pool (same speaker_seed, different seed) or use
    entirely unseen speakers (different speaker_seed) — the two halves of
    the reference's seen+unseen MCD protocol (sedit_mcd.py:58-75).
    Defaults to ``seed`` (legacy behavior: speakers follow the corpus
    seed)."""
    rng = np.random.default_rng(seed)
    spk_rng = np.random.default_rng(
        seed if speaker_seed is None else speaker_seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)

    spk_f0 = spk_rng.uniform(85.0, 235.0, n_speakers)
    spk_scale = spk_rng.uniform(0.85, 1.2, n_speakers)

    wav_scp, text, utt2spk = {}, {}, {}
    starts, ends = {}, {}
    for i in range(n_utts):
        uid = f"utt{i:05d}"
        spk = int(rng.integers(0, n_speakers))
        n_ph = int(rng.integers(*n_phones_range))
        phs = [SPEECHLIKE_PHONES[int(j)]
               for j in rng.integers(0, len(SPEECHLIKE_PHONES), n_ph)]
        durs = rng.uniform(*phone_dur_range, n_ph)
        bounds = np.concatenate([[0.0], np.cumsum(durs)])
        total = int(bounds[-1] * fs) + 1

        # F0 declination + smooth random walk, per-sample
        decl = np.linspace(1.08, 0.88, total)
        walk = np.cumsum(rng.standard_normal(total // 400 + 2)) * 0.015
        walk = np.interp(np.linspace(0, 1, total),
                         np.linspace(0, 1, walk.size), walk)
        f0_track = spk_f0[spk] * decl * np.exp(walk)

        wav = np.zeros(total, np.float32)
        for j, p in enumerate(phs):
            s, e = int(bounds[j] * fs), int(bounds[j + 1] * fs)
            n = e - s
            if n <= 0:
                continue
            if p in _VOWELS or p in _NASALS:
                fmts = _VOWELS.get(p) or _NASALS[p]
                seg = _voiced_segment(f0_track[s:e], fs, fmts,
                                      spk_scale[spk])
                if p in _NASALS:  # damp above F1: nasal murmur
                    seg = 0.6 * seg + 0.4 * _voiced_segment(
                        f0_track[s:e], fs, (fmts[0], fmts[0], fmts[0]),
                        spk_scale[spk])
                amp = 0.35
            elif p in _FRICATIVES:
                seg = _noise_segment(_FRICATIVES[p], fs, n, rng,
                                     spk_scale[spk])
                amp = 0.18
            else:  # stop: closure silence then burst
                seg = np.zeros(n, np.float32)
                burst = max(int(n * 0.4), 1)
                seg[-burst:] = _noise_segment(_STOPS[p], fs, burst, rng,
                                              spk_scale[spk])
                amp = 0.25
            # 8 ms raised-cosine edges to avoid clicks
            ramp = min(int(0.008 * fs), n // 2)
            if ramp > 0:
                win = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
                seg[:ramp] *= win
                seg[-ramp:] *= win[::-1]
            wav[s:e] = amp * seg
        wav += 0.004 * rng.standard_normal(total).astype(np.float32)

        path = os.path.join(wav_dir, f"{uid}.wav")
        write_wav(path, fs, wav)
        wav_scp[uid] = path
        text[uid] = " ".join(phs)
        starts[uid] = np.round(bounds[:-1], 4)
        ends[uid] = np.round(bounds[1:], 4)
        utt2spk[uid] = f"spk{spk}"

    write_2column_text(os.path.join(out_dir, "wav.scp"), wav_scp)
    write_2column_text(os.path.join(out_dir, "text"), text)
    write_num_sequence_text(os.path.join(out_dir, "mfa_start"), starts)
    write_num_sequence_text(os.path.join(out_dir, "mfa_end"), ends)
    write_2column_text(os.path.join(out_dir, "utt2spk"), utt2spk)
    return out_dir
