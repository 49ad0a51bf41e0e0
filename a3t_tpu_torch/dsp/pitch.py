"""Pitch (F0) and energy extraction for FastSpeech2 training targets: a
numpy copy of ``a3t_tpu/dsp/pitch.py``, so the port's FS2 batches equal the
JAX package's bit for bit.

The reference uses espnet2's Dio (WORLD) pitch and STFT energy extractors
with FastPitch-style token averaging (continuous values averaged over each
phone's frames).  pyworld is not in this image, so F0 comes from a
normalized-autocorrelation tracker (YIN-flavored) — accurate enough for
variance-adaptor targets — implemented in numpy; energy is the frame RMS of
the STFT magnitude.
"""

from __future__ import annotations

import numpy as np

from a3t_tpu_torch.dsp.stft import padded_window


def extract_f0(
    wav: np.ndarray,
    fs: int,
    hop_length: int,
    f0min: float = 80.0,
    f0max: float = 400.0,
    threshold: float = 0.3,
) -> np.ndarray:
    """(S,) waveform -> (F,) F0 in Hz (0 for unvoiced), F = 1 + S // hop."""
    wav = np.asarray(wav, np.float64)
    n_frames = 1 + len(wav) // hop_length
    win = int(fs / f0min * 2)
    lag_min = max(2, int(fs / f0max))
    lag_max = int(fs / f0min)
    pad = np.concatenate([np.zeros(win // 2), wav, np.zeros(win)])

    f0 = np.zeros(n_frames)
    for t in range(n_frames):
        seg = pad[t * hop_length: t * hop_length + win]
        seg = seg - seg.mean()
        energy = (seg**2).sum()
        if energy < 1e-8:
            continue
        # normalized autocorrelation via FFT
        spec = np.fft.rfft(seg, 2 * win)
        ac = np.fft.irfft(spec * np.conj(spec))[:lag_max + 1]
        ac = ac / (ac[0] + 1e-12)
        if lag_max <= lag_min:
            continue
        lag = lag_min + int(np.argmax(ac[lag_min: lag_max + 1]))
        if ac[lag] > threshold:
            # parabolic interpolation around the peak
            if 0 < lag < lag_max:
                a, b, c = ac[lag - 1], ac[lag], ac[lag + 1]
                denom = a - 2 * b + c
                shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
                lag = lag + np.clip(shift, -1, 1)
            f0[t] = fs / lag
    return f0.astype(np.float32)


def extract_energy(
    wav: np.ndarray, n_fft: int, hop_length: int, win_length: int
) -> np.ndarray:
    """(S,) -> (F,) frame RMS energy of the magnitude spectrum
    (espnet2 Energy feats_extract semantics)."""
    n_frames = 1 + len(wav) // hop_length
    pad = n_fft // 2
    x = np.pad(np.asarray(wav, np.float64), (pad, pad), mode="reflect")
    w = padded_window(n_fft, win_length, np.float64)
    out = np.zeros(n_frames)
    for t in range(n_frames):
        frame = x[t * hop_length: t * hop_length + n_fft] * w
        mag = np.abs(np.fft.rfft(frame))
        out[t] = np.sqrt((mag**2).sum())
    return out.astype(np.float32)


def average_by_duration(
    values: np.ndarray, durations: np.ndarray, nonzero_only: bool = True
) -> np.ndarray:
    """FastPitch-style token averaging: per-frame values -> per-token means.

    ``nonzero_only`` averages only voiced (non-zero) frames per token, the
    convention for F0 targets.
    """
    out = np.zeros(len(durations), np.float32)
    pos = 0
    for i, d in enumerate(np.asarray(durations, int)):
        seg = values[pos: pos + d]
        if len(seg):
            if nonzero_only:
                nz = seg[seg != 0]
                out[i] = nz.mean() if len(nz) else 0.0
            else:
                out[i] = seg.mean()
        pos += d
    return out


def fs2_targets(
    wav: np.ndarray,
    fs: int,
    n_fft: int,
    hop_length: int,
    win_length: int,
    durations: np.ndarray,
) -> dict:
    """All FastSpeech2 variance targets for one utterance."""
    f0 = extract_f0(wav, fs, hop_length)
    energy = extract_energy(wav, n_fft, hop_length, win_length)
    return {
        "pitch": average_by_duration(f0, durations, nonzero_only=True),
        "energy": average_by_duration(energy, durations, nonzero_only=False),
        "f0_frames": f0,
        "energy_frames": energy,
    }
