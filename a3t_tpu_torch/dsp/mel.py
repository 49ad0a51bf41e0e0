"""Mel filterbank construction (librosa-compatible, Slaney-style).

A numpy copy of ``a3t_tpu/dsp/mel.py:23-91``, kept here so that the port
imports nothing of the JAX package.

The reference builds its mel matrix with ``librosa.filters.mel`` (Slaney mel
scale, Slaney area normalization) and multiplies amplitude spectrograms by its
transpose (espnet2/layers/log_mel.py:49-62).  librosa is not a dependency
here, so the filterbank is computed from first principles with numpy; the
result is bit-identical to ``librosa.filters.mel(htk=False, norm="slaney")``
up to float32 rounding.
"""

from __future__ import annotations

import numpy as np

# Slaney mel-scale constants: linear below 1 kHz (200/3 Hz per mel),
# logarithmic above with a step of ln(6.4)/27 per mel.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq, htk: bool = False):
    """Convert Hz to mels (Slaney by default, matching librosa)."""
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    mels = freq / _F_SP
    if freq.ndim:
        log_t = freq >= _MIN_LOG_HZ
        mels[log_t] = _MIN_LOG_MEL + np.log(freq[log_t] / _MIN_LOG_HZ) / _LOGSTEP
    elif freq >= _MIN_LOG_HZ:
        mels = _MIN_LOG_MEL + np.log(freq / _MIN_LOG_HZ) / _LOGSTEP
    return mels


def mel_to_hz(mels, htk: bool = False):
    """Convert mels to Hz (inverse of :func:`hz_to_mel`)."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    freqs = _F_SP * mels
    if mels.ndim:
        log_t = mels >= _MIN_LOG_MEL
        freqs[log_t] = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels[log_t] - _MIN_LOG_MEL))
    elif mels >= _MIN_LOG_MEL:
        freqs = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL))
    return freqs


def mel_filterbank(
    fs: int,
    n_fft: int,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, 1 + n_fft // 2)``.

    Matches ``librosa.filters.mel``: triangle centers are equally spaced on
    the (Slaney) mel scale between ``fmin`` and ``fmax``; with
    ``norm="slaney"`` each triangle is scaled to unit area (2 / bandwidth).
    """
    if fmax is None:
        fmax = float(fs) / 2.0

    n_freqs = 1 + n_fft // 2
    # FFT bin center frequencies.
    fftfreqs = np.linspace(0.0, float(fs) / 2.0, n_freqs, dtype=np.float64)

    # n_mels + 2 mel band edges, uniformly spaced in mel.
    mel_edges = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_edges = mel_to_hz(mel_edges, htk)

    fdiff = np.diff(hz_edges)
    ramps = hz_edges[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_edges[2 : n_mels + 2] - hz_edges[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"Unsupported mel norm: {norm!r}")

    return weights.astype(dtype)
