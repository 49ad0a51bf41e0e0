"""Griffin-Lim, the editor's vocoder when none is given
(``a3t_tpu/dsp/griffin_lim.py``).

log10-mel -> linear amplitude through the mel filterbank's pseudo-inverse
(computed in numpy, as the JAX package does), then ``n_iters`` rounds of
phase reconstruction through :func:`istft` and :func:`stft` on the
magnitude's device.  The initial phase is uniform in [-pi, pi), drawn from a
``torch.Generator`` on that device seeded by ``seed``, or given by the
caller (the counterpart of the vocoder's explicit noise): the JAX package
draws it from ``PRNGKey(seed)``, whose numbers torch cannot reproduce.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from a3t_tpu_torch.dsp.frontend import LogMelConfig
from a3t_tpu_torch.dsp.mel import mel_filterbank
from a3t_tpu_torch.dsp.stft import istft, stft


@functools.lru_cache(maxsize=8)
def _pinv_t(config: LogMelConfig) -> np.ndarray:
    """(n_mels, n_freqs): the transposed pseudo-inverse of the filterbank."""
    c = config
    melmat = mel_filterbank(c.fs, c.n_fft, c.n_mels, c.fmin, c.fmax)
    return np.linalg.pinv(melmat).T


def mel_to_linear(logmel: torch.Tensor, config: LogMelConfig) -> torch.Tensor:
    """(B, F, n_mels) log10-mel -> (B, F, n_freqs) linear amplitude, at
    least 1e-10."""
    inv = torch.as_tensor(_pinv_t(config), dtype=logmel.dtype,
                          device=logmel.device)
    return torch.clamp(torch.pow(10.0, logmel) @ inv, min=1e-10)


def initial_phase(shape, seed: int = 0, device=None) -> torch.Tensor:
    """Uniform phase in [-pi, pi) from a generator on ``device`` seeded by
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(tuple(shape), generator=gen, device=device)
    return u * (2.0 * math.pi) - math.pi


def griffin_lim(magnitude: torch.Tensor, config: LogMelConfig,
                n_iters: int = 32, seed: int = 0,
                phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase reconstruction: magnitude (B, F, n_freqs) -> wav (B, (F - 1) *
    hop), from ``phase`` (B, F, n_freqs) or a phase drawn with ``seed``."""
    c = config
    if phase is None:
        phase = initial_phase(magnitude.shape, seed, magnitude.device)
    phase = phase.to(magnitude.device, magnitude.dtype)
    n_f = magnitude.shape[1]
    for _ in range(n_iters):
        wav = istft(torch.polar(magnitude, phase), c.n_fft, c.hop_length,
                    c.win_length)
        phase = torch.angle(stft(wav, c.n_fft, c.hop_length,
                                 c.win_length)[:, :n_f])
    return istft(torch.polar(magnitude, phase), c.n_fft, c.hop_length,
                 c.win_length)


def logmel_to_wav(logmel: torch.Tensor, config: LogMelConfig,
                  n_iters: int = 32, seed: int = 0) -> torch.Tensor:
    """The whole vocoder: (B, F, n_mels) log10-mel -> (B, (F - 1) * hop)
    wav."""
    return griffin_lim(mel_to_linear(logmel, config), config, n_iters, seed)
