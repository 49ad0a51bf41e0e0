"""Log-mel front-end (``a3t_tpu/dsp/frontend.py:36-118``), computed by rfft.

Chain (espnet2/tts/feats_extract/log_mel_fbank.py:88-106):
    stft -> power -> amp = sqrt(clamp(power, 1e-10))
         -> mel = clamp(amp @ melmat.T, 1e-10) -> log10 -> zero padded frames

The JAX train step's default is the matmul-DFT variant ``fused``
(``a3t_tpu/train/train_step.py:94``, ``use_fused_frontend: True`` in
``tasks/config.py:66``), which computes the same chain with the DFT as two
matrix products; this rfft computes the same features within ~1e-5
(measured 8.8e-6 at 24 kHz and 9.3e-6 at 16 kHz on features up to 2.9, by
``tests/test_torch_train.py::test_featurize_matches_jax_fused_frontend``;
``tests/test_torch_dsp.py`` holds it against JAX's rfft front-end).  Only
the Pallas kernel of that chain (``ops/fused_logmel.py``) is off by default;
it is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp.mel import mel_filterbank
from a3t_tpu_torch.dsp.stft import num_frames, padded_window, stft


@dataclasses.dataclass(frozen=True)
class LogMelConfig:
    """Front-end settings; defaults are the 24 kHz A3T recipe values
    (egs2/vctk/sedit/run.sh:11-13).  The 16 kHz corpora use fs=16000,
    n_fft=1024, hop=200, win=800."""

    fs: int = 24000
    n_fft: int = 2048
    hop_length: int = 300
    win_length: int = 1200
    n_mels: int = 80
    fmin: float = 80.0
    fmax: float = 7600.0
    log_base: float = 10.0

    @property
    def n_freqs(self) -> int:
        return 1 + self.n_fft // 2

    def num_frames(self, n_samples: int) -> int:
        return num_frames(n_samples, self.hop_length)


class LogMelFrontend:
    """Stateless callable computing log10-mel features on ``device`` (cuda
    unless the caller asks for the CPU)."""

    def __init__(self, config: LogMelConfig = LogMelConfig(), device=None):
        self.config = config
        c = config
        self.device = resolve_device(device)
        self.melmat = torch.as_tensor(
            mel_filterbank(c.fs, c.n_fft, c.n_mels, c.fmin, c.fmax).T,
            device=self.device)  # (n_freqs, n_mels)
        self.window = padded_window(c.n_fft, c.win_length)

    def frame_lengths(self, sample_lengths: torch.Tensor) -> torch.Tensor:
        return sample_lengths // self.config.hop_length + 1

    def __call__(self, audio: torch.Tensor, sample_lengths=None):
        """audio (B, S) -> (feats (B, F, n_mels), frame_lengths (B,))."""
        c = self.config
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        spec = stft(audio, c.n_fft, c.hop_length, c.win_length, self.window)
        power = spec.real ** 2 + spec.imag ** 2
        amp = torch.sqrt(torch.clamp(power, min=1e-10))
        feats = torch.log10(torch.clamp(amp @ self.melmat, min=1e-10))
        n_f = feats.shape[1]
        if sample_lengths is not None:
            flens = self.frame_lengths(torch.as_tensor(
                sample_lengths, device=self.device))
            valid = torch.arange(n_f, device=self.device)[None] < flens[:, None]
            feats = torch.where(valid[..., None], feats,
                                torch.zeros_like(feats))
        else:
            flens = torch.full((feats.shape[0],), n_f, dtype=torch.int64,
                               device=self.device)
        return feats, flens
