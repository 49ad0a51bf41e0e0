"""Log-mel front-end (``a3t_tpu/dsp/frontend.py:36-144``).

Chain (espnet2/tts/feats_extract/log_mel_fbank.py:88-106):
    stft -> power -> amp = sqrt(clamp(power, 1e-10))
         -> mel = clamp(amp @ melmat.T, 1e-10) -> log10 -> zero padded frames

Three routes compute the same features:

* ``__call__`` — rfft (cuFFT on the card), the numerical reference;
* ``fused`` — the DFT as a matrix product with the window folded in
  (``stft.dft_matrices``), then the mel product: the JAX train step's
  default (``a3t_tpu/train/train_step.py:94``), here and in the port;
* ``ops/fused_logmel.py::fused_logmel`` — the hand-written kernel of the
  whole chain (K6), reached only through
  ``train.featurize(..., use_pallas=True)``, as in the JAX package.

``fused`` and the rfft route agree within ~1e-5 on features up to ~3
(measured 8.8e-6 at 24 kHz and 9.3e-6 at 16 kHz by
``tests/test_torch_train.py::test_featurize_matches_jax_fused_frontend``).

:func:`extract_corpus_mels` and :func:`corpus_mvn` (``a3t_tpu/dsp/
frontend.py:147-186``) give the offline trainers (x-vector, vocoder) a
whole corpus's log-mels and their statistics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp.mel import mel_filterbank
from a3t_tpu_torch.dsp.stft import (dft_matrices, frame_signal, num_frames,
                                    padded_window, stft)


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

    def seconds_to_frames(self, t: np.ndarray) -> np.ndarray:
        """Alignment time (sec) -> frame index: floor(fs * t / hop)
        (espnet2/train/collate_fn.py:236-237)."""
        return np.floor(self.fs * np.asarray(t) / self.hop_length).astype(
            np.int32)


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
        self._dft = None  # the window's rows of [W_cos | W_sin], built lazily

    def output_size(self) -> int:
        return self.config.n_mels

    def frame_lengths(self, sample_lengths: torch.Tensor) -> torch.Tensor:
        return sample_lengths // self.config.hop_length + 1

    def _mask(self, feats: torch.Tensor, sample_lengths):
        """Zero the frames at or past each utterance's frame count; (feats,
        frame_lengths), every frame valid without ``sample_lengths``."""
        n_f = feats.shape[1]
        if sample_lengths is None:
            return feats, torch.full((feats.shape[0],), n_f,
                                     dtype=torch.int64, device=self.device)
        flens = self.frame_lengths(torch.as_tensor(sample_lengths,
                                                   device=self.device))
        valid = torch.arange(n_f, device=self.device)[None] < flens[:, None]
        return torch.where(valid[..., None], feats,
                           torch.zeros_like(feats)), flens

    def _finish(self, amp: torch.Tensor, sample_lengths):
        feats = torch.log10(torch.clamp(amp @ self.melmat, min=1e-10))
        return self._mask(feats, sample_lengths)

    def _audio(self, audio) -> torch.Tensor:
        return torch.as_tensor(audio, dtype=torch.float32, device=self.device)

    def __call__(self, audio, sample_lengths=None):
        """audio (B, S) -> (feats (B, F, n_mels), frame_lengths (B,))."""
        c = self.config
        spec = stft(self._audio(audio), c.n_fft, c.hop_length, c.win_length,
                    self.window)
        power = spec.real ** 2 + spec.imag ** 2
        return self._finish(torch.sqrt(torch.clamp(power, min=1e-10)),
                            sample_lengths)

    def dft_bases(self) -> torch.Tensor:
        """The window's rows of [W_cos | W_sin], (win_length, 2 n_freqs)
        float32 from float64 (the other rows are zero), built at first
        use."""
        c = self.config
        if self._dft is None:
            left = (c.n_fft - c.win_length) // 2
            w_cos, w_sin = dft_matrices(c.n_fft, c.win_length)
            self._dft = torch.cat(
                [torch.as_tensor(w_cos), torch.as_tensor(w_sin)],
                dim=1)[left:left + c.win_length].to(self.device)
        return self._dft

    def fused(self, audio, sample_lengths=None):
        """The matmul-DFT route: framing and one product with
        :meth:`dft_bases`, no FFT."""
        c = self.config
        left = (c.n_fft - c.win_length) // 2
        frames = frame_signal(self._audio(audio), c.n_fft, c.hop_length)
        spec = frames[..., left:left + c.win_length] @ self.dft_bases()
        re, im = spec[..., :c.n_freqs], spec[..., c.n_freqs:]
        amp = torch.sqrt(torch.clamp(re * re + im * im, min=1e-10))
        return self._finish(amp, sample_lengths)


class LinearSpectrogramFrontend(LogMelFrontend):
    """Amplitude linear spectrogram (espnet2's LinearSpectrogram):
    stft -> |.| with no mel or log."""

    def output_size(self) -> int:
        return self.config.n_freqs

    def _finish(self, amp, sample_lengths):
        return self._mask(amp, sample_lengths)


class LogSpectrogramFrontend(LinearSpectrogramFrontend):
    """log(amp) linear spectrogram (espnet2's LogSpectrogram)."""

    def _finish(self, amp, sample_lengths):
        return super()._finish(torch.log(torch.clamp(amp, min=1e-10)),
                               sample_lengths)


def extract_corpus_mels(frontend: LogMelFrontend, wavs, chunk: int = 32):
    """A corpus's log-mels in batches on the front-end's device.

    Each waveform is cut to a whole number of hops; every chunk of
    ``chunk`` utterances is zero-padded to one shared length (the longest
    cut rounded up to a multiple of ``64 * hop``) and goes through the
    rfft front-end (``__call__``) in one call.  Returns ``(cut_wavs,
    mels)``, ``mels[i]`` a float32 array of (len(cut_wavs[i]) // hop,
    n_mels): the centred STFT's last frame, which reaches past the
    waveform, is left out."""
    hop = frontend.config.hop_length
    trunc = [np.asarray(w[: (len(w) // hop) * hop], np.float32) for w in wavs]
    bucket = max((len(w) for w in trunc), default=0)
    bucket = -(-bucket // (64 * hop)) * 64 * hop
    mels: list = []
    for c0 in range(0, len(trunc), chunk):
        group = trunc[c0: c0 + chunk]
        padded = np.zeros((chunk, bucket), np.float32)
        for j, wav in enumerate(group):
            padded[j, : len(wav)] = wav
        with torch.inference_mode():
            mel = frontend(padded)[0].cpu().numpy()
        mels += [mel[j, : len(wav) // hop] for j, wav in enumerate(group)]
    return trunc, mels


def corpus_mvn(mels):
    """Per-bin mean and standard deviation over a list of (T_i, n_mels)
    arrays, the deviation floored at 1e-5 (GlobalMVN's guard)."""
    allm = np.concatenate(mels, axis=0)
    return allm.mean(axis=0), np.maximum(allm.std(axis=0), 1e-5)
