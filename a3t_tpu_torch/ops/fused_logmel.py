"""Fused STFT -> |.| -> mel -> log10: the port of the TPU kernel
``a3t_tpu/ops/fused_logmel.py::fused_logmel`` (K6).

For audio (B, S) and F = 1 + S // hop frames of the signal reflect-padded by
n_fft / 2:

    X    = rfft(frame * window)                   (n_fft / 2 + 1 bins)
    amp  = sqrt(max(re^2 + im^2, 1e-10))
    mel  = amp @ melmat
    out  = ln(max(mel, 1e-10)) / ln 10,   frames past sample_lengths // hop
                                          + 1 set to 0

Two versions of the same function: plain PyTorch
(:func:`fused_logmel_plain`, the matmul-DFT front-end
``LogMelFrontend.fused``), the CPU path and the kernel's oracle on the card;
and the CUDA kernels of ``csrc/fused_logmel.cu``, launched for CUDA tensors,
where a failed build or launch raises and nothing falls back.  The wrapper
picks the kernel by shape (:func:`plan`): an fp32 FFT in shared memory for a
power-of-two n_fft (every config of the repo), the direct DFT over the
window's rows for any other n_fft, and raises for what neither takes.  It
builds each config's tables once, in float64, stored in float32: the FFT's
twiddles (:func:`fft_tables`) and each mel filter's range of non-zero bins,
read from the mel matrix itself (:func:`mel_ranges`), or the DFT's bases
(:func:`dft_tables`).  ``LAUNCHES`` counts kernel launches of either route.
The features are data, so neither version has a gradient.  The train step
reaches this module only through ``featurize(..., use_pallas=True)``, as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from a3t_tpu_torch.dsp.frontend import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.dsp.mel import mel_filterbank
from a3t_tpu_torch.dsp.stft import hann_window
from a3t_tpu_torch.ops import native

LIBRARIES = {"fused_logmel": ("fused_logmel.cu",)}
# the largest n_fft either kernel takes, and the FFT route's smallest
MAX_N_FFT, MIN_FFT = 4096, 64
# shared memory a CTA may take; an SM's, less 1 KB for each CTA on it
SMEM_MAX, SMEM_SM = 232_448, 233_472
# the DFT route's tiling: window rows padded to ROWS, bins to BINS; at most
# MAX_MELS mel bins; DFT_FRAMES frames per CTA (csrc/fused_logmel.cu NK, KB,
# MAXM, TF)
ROWS, BINS, MAX_MELS, DFT_FRAMES = 32, 64, 128, 64

# kernel launches since the last reset (launches only, not plain-version
# calls)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fft_schedule(logm: int) -> list[int]:
    """log2 of each Stockham stage's radix for an M = 2^logm point complex
    FFT, as the kernel runs them: 16 first, then 4s, then a last 2."""
    out, done = [], 0
    while done < logm:
        r = min(4, logm) if done == 0 else (2 if logm - done >= 2 else 1)
        out.append(r)
        done += r
    return out


def stage_twiddles(logm: int) -> np.ndarray:
    """complex128 twiddles of the stages of :func:`fft_schedule`, one block
    of R P entries per stage (P the product of the earlier radices): entry
    j P + k is exp(-2 pi i j k / (P R)), j < R, k < P."""
    blocks, p = [], 1
    for lr in fft_schedule(logm):
        r = 1 << lr
        j, k = np.arange(r)[:, None], np.arange(p)[None, :]
        blocks.append(np.exp(-2j * np.pi * j * k / (p * r)).reshape(-1))
        p *= r
    return np.concatenate(blocks)


def mel_ranges(melmat: np.ndarray):
    """Each mel filter's bins (melmat (n_freqs, n_mels)): (first bin, bin
    count, weight offset) int32 (3, n_mels) and the weights of bins first
    .. last non-zero, in bin order, float32; a filter with no non-zero
    weight gets 0 bins."""
    n_mels = melmat.shape[1]
    idx = np.zeros((3, n_mels), np.int32)
    weights = []
    off = 0
    for m in range(n_mels):
        nz = np.nonzero(melmat[:, m])[0]
        lo, n = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        idx[:, m] = lo, n, off
        weights.append(melmat[lo:lo + n, m])
        off += n
    return idx, np.concatenate(weights).astype(np.float32)


def _pad4(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.zeros(_round_up(x.size, 4) - x.size,
                                       x.dtype)])


@functools.lru_cache(maxsize=16)
def fft_tables(config: LogMelConfig):
    """The FFT route's tables for one config, built in float64 and stored in
    float32: (tab, mels, offsets).  tab holds, each block a multiple of 4
    floats, the stage twiddles (re, im pairs), the real split's twiddles
    exp(-2 pi i k / n_fft) for k = 0 .. n_fft / 4, the window's win values
    and the mel weights; offsets = {"split", "win", "wts"} index it; mels is
    :func:`mel_ranges`'s (3, n_mels) int32."""
    c = config
    m = c.n_fft // 2
    logm = m.bit_length() - 1
    k = np.arange(m // 2 + 1)
    split = np.exp(-2j * np.pi * k / c.n_fft)
    melmat = mel_filterbank(c.fs, c.n_fft, c.n_mels, c.fmin, c.fmax).T
    mels, weights = mel_ranges(melmat)
    blocks = [np.stack([z.real, z.imag], -1).reshape(-1)
              for z in (stage_twiddles(logm), split)]
    blocks += [hann_window(c.win_length, np.float64), weights]
    blocks = [_pad4(np.asarray(x, np.float64).astype(np.float32))
              for x in blocks]
    starts = np.cumsum([0] + [x.size for x in blocks])
    return (np.concatenate(blocks), mels,
            dict(split=int(starts[1]), win=int(starts[2]),
                 wts=int(starts[3])))


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the wrapper runs K6 for one config: route "fft" or "dft", frames
    per CTA, the audio span a CTA loads (floats) and its shared memory
    (bytes)."""
    route: str
    frames: int
    span: int
    smem: int


@functools.lru_cache(maxsize=64)
def plan(config: LogMelConfig) -> Plan:
    """The route for ``config``, or ValueError with the limit it breaks:
    n_fft at most 4096; the FFT for a power of two from 64, with the frames
    per CTA (at most 16, 8 at n_fft 4096) that keep the most frames on an
    SM; the direct DFT otherwise, with at most 128 mel bins; either within
    227 KB of shared memory."""
    c = config
    if not 0 < c.win_length <= c.n_fft or c.hop_length <= 0:
        raise ValueError(f"fused_logmel kernel needs 0 < win_length <= n_fft "
                         f"and hop_length > 0, not {c}")
    if c.n_fft > MAX_N_FFT:
        raise ValueError(f"fused_logmel kernel takes n_fft up to {MAX_N_FFT}, "
                         f"not {c.n_fft}")
    if c.n_fft >= MIN_FFT and c.n_fft & (c.n_fft - 1) == 0:
        m = c.n_fft // 2
        tab, _, _ = fft_tables(c)
        fixed = 4 * tab.size + 4 * _round_up(3 * c.n_mels, 4)
        fits = []
        # frames per CTA at most, one warp each (csrc/fused_logmel.cu FftCfg)
        tf = 16 if m <= 1024 else 8
        while tf >= 1:
            span = (tf - 1) * c.hop_length + c.win_length
            smem = 8 * tf * m + fixed + 4 * span
            if smem <= SMEM_MAX:
                ctas = min(SMEM_SM // (smem + 1024), 64 // tf)
                fits.append((tf * ctas, -tf, Plan("fft", tf, span, smem)))
            tf //= 2
        if not fits:
            raise ValueError(f"fused_logmel FFT kernel: one frame of {c} needs "
                             f"more than {SMEM_MAX} bytes of shared memory")
        # the most frames in flight on an SM, in more CTAs where that ties
        return max(fits)[2]
    if c.n_mels > MAX_MELS:
        raise ValueError(f"fused_logmel DFT kernel (n_fft {c.n_fft}, not a "
                         f"power of two from {MIN_FFT}) takes at most "
                         f"{MAX_MELS} mel bins, not {c.n_mels}")
    span = _round_up((DFT_FRAMES - 1) * c.hop_length
                     + _round_up(c.win_length, ROWS), 4)
    smem = 4 * (span + 2 * ROWS * BINS + DFT_FRAMES * (BINS + 1)
                + BINS * c.n_mels)
    if smem > SMEM_MAX:
        raise ValueError(f"fused_logmel DFT kernel: {c} needs {smem} bytes of "
                         f"shared memory, more than {SMEM_MAX}")
    return Plan("dft", DFT_FRAMES, span, smem)


@functools.lru_cache(maxsize=16)
def _frontend(config: LogMelConfig, device: torch.device) -> LogMelFrontend:
    return LogMelFrontend(config, device)


@functools.lru_cache(maxsize=16)
def dft_tables(config: LogMelConfig, device: torch.device):
    """(W_cos, W_sin, melmat) for the DFT route on ``device``: the
    front-end's bases, the window's rows only, (win_pad, k_pad), and its mel
    matrix (k_pad, n_mels), zero-padded to the kernel's tiling."""
    c = config
    fe = _frontend(c, device)
    k_pad = _round_up(c.n_freqs, BINS) - c.n_freqs
    win_pad = _round_up(c.win_length, ROWS) - c.win_length
    bases = fe.dft_bases()
    w_cos, w_sin = (F.pad(w, (0, k_pad, 0, win_pad)).contiguous()
                    for w in (bases[:, :c.n_freqs], bases[:, c.n_freqs:]))
    return w_cos, w_sin, F.pad(fe.melmat, (0, 0, 0, k_pad)).contiguous()


@functools.lru_cache(maxsize=16)
def _fft_tensors(config: LogMelConfig, device: torch.device):
    tab, mels, offsets = fft_tables(config)
    return (torch.tensor(tab, device=device),
            torch.tensor(mels.reshape(-1), device=device), offsets)


def fused_logmel_plain(audio: torch.Tensor, config: LogMelConfig,
                       sample_lengths=None):
    """Plain PyTorch version: (log10-mel (B, F, n_mels), frame_lengths (B,)
    int64)."""
    feats, flens = _frontend(config, audio.device).fused(audio,
                                                         sample_lengths)
    return feats, flens.to(torch.int64)


@functools.lru_cache(maxsize=None)
def _entry(route: str):
    """K6's C entry point of ``route``, built and loaded on first use."""
    lib = native.load("fused_logmel", LIBRARIES["fused_logmel"])
    if route == "fft":
        fn = lib.a3t_fused_logmel_fft
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
    else:
        fn = lib.a3t_fused_logmel
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel(audio: torch.Tensor, config: LogMelConfig, sample_lengths):
    global LAUNCHES
    c = config
    p = plan(c)
    b, s = audio.shape
    n_f = c.num_frames(s)
    if sample_lengths is None:
        flens, lens32 = torch.full((b,), n_f, dtype=torch.int64,
                                   device=audio.device), None
    else:
        flens = torch.as_tensor(sample_lengths, device=audio.device).to(
            torch.int64) // c.hop_length + 1
        lens32 = flens.clamp(max=n_f).to(torch.int32).contiguous()
    out = torch.empty(b, n_f, c.n_mels, dtype=torch.float32,
                      device=audio.device)
    start_off = (c.n_fft - c.win_length) // 2 - c.n_fft // 2
    lens_ptr = None if lens32 is None else lens32.data_ptr()
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        if p.route == "fft":
            tab, mels, off = _fft_tensors(c, audio.device)
            err = _entry("fft")(
                audio.data_ptr(), tab.data_ptr(), mels.data_ptr(), lens_ptr,
                out.data_ptr(), b, s, n_f, c.hop_length, c.win_length,
                c.n_fft.bit_length() - 1, c.n_mels, start_off, p.frames,
                off["split"], off["win"], off["wts"], tab.numel(), p.span,
                p.smem, stream)
        else:
            w_cos, w_sin, mel = dft_tables(c, audio.device)
            err = _entry("dft")(
                audio.data_ptr(), w_cos.data_ptr(), w_sin.data_ptr(),
                mel.data_ptr(), lens_ptr, out.data_ptr(), b, s, n_f,
                c.hop_length, w_cos.shape[0], w_cos.shape[1], c.n_mels,
                start_off, stream)
    if err != 0:
        raise RuntimeError(f"fused_logmel {p.route} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    return out, flens


def fused_logmel(audio: torch.Tensor, config: LogMelConfig,
                 sample_lengths=None):
    """audio (B, S) float32 -> (log10-mel (B, F, n_mels), frame_lengths (B,)
    int64): the plain version for a CPU tensor, K6 for a CUDA tensor."""
    if not isinstance(audio, torch.Tensor) or audio.dtype != torch.float32:
        raise TypeError(f"fused_logmel takes a float32 tensor, not "
                        f"{getattr(audio, 'dtype', type(audio))}")
    if audio.dim() != 2 or audio.shape[0] == 0:
        raise ValueError(f"fused_logmel takes audio (B, S), not "
                         f"{tuple(audio.shape)}")
    if audio.shape[1] <= config.n_fft // 2:
        raise ValueError(f"{audio.shape[1]} samples: reflect padding by "
                         f"{config.n_fft // 2} needs more")
    if not audio.is_contiguous():
        raise ValueError("fused_logmel takes contiguous audio")
    if sample_lengths is not None:
        lengths = torch.as_tensor(sample_lengths)
        if tuple(lengths.shape) != audio.shape[:1] \
                or lengths.is_floating_point():
            raise ValueError(f"sample_lengths: {tuple(lengths.shape)} "
                             f"{lengths.dtype}, expected "
                             f"({audio.shape[0]},) integers")
        if isinstance(sample_lengths, torch.Tensor) \
                and sample_lengths.device != audio.device:
            raise ValueError("fused_logmel: audio and sample_lengths lie on "
                             "different devices")
    if audio.device.type == "cpu":
        return fused_logmel_plain(audio, config, sample_lengths)
    if audio.device.type != "cuda":
        raise ValueError(f"fused_logmel runs on cuda or cpu, not "
                         f"{audio.device}")
    return _kernel(audio, config, sample_lengths)
