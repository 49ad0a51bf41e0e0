"""Fused STFT -> |.| -> mel -> log10: the port of the TPU kernel
``a3t_tpu/ops/fused_logmel.py::fused_logmel`` (K6).

For audio (B, S) and F = 1 + S // hop frames of the signal reflect-padded by
n_fft / 2:

    re   = frames @ W_cos,  im = frames @ W_sin     (window folded in)
    amp  = sqrt(max(re^2 + im^2, 1e-10))
    mel  = amp @ melmat
    out  = ln(max(mel, 1e-10)) / ln 10,   frames past sample_lengths // hop
                                          + 1 set to 0

Two versions of the same function: plain PyTorch
(:func:`fused_logmel_plain`, the matmul-DFT front-end
``LogMelFrontend.fused``), the CPU path and the kernel's oracle on the card;
and the CUDA kernel ``csrc/fused_logmel.cu``, launched for CUDA tensors,
where a failed build or launch raises and nothing falls back.  The kernel
reads the front-end's own bases and mel matrix, zero-padded to its tiling.
``LAUNCHES`` counts kernel launches.  The features are data, so neither
version has a gradient.  The train step reaches this module only through
``featurize(..., use_pallas=True)``, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from a3t_tpu_torch.dsp.frontend import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.ops import native

LIBRARIES = {"fused_logmel": ("fused_logmel.cu",)}
# the kernel's tiling: window rows padded to ROWS, bins to BINS; at most
# MAX_MELS mel bins (csrc/fused_logmel.cu NK, KB, MAXM)
ROWS, BINS, MAX_MELS = 32, 64, 128

# kernel launches since the last reset (launches only, not plain-version
# calls)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.lru_cache(maxsize=16)
def _frontend(config: LogMelConfig, device: torch.device) -> LogMelFrontend:
    return LogMelFrontend(config, device)


@functools.lru_cache(maxsize=16)
def tables(config: LogMelConfig, device: torch.device):
    """(W_cos, W_sin, melmat) for one config on ``device``: the front-end's
    bases, the window's rows only, (win_pad, k_pad), and its mel matrix
    (k_pad, n_mels), zero-padded to the kernel's tiling."""
    c = config
    fe = _frontend(c, device)
    k_pad = _round_up(c.n_freqs, BINS) - c.n_freqs
    win_pad = _round_up(c.win_length, ROWS) - c.win_length
    bases = fe.dft_bases()
    w_cos, w_sin = (F.pad(w, (0, k_pad, 0, win_pad)).contiguous()
                    for w in (bases[:, :c.n_freqs], bases[:, c.n_freqs:]))
    return w_cos, w_sin, F.pad(fe.melmat, (0, 0, 0, k_pad)).contiguous()


def fused_logmel_plain(audio: torch.Tensor, config: LogMelConfig,
                       sample_lengths=None):
    """Plain PyTorch version: (log10-mel (B, F, n_mels), frame_lengths (B,)
    int64)."""
    feats, flens = _frontend(config, audio.device).fused(audio,
                                                         sample_lengths)
    return feats, flens.to(torch.int64)


@functools.lru_cache(maxsize=None)
def _entry():
    """K6's C entry point, built and loaded on first use."""
    fn = native.load("fused_logmel", LIBRARIES["fused_logmel"]).a3t_fused_logmel
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return fn


def _kernel(audio: torch.Tensor, config: LogMelConfig, sample_lengths):
    global LAUNCHES
    c = config
    if c.n_mels > MAX_MELS:
        raise ValueError(f"fused_logmel kernel takes at most {MAX_MELS} mel "
                         f"bins, not {c.n_mels}")
    b, s = audio.shape
    n_f = c.num_frames(s)
    w_cos, w_sin, mel = tables(c, audio.device)
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
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        err = _entry()(audio.data_ptr(), w_cos.data_ptr(), w_sin.data_ptr(),
                       mel.data_ptr(),
                       None if lens32 is None else lens32.data_ptr(),
                       out.data_ptr(), b, s, n_f, c.hop_length,
                       w_cos.shape[0], w_cos.shape[1], c.n_mels, start_off,
                       stream)
    if err != 0:
        raise RuntimeError(f"fused_logmel kernel launch failed: CUDA error "
                           f"{err}")
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
