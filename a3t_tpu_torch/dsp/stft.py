"""STFT with torch.stft-compatible semantics (``a3t_tpu/dsp/stft.py:23-116``).

``center=True`` (reflect padding of ``n_fft // 2`` samples on each side),
``onesided=True`` and a periodic Hann window of length ``win_length``
zero-padded symmetrically to ``n_fft``.  Frame ``t`` covers
``padded[t*hop : t*hop + n_fft]``; the frame count is
``1 + floor(n_samples / hop)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (matches ``torch.hann_window``'s default)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def padded_window(n_fft: int, win_length: int, dtype=np.float32) -> np.ndarray:
    """Hann(win_length) zero-padded symmetrically to n_fft (torch.stft rule)."""
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    w = hann_window(win_length, dtype)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=dtype)
    out[left : left + win_length] = w
    return out


def num_frames(n_samples: int, hop_length: int) -> int:
    """Frame count of a centered STFT: 1 + floor(n_samples / hop)."""
    return 1 + n_samples // hop_length


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, S) audio -> (B, 1 + S // hop, n_fft) frames of the reflect-padded
    signal."""
    pad = n_fft // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return xp.unfold(-1, n_fft, hop_length)[:, : num_frames(x.shape[-1],
                                                            hop_length)]


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: int | None = None,
         window: np.ndarray | None = None) -> torch.Tensor:
    """Centered one-sided STFT: (B, S) -> complex (B, F, n_fft // 2 + 1)."""
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = padded_window(n_fft, win_length)
    frames = frame_signal(x, n_fft, hop_length)
    frames = frames * torch.as_tensor(window, dtype=frames.dtype,
                                      device=frames.device)
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def dft_matrices(n_fft: int, win_length: int | None = None,
                 dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases with the analysis window folded in, each
    (n_fft, n_fft // 2 + 1), built in float64 and cast to ``dtype``: for a
    raw frame ``f``, ``Re(rfft(f * w)) = f @ W_cos`` and ``Im(rfft(f * w)) =
    f @ W_sin``.  Rows outside the window's ``[(n_fft - win) // 2, + win)``
    are zero."""
    if win_length is None:
        win_length = n_fft
    w = padded_window(n_fft, win_length, np.float64)
    n = np.arange(n_fft)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w_cos = (np.cos(ang) * w[:, None]).astype(dtype)
    w_sin = (-np.sin(ang) * w[:, None]).astype(dtype)
    return w_cos, w_sin


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int | None = None,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT (overlap-add with window-square normalisation), the
    counterpart of ``torch.istft(center=True)``: complex (B, F,
    n_fft // 2 + 1) -> (B, S), S = ``length`` or (F - 1) * hop.

    The overlap-add is ``F.fold`` (col2im), which sums each output sample's
    frames in a fixed order without atomics, so two runs on the card agree
    bit for bit."""
    if win_length is None:
        win_length = n_fft
    window = torch.as_tensor(padded_window(n_fft, win_length),
                             device=spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    b, n_f, _ = frames.shape
    out_len = n_fft + (n_f - 1) * hop_length

    def overlap_add(cols):  # (B, n_fft, F) -> (B, out_len)
        return F.fold(cols, (1, out_len), (1, n_fft),
                      stride=(1, hop_length)).reshape(cols.shape[0], out_len)

    sig = overlap_add(frames.transpose(1, 2))
    wsq = overlap_add((window * window)[None, :, None].expand(1, n_fft, n_f))
    sig = sig / torch.clamp(wsq, min=1e-11)
    pad = n_fft // 2
    sig = sig[:, pad:-pad] if pad else sig
    if length is not None:
        sig = sig[:, :length]
    return sig
