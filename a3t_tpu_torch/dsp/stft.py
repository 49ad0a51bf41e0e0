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
