"""Device resolution and timing on the card.

Entry points of the port run on ``cuda`` unless the caller asks for the CPU:
:func:`resolve_device` raises when no card is present rather than carrying
on on the CPU.
"""

from __future__ import annotations

import subprocess
import time

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means cuda; a cuda device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a3t_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wall_time(fn, *args, **kwargs):
    """(result, seconds) on the host clock, synchronising the card before
    the clock is read at both ends."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, timed
    with CUDA events over ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
