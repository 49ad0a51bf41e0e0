"""Fused full-attention forward: the port of the TPU kernel
``a3t_tpu/ops/fused_attention.py::_fwd_call``.

Computes, per (batch, head),

    s    = (q_u @ k^T + bias) / sqrt(d)      bias = rel-shifted pos scores
    p    = softmax(s) over valid keys (fp32), masked columns re-zeroed
    out  = (p * keep / (1 - rate)) @ v,      lse = one logsumexp per row

Two versions of the same function live here:

* :func:`fused_attention_reference` — plain PyTorch, the CPU path and the
  kernel's oracle on the card;
* the CUDA kernel ``csrc/fused_attention_fwd.cu``, launched by
  :func:`fused_attention_fwd` for CUDA tensors.

The wrapper picks the plain version only because its tensors lie on the CPU;
on a CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts
kernel launches, so a run can show that its path went through the kernel.

Dropout follows the TPU kernel's interpret-mode rule (fused_attention.py
:69-80): keep iff ``hash(row * L + col, seed, lane) >= uint32(rate *
0xFFFFFFFF)`` with lane ``b * 4096 + h``; kept probabilities are scaled by
1 / (1 - rate) and the softmax denominator stays undropped.  Serving runs
at rate 0; the backward kernel comes with training.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from a3t_tpu_torch.ops import native

NEG = -1e30
_M32 = 0xFFFFFFFF
_SOURCES = ("fused_attention_fwd.cu",)

# kernel launches since the last reset (launches only, not plain-version calls)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32), without int64 overflow
    (torch's uint32 arithmetic is partial)."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_bits(ctr: torch.Tensor, seed: int, lane: torch.Tensor) -> torch.Tensor:
    """The xxhash-style counter mix of the TPU kernel's interpret mode, as
    int64 values in [0, 2^32).  ``lane`` broadcasts against ``ctr``."""
    x = (_mul32(ctr, 2654435761) + ((seed & _M32) * 2246822519 & _M32)
         + _mul32(lane & _M32, 374761393)) & _M32
    for shift, mult in ((15, 2246822519), (13, 3266489917)):
        x = x ^ (x >> shift)
        x = _mul32(x, mult)
    return x ^ (x >> 16)


def threshold(rate: float) -> int:
    return int(rate * 0xFFFFFFFF) & _M32


def keep_mask(b: int, h: int, l: int, seed: int, rate: float,
              device=None) -> torch.Tensor:
    """(b, h, l, l) bool dropout keep-mask of the kernel's rule."""
    ctr = torch.arange(l * l, dtype=torch.int64, device=device).view(1, 1, l, l)
    lane = (torch.arange(b, dtype=torch.int64, device=device).view(b, 1, 1, 1)
            * 4096 + torch.arange(h, dtype=torch.int64,
                                  device=device).view(1, h, 1, 1))
    return hash_bits(ctr, seed, lane) >= threshold(rate)


def _flat_mask(mask: torch.Tensor, b: int, l: int) -> torch.Tensor:
    return mask.reshape(b, l).to(torch.int32)


def fused_attention_reference(q_u, k, v, bias, mask, seed: int = 0,
                              rate: float = 0.0):
    """Plain PyTorch version: (out (B,H,L,d) in q's dtype, lse (B,H,1,L) f32).

    q_u/k/v (B,H,L,d); bias (B,H,L,L); mask (B,L) or (B,1,L), nonzero = valid.
    """
    b, h, l, d = q_u.shape
    scale = float(np.float32(1.0 / np.sqrt(d)))
    s = (torch.einsum("bhld,bhmd->bhlm", q_u.float(), k.float())
         + bias.float()) * scale
    valid = (_flat_mask(mask, b, l) > 0).view(b, 1, 1, l)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = torch.where(valid, e / denom, torch.zeros_like(e))
    if rate > 0.0:
        keep = keep_mask(b, h, l, seed, rate, device=q_u.device)
        p = p * (keep.float() * float(np.float32(1.0 / (1.0 - rate))))
    out = torch.einsum("bhlm,bhmd->bhld", p, v.float()).to(q_u.dtype)
    lse = (m + torch.log(denom))[..., 0][:, :, None, :]
    return out, lse


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded on first use."""
    fn = native.load("fused_attention", _SOURCES).a3t_fused_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _kernel_fwd(q_u, k, v, bias, mask, seed: int, rate: float):
    global LAUNCHES
    b, h, l, d = q_u.shape
    if q_u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, "
                        f"not {q_u.dtype}")
    for name, t, shape in (("k", k, (b, h, l, d)), ("v", v, (b, h, l, d)),
                           ("bias", bias, (b, h, l, l))):
        if t.dtype != q_u.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{shape} {q_u.dtype}")
    if not 0 < d <= 256:
        raise ValueError(f"head width {d} outside 1..256")
    tensors = (q_u, k, v, bias)
    if any(t.device != q_u.device for t in tensors) or mask.device != q_u.device:
        raise ValueError("fused_attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_attention kernel takes contiguous tensors")
    m = _flat_mask(mask, b, l).contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((b, h, 1, l), dtype=torch.float32, device=q_u.device)
    fn = _entry()
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        err = fn(q_u.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 m.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, l, d,
                 0 if q_u.dtype == torch.float32 else 1,
                 float(np.float32(1.0 / np.sqrt(d))), seed & _M32,
                 threshold(rate), float(np.float32(1.0 / (1.0 - rate))),
                 int(rate > 0.0), stream)
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out, lse


def fused_attention_fwd(q_u, k, v, bias, mask, seed: int = 0,
                        rate: float = 0.0):
    """(out, lse): the plain version for CPU tensors, the kernel for CUDA."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if q_u.device.type == "cpu":
        return fused_attention_reference(q_u, k, v, bias, mask, seed, rate)
    if q_u.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{q_u.device}")
    return _kernel_fwd(q_u, k, v, bias, mask, seed, rate)


def fused_attention(q_u, k, v, bias, mask, dropout_rate: float = 0.0,
                    seed: int = 0):
    """Fused softmax(+dropout)+PV attention output (B, H, L, d).

    Args mirror ``a3t_tpu.ops.fused_attention.fused_attention``, except that
    dropout takes an int ``seed`` (the JAX wrapper draws it from its rng).
    """
    return fused_attention_fwd(q_u, k, v, bias, mask, seed, dropout_rate)[0]
