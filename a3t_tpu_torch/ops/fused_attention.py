"""Fused full attention, forward and backward: the port of the TPU kernels
``a3t_tpu/ops/fused_attention.py::_fwd_call`` (K1) and ``::_bwd_call`` (K2).

Forward, per (batch, head):

    s    = (q_u @ k^T + bias) / sqrt(d)      bias = rel-shifted pos scores
    p    = softmax(s) over valid keys (fp32), masked columns re-zeroed
    out  = (p * keep / (1 - rate)) @ v,      lse = one logsumexp per row

Backward recomputes p from lse and regenerates the keep-mask:

    dv = (p * keep / (1 - rate))^T @ g,   dp = g @ v^T * keep / (1 - rate)
    ds = p * (dp - delta) / sqrt(d),      delta = sum(g * out) per row
    dq = ds @ k,  dk = ds^T @ q_u,  dbias = ds

Each half has two versions of the same function:

* plain PyTorch (:func:`fused_attention_reference`,
  :func:`fused_attention_bwd_reference`), the CPU path and the kernels'
  oracle on the card;
* a CUDA kernel (``csrc/fused_attention_fwd.cu``,
  ``csrc/fused_attention_bwd.cu``), launched for CUDA tensors.

:class:`FusedAttention` binds the two halves into one autograd function.
The wrappers pick the plain version only because their tensors lie on the
CPU; on a CUDA tensor they launch the kernel or raise.  ``LAUNCHES`` and
``LAUNCHES_BWD`` count kernel launches, so a run can show that its path went
through the kernels.

Dropout follows the TPU kernel's interpret-mode rule (fused_attention.py
:69-80): keep iff ``hash(row * L + col, seed, lane) >= uint32(rate *
0xFFFFFFFF)`` with lane ``b * 4096 + h``; kept probabilities are scaled by
1 / (1 - rate) and the softmax denominator stays undropped.  Both kernels
draw the same bits, so the backward regenerates the forward's mask.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from a3t_tpu_torch.ops import native

NEG = -1e30
_M32 = 0xFFFFFFFF
# the kernels' libraries, {name: sources in csrc/}
LIBRARIES = {"fused_attention": ("fused_attention_fwd.cu",),
             "fused_attention_bwd": ("fused_attention_bwd.cu",)}

# K1's grid (csrc/fused_attention_fwd.cu): query rows per CTA in fp32 and
# in bf16 (two warpgroups of 64), and the unit of its key ranges when the
# rows alone do not fill the card
ROW_TILE = 64
ROW_TILE_BF16 = 128
SPLIT_UNIT = 16

# kernel launches since the last reset (launches only, not plain-version
# calls): K1 forward, K2 backward; one per wrapper call, however many
# passes the kernel runs
LAUNCHES = 0
LAUNCHES_BWD = 0


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES_BWD
    LAUNCHES = 0
    LAUNCHES_BWD = 0


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


def fused_attention_bwd_reference(q_u, k, v, bias, mask, seed, rate, out,
                                  lse, g):
    """Plain PyTorch version of the backward: (dq, dk, dv, dbias), each in
    its input's dtype, from the forward's inputs, ``out``, ``lse`` and the
    output gradient ``g`` (``_bwd_call``, fused_attention.py:135-191)."""
    b, h, l, d = q_u.shape
    scale = float(np.float32(1.0 / np.sqrt(d)))
    qf, kf, vf, gf = (t.float() for t in (q_u, k, v, g))
    delta = (gf * out.float()).sum(-1, keepdim=True)  # (B, H, L, 1)
    s = (torch.einsum("bhld,bhmd->bhlm", qf, kf) + bias.float()) * scale
    valid = (_flat_mask(mask, b, l) > 0).view(b, 1, 1, l)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.exp(s - lse[:, :, 0, :, None])
    p = torch.where(valid, p, torch.zeros_like(p))
    dp = torch.einsum("bhld,bhmd->bhlm", gf, vf)
    p_d = p
    if rate > 0.0:
        keep = keep_mask(b, h, l, seed, rate, device=q_u.device).float() \
            * float(np.float32(1.0 / (1.0 - rate)))
        p_d = p * keep
        dp = dp * keep
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bhlm,bhld->bhmd", p_d, gf)
    dq = torch.einsum("bhlm,bhmd->bhld", ds, kf)
    dk = torch.einsum("bhlm,bhld->bhmd", ds, qf)
    return (dq.to(q_u.dtype), dk.to(k.dtype), dv.to(v.dtype),
            ds.to(bias.dtype))


@functools.lru_cache(maxsize=None)
def _entry():
    """K1's C entry point, built and loaded on first use."""
    return native.bind("fused_attention", LIBRARIES["fused_attention"],
                       "a3t_fused_attention_fwd", 8, 7)


@functools.lru_cache(maxsize=None)
def _entry_bwd():
    """K2's C entry point, built and loaded on first use."""
    return native.bind("fused_attention_bwd", LIBRARIES["fused_attention_bwd"],
                       "a3t_fused_attention_bwd", 12, 5)


def _check(q_u, named):
    """Raise unless the kernels take ``q_u`` and ``named`` ((name, tensor,
    shape) with q_u's dtype) as they are."""
    if q_u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, "
                        f"not {q_u.dtype}")
    for name, t, shape in named:
        if t.dtype != q_u.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{shape} {q_u.dtype}")
    if not 0 < q_u.shape[-1] <= 256:
        raise ValueError(f"head width {q_u.shape[-1]} outside 1..256")
    tensors = [q_u] + [t for _, t, _ in named]
    if any(t.device != q_u.device for t in tensors):
        raise ValueError("fused_attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_attention kernel takes contiguous tensors")


def _launch(fn, ptrs, ints, q_u, seed: int, rate: float, what: str):
    b, h, l, d = q_u.shape
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        err = fn(*ptrs, b, h, l, d,
                 0 if q_u.dtype == torch.float32 else 1, *ints,
                 float(np.float32(1.0 / np.sqrt(d))), seed & _M32,
                 threshold(rate), float(np.float32(1.0 / (1.0 - rate))),
                 int(rate > 0.0), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwd_plan(b: int, h: int, l: int, sms: int = 132,
              rows: int = ROW_TILE) -> tuple[int, int]:
    """(splits, keys per split) of K1's grid.  A CTA owns ``rows`` query
    rows of one (b, h); when those B * H * ceil(L / rows) CTAs do not fill
    the card's ``sms`` multiprocessors, each row tile's keys are split into
    ranges of a multiple of 16 keys, enough that the grid holds >= ``sms``
    CTAs where L allows it.  (1, L) means no split."""
    tiles = b * h * -(-l // rows)
    if tiles >= sms:
        return 1, l
    units = -(-l // SPLIT_UNIT)
    kps = SPLIT_UNIT * max(1, units // -(-sms // tiles))
    splits = -(-l // kps)
    return (1, l) if splits == 1 else (splits, kps)


def _kernel_fwd(q_u, k, v, bias, mask, seed: int, rate: float):
    global LAUNCHES
    b, h, l, d = q_u.shape
    _check(q_u, (("k", k, (b, h, l, d)), ("v", v, (b, h, l, d)),
                 ("bias", bias, (b, h, l, l))))
    if mask.device != q_u.device:
        raise ValueError("fused_attention inputs lie on different devices")
    m = _flat_mask(mask, b, l).contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((b, h, 1, l), dtype=torch.float32, device=q_u.device)
    splits, kps = _fwd_plan(b, h, l, _sm_count(q_u.device.index or 0),
                            ROW_TILE if q_u.dtype == torch.float32
                            else ROW_TILE_BF16)
    # the key ranges' partials (acc, max, sum), combined by a second launch
    part = (torch.empty(splits * b * h * l * (d + 2), dtype=torch.float32,
                        device=q_u.device) if splits > 1 else None)
    _launch(_entry(), (q_u.data_ptr(), k.data_ptr(), v.data_ptr(),
                       bias.data_ptr(), m.data_ptr(), out.data_ptr(),
                       lse.data_ptr(), 0 if part is None else part.data_ptr()),
            (splits, kps), q_u, seed, rate, "fused_attention")
    LAUNCHES += 1
    return out, lse


def _kernel_bwd(q_u, k, v, bias, mask, seed: int, rate: float, out, lse, g):
    global LAUNCHES_BWD
    b, h, l, d = q_u.shape
    mat = (b, h, l, d)
    _check(q_u, (("k", k, mat), ("v", v, mat), ("bias", bias, (b, h, l, l)),
                 ("out", out, mat), ("g", g, mat)))
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, 1, l)
            or not lse.is_contiguous()):
        raise ValueError(f"lse: {tuple(lse.shape)} {lse.dtype}, expected "
                         f"contiguous {(b, h, 1, l)} float32")
    if mask.device != q_u.device or lse.device != q_u.device:
        raise ValueError("fused_attention inputs lie on different devices")
    m = _flat_mask(mask, b, l).contiguous()
    # delta = sum(g * out) per row stays one expression, as it stays
    # outside the Pallas kernel (fused_attention.py:140-141)
    delta = (g.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv, dbias = (torch.empty_like(t) for t in (q_u, k, v, bias))
    _launch(_entry_bwd(), (q_u.data_ptr(), k.data_ptr(), v.data_ptr(),
                           bias.data_ptr(), m.data_ptr(), g.data_ptr(),
                           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), dbias.data_ptr()),
            (), q_u, seed, rate, "fused_attention backward")
    LAUNCHES_BWD += 1
    return dq, dk, dv, dbias


def _on_device(q_u, rate: float) -> str:
    """"cpu" or "cuda", the wrappers' only choice; anything else raises."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if q_u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{q_u.device}")
    return q_u.device.type


def fused_attention_fwd(q_u, k, v, bias, mask, seed: int = 0,
                        rate: float = 0.0):
    """(out, lse): the plain version for CPU tensors, K1 for CUDA."""
    if _on_device(q_u, rate) == "cpu":
        return fused_attention_reference(q_u, k, v, bias, mask, seed, rate)
    return _kernel_fwd(q_u, k, v, bias, mask, seed, rate)


def fused_attention_bwd(q_u, k, v, bias, mask, seed: int, rate: float, out,
                        lse, g):
    """(dq, dk, dv, dbias): the plain version for CPU tensors, K2 for CUDA."""
    if _on_device(q_u, rate) == "cpu":
        return fused_attention_bwd_reference(q_u, k, v, bias, mask, seed,
                                             rate, out, lse, g)
    return _kernel_bwd(q_u, k, v, bias, mask, seed, rate, out, lse, g)


class FusedAttention(torch.autograd.Function):
    """K1 forward and K2 backward (their plain versions on the CPU), as the
    JAX package's ``custom_vjp`` binds ``_fwd_call`` and ``_bwd_call``.
    Saves the inputs, ``out`` and ``lse``; the dropout mask is regenerated
    from the int seed."""

    @staticmethod
    def forward(ctx, q_u, k, v, bias, mask, seed: int, rate: float):
        out, lse = fused_attention_fwd(q_u, k, v, bias, mask, seed, rate)
        ctx.save_for_backward(q_u, k, v, bias, mask, out, lse)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q_u, k, v, bias, mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = fused_attention_bwd(
            q_u, k, v, bias, mask, ctx.seed, ctx.rate, out, lse,
            g.contiguous())
        return dq, dk, dv, dbias, None, None, None


def fused_attention(q_u, k, v, bias, mask, dropout_rate: float = 0.0,
                    seed: int = 0):
    """Fused softmax(+dropout)+PV attention output (B, H, L, d), with its
    backward through K2.

    Args mirror ``a3t_tpu.ops.fused_attention.fused_attention``, except that
    dropout takes an int ``seed`` (the JAX wrapper draws it from its rng).
    """
    return FusedAttention.apply(q_u, k, v, bias, mask, int(seed),
                                float(dropout_rate))
