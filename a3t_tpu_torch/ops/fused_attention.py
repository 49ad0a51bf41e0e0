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
0xFFFFFFFF)`` with lane ``b * 4096 + head0 + h``; kept probabilities are
scaled by 1 / (1 - rate) and the softmax denominator stays undropped.  Both
kernels draw the same bits, so the backward regenerates the forward's mask.
``head0`` is the global index of the call's first head: a rank of the
model axis that holds heads ``head0 .. head0 + H - 1`` of a layer
(``parallel/sharding.py``) draws the masks one process draws for them.

**Query blocks** (the mesh's seq axis, ``parallel/sequence.py``): a call
may hold Lq query rows against Lk >= Lq keys, a block of the square call's
rows.  ``q_rows = (split, off)`` names them: local row i is global row
``i + off`` below ``split`` and ``i + Lk - Lq`` from there on (a seq
rank's frame block, then the whole text); None is the square call.  The
bias is (B, H, Lq, Lk), the lse (B, H, 1, Lq), and the dropout counter
``global_row * Lk + col``, so a block draws exactly those rows of the square
call's mask; K2's dk and dv cover all Lk keys, summed over the block's
queries alone.
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


def global_rows(lq: int, lk: int, q_rows=None, device=None) -> torch.Tensor:
    """(lq,) int64: the global row of each of a call's ``lq`` query rows
    against ``lk`` keys (``q_rows``: the module docstring's (split, off);
    None is the square call, rows 0 .. lk - 1)."""
    i = torch.arange(lq, dtype=torch.int64, device=device)
    if q_rows is None:
        return i
    split, off = q_rows
    return i + torch.where(i < split, off, lk - lq)


def keep_mask(b: int, h: int, l: int, seed: int, rate: float,
              device=None, head0: int = 0, rows=None) -> torch.Tensor:
    """(b, h, l, l) bool dropout keep-mask of the kernel's rule, for heads
    ``head0 .. head0 + h - 1``; with ``rows`` (an int64 tensor of global
    rows) the (b, h, len(rows), l) rows of it."""
    rows = (torch.arange(l, dtype=torch.int64, device=device) if rows is None
            else rows.to(device=device, dtype=torch.int64))
    ctr = (rows[:, None] * l + torch.arange(l, dtype=torch.int64,
                                            device=device)).view(
        1, 1, len(rows), l)
    lane = (torch.arange(b, dtype=torch.int64, device=device).view(b, 1, 1, 1)
            * 4096 + torch.arange(head0, head0 + h, dtype=torch.int64,
                                  device=device).view(1, h, 1, 1))
    return hash_bits(ctr, seed, lane) >= threshold(rate)


def _flat_mask(mask: torch.Tensor, b: int, l: int) -> torch.Tensor:
    return mask.reshape(b, l).to(torch.int32)


def _block_keep(b, h, lq, lk, seed, rate, device, head0, q_rows):
    """The keep-mask of a call's rows (all rows of a square call)."""
    rows = None if q_rows is None else global_rows(lq, lk, q_rows, device)
    return keep_mask(b, h, lk, seed, rate, device=device, head0=head0,
                     rows=rows)


def fused_attention_reference(q_u, k, v, bias, mask, seed: int = 0,
                              rate: float = 0.0, head0: int = 0,
                              q_rows=None):
    """Plain PyTorch version: (out (B,H,Lq,d) in q's dtype, lse (B,H,1,Lq)
    f32).

    q_u (B,H,Lq,d); k/v (B,H,Lk,d); bias (B,H,Lq,Lk); mask (B,Lk) or
    (B,1,Lk), nonzero = valid; ``head0`` the global index of head 0 (the
    dropout lanes); ``q_rows`` the query block's (split, off), None for
    the square call (module docstring).
    """
    b, h, lq, d = q_u.shape
    lk = k.shape[2]
    scale = float(np.float32(1.0 / np.sqrt(d)))
    s = (torch.einsum("bhld,bhmd->bhlm", q_u.float(), k.float())
         + bias.float()) * scale
    valid = (_flat_mask(mask, b, lk) > 0).view(b, 1, 1, lk)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = torch.where(valid, e / denom, torch.zeros_like(e))
    if rate > 0.0:
        keep = _block_keep(b, h, lq, lk, seed, rate, q_u.device, head0,
                           q_rows)
        p = p * (keep.float() * float(np.float32(1.0 / (1.0 - rate))))
    out = torch.einsum("bhlm,bhmd->bhld", p, v.float()).to(q_u.dtype)
    lse = (m + torch.log(denom))[..., 0][:, :, None, :]
    return out, lse


def fused_attention_bwd_reference(q_u, k, v, bias, mask, seed, rate, out,
                                  lse, g, head0: int = 0, q_rows=None):
    """Plain PyTorch version of the backward: (dq, dk, dv, dbias), each in
    its input's dtype and shape, from the forward's inputs, ``out``,
    ``lse`` and the output gradient ``g`` (``_bwd_call``,
    fused_attention.py:135-191); dk and dv sum over the call's query rows
    alone."""
    b, h, lq, d = q_u.shape
    lk = k.shape[2]
    scale = float(np.float32(1.0 / np.sqrt(d)))
    qf, kf, vf, gf = (t.float() for t in (q_u, k, v, g))
    delta = (gf * out.float()).sum(-1, keepdim=True)  # (B, H, Lq, 1)
    s = (torch.einsum("bhld,bhmd->bhlm", qf, kf) + bias.float()) * scale
    valid = (_flat_mask(mask, b, lk) > 0).view(b, 1, 1, lk)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.exp(s - lse[:, :, 0, :, None])
    p = torch.where(valid, p, torch.zeros_like(p))
    dp = torch.einsum("bhld,bhmd->bhlm", gf, vf)
    p_d = p
    if rate > 0.0:
        keep = _block_keep(b, h, lq, lk, seed, rate, q_u.device, head0,
                           q_rows).float() \
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
                       "a3t_fused_attention_fwd", 8, 11)


@functools.lru_cache(maxsize=None)
def _entry_bwd():
    """K2's C entry point, built and loaded on first use."""
    return native.bind("fused_attention_bwd", LIBRARIES["fused_attention_bwd"],
                       "a3t_fused_attention_bwd", 12, 9)


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


def _launch(fn, ptrs, ints, q_u, lk: int, seed: int, rate: float,
            what: str):
    """``ints`` follow B, H, Lq, Lk, d and the dtype (the last three are
    head0 and the query block's split and offset)."""
    b, h, lq, d = q_u.shape
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        err = fn(*ptrs, b, h, lq, lk, d,
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
              rows: int = ROW_TILE, lk: int = None) -> tuple[int, int]:
    """(splits, keys per split) of K1's grid for ``l`` query rows against
    ``lk`` keys (``l`` when None).  A CTA owns ``rows`` query rows of one
    (b, h); when those B * H * ceil(l / rows) CTAs do not fill the card's
    ``sms`` multiprocessors (a seq rank's block has 1/sp of the rows), each
    row tile's keys are split into ranges of a multiple of 16 keys, enough
    that the grid holds >= ``sms`` CTAs where lk allows it.  (1, lk) means
    no split."""
    lk = l if lk is None else lk
    tiles = b * h * -(-l // rows)
    if tiles >= sms:
        return 1, lk
    units = -(-lk // SPLIT_UNIT)
    kps = SPLIT_UNIT * max(1, units // -(-sms // tiles))
    splits = -(-lk // kps)
    return (1, lk) if splits == 1 else (splits, kps)


def _q_rows(q_rows, lq: int, lk: int) -> tuple[int, int]:
    """The kernels' (split, off) of a call's query rows; raise unless they
    are a block of the lk rows."""
    if q_rows is None:
        if lq != lk:
            raise ValueError(f"{lq} query rows against {lk} keys need "
                             "q_rows (the block's split and offset)")
        return lk, 0
    split, off = (int(x) for x in q_rows)
    if not (lq <= lk and 0 <= split <= lq and 0 <= off <= lk - lq):
        raise ValueError(f"q_rows {q_rows} of {lq} query rows is no block "
                         f"of {lk} rows")
    return split, off


def _kernel_fwd(q_u, k, v, bias, mask, seed: int, rate: float,
                head0: int = 0, q_rows=None):
    global LAUNCHES
    b, h, lq, d = q_u.shape
    lk = k.shape[2]
    split, off = _q_rows(q_rows, lq, lk)
    _check(q_u, (("k", k, (b, h, lk, d)), ("v", v, (b, h, lk, d)),
                 ("bias", bias, (b, h, lq, lk))))
    if mask.device != q_u.device:
        raise ValueError("fused_attention inputs lie on different devices")
    m = _flat_mask(mask, b, lk).contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((b, h, 1, lq), dtype=torch.float32, device=q_u.device)
    splits, kps = _fwd_plan(b, h, lq, _sm_count(q_u.device.index or 0),
                            ROW_TILE if q_u.dtype == torch.float32
                            else ROW_TILE_BF16, lk)
    # the key ranges' partials (acc, max, sum), combined by a second launch
    part = (torch.empty(splits * b * h * lq * (d + 2), dtype=torch.float32,
                        device=q_u.device) if splits > 1 else None)
    _launch(_entry(), (q_u.data_ptr(), k.data_ptr(), v.data_ptr(),
                       bias.data_ptr(), m.data_ptr(), out.data_ptr(),
                       lse.data_ptr(), 0 if part is None else part.data_ptr()),
            (splits, kps, head0, split, off), q_u, lk, seed, rate,
            "fused_attention")
    LAUNCHES += 1
    return out, lse


def _kernel_bwd(q_u, k, v, bias, mask, seed: int, rate: float, out, lse, g,
                head0: int = 0, q_rows=None):
    global LAUNCHES_BWD
    b, h, lq, d = q_u.shape
    lk = k.shape[2]
    split, off = _q_rows(q_rows, lq, lk)
    mat, kv = (b, h, lq, d), (b, h, lk, d)
    _check(q_u, (("k", k, kv), ("v", v, kv), ("bias", bias, (b, h, lq, lk)),
                 ("out", out, mat), ("g", g, mat)))
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, 1, lq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse: {tuple(lse.shape)} {lse.dtype}, expected "
                         f"contiguous {(b, h, 1, lq)} float32")
    if mask.device != q_u.device or lse.device != q_u.device:
        raise ValueError("fused_attention inputs lie on different devices")
    m = _flat_mask(mask, b, lk).contiguous()
    # delta = sum(g * out) per row stays one expression, as it stays
    # outside the Pallas kernel (fused_attention.py:140-141)
    delta = (g.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv, dbias = (torch.empty_like(t) for t in (q_u, k, v, bias))
    _launch(_entry_bwd(), (q_u.data_ptr(), k.data_ptr(), v.data_ptr(),
                           bias.data_ptr(), m.data_ptr(), g.data_ptr(),
                           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), dbias.data_ptr()),
            (head0, split, off), q_u, lk, seed, rate,
            "fused_attention backward")
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


def _check_head0(head0: int, h: int) -> None:
    if not 0 <= head0 <= 4096 - h:
        raise ValueError(f"head0 {head0} with {h} heads outside the lanes' "
                         "4096 heads")


def fused_attention_fwd(q_u, k, v, bias, mask, seed: int = 0,
                        rate: float = 0.0, head0: int = 0, q_rows=None):
    """(out, lse): the plain version for CPU tensors, K1 for CUDA."""
    _check_head0(head0, q_u.shape[1])
    _q_rows(q_rows, q_u.shape[2], k.shape[2])
    if _on_device(q_u, rate) == "cpu":
        return fused_attention_reference(q_u, k, v, bias, mask, seed, rate,
                                         head0, q_rows)
    return _kernel_fwd(q_u, k, v, bias, mask, seed, rate, head0, q_rows)


def fused_attention_bwd(q_u, k, v, bias, mask, seed: int, rate: float, out,
                        lse, g, head0: int = 0, q_rows=None):
    """(dq, dk, dv, dbias): the plain version for CPU tensors, K2 for CUDA."""
    _check_head0(head0, q_u.shape[1])
    _q_rows(q_rows, q_u.shape[2], k.shape[2])
    if _on_device(q_u, rate) == "cpu":
        return fused_attention_bwd_reference(q_u, k, v, bias, mask, seed,
                                             rate, out, lse, g, head0,
                                             q_rows)
    return _kernel_bwd(q_u, k, v, bias, mask, seed, rate, out, lse, g,
                       head0, q_rows)


class FusedAttention(torch.autograd.Function):
    """K1 forward and K2 backward (their plain versions on the CPU), as the
    JAX package's ``custom_vjp`` binds ``_fwd_call`` and ``_bwd_call``.
    Saves the inputs, ``out`` and ``lse``; the dropout mask is regenerated
    from the int seed."""

    @staticmethod
    def forward(ctx, q_u, k, v, bias, mask, seed: int, rate: float,
                head0: int, q_rows):
        out, lse = fused_attention_fwd(q_u, k, v, bias, mask, seed, rate,
                                       head0, q_rows)
        ctx.save_for_backward(q_u, k, v, bias, mask, out, lse)
        ctx.seed, ctx.rate, ctx.head0, ctx.q_rows = seed, rate, head0, q_rows
        return out

    @staticmethod
    def backward(ctx, g):
        q_u, k, v, bias, mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = fused_attention_bwd(
            q_u, k, v, bias, mask, ctx.seed, ctx.rate, out, lse,
            g.contiguous(), ctx.head0, ctx.q_rows)
        return dq, dk, dv, dbias, None, None, None, None, None


def fused_attention(q_u, k, v, bias, mask, dropout_rate: float = 0.0,
                    seed: int = 0, head0: int = 0, q_rows=None):
    """Fused softmax(+dropout)+PV attention output (B, H, Lq, d), with its
    backward through K2.

    Args mirror ``a3t_tpu.ops.fused_attention.fused_attention``, except that
    dropout takes an int ``seed`` (the JAX wrapper draws it from its rng),
    ``head0``, the global index of head 0 (its dropout lane), which is 0
    unless the heads are a slice of a layer's, and ``q_rows``, the query
    block's (split, off) when q_u holds a block of k's rows (module
    docstring).
    """
    return FusedAttention.apply(q_u, k, v, bias, mask, int(seed),
                                float(dropout_rate), int(head0),
                                None if q_rows is None
                                else tuple(int(x) for x in q_rows))
