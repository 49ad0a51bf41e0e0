"""Banded self-attention with global text keys, forward and backward: the
port of the TPU kernels ``a3t_tpu/ops/banded_attention.py::_fwd_call`` (K3),
``::_bwd_dq_call`` (K4) and ``::_bwd_dkv_call`` (K5).

The speech sequence (length T) is cut into chunks of ``c = window // 2``
frames.  Query chunk i sees the 3c band keys of chunks i-1, i, i+1 and the tt
global text keys, under one joint softmax (fp32):

    band = q . [k_{i-1}; k_i; k_{i+1}]^T / sqrt(d),  text = q . k_text^T / sqrt(d)
    masked scores are -1e30 (band: phantom edge chunks and padded keys;
    text: padded tokens); p = exp(s - max) / denom over band and text
    out = (p * keep / (1 - rate)) . [v_band; v_text],  lse = max + log(denom)

Backward, from lse and delta = sum(g * out) per row:

    K4, per query chunk: dq = (ds_b . k_band + ds_t . k_text) / sqrt(d), and
        dk_text, dv_text summed over every query chunk of a (b, h);
    K5, per key chunk j: dk, dv from its three neighbouring query chunks
        j+1, j, j-1 (band blocks 0, 1, 2 of theirs), where they exist.

with ds = p * (dp * keep / (1 - rate) - delta), dp = g . v^T.

The TPU kernels' quirks are kept, because they are the path on the chip:

* the phantom neighbours of chunk 0 and chunk nc-1 are *clipped copies* of
  those chunks (masked through the band mask), and a query row whose every
  key is masked averages all 3c band values and the tt text values (its
  scores are all -1e30; its lse is -1e30 in fp32, so the backward's
  p = exp(s - lse) is 1 on those rows);
* K5 gives the phantom copy no credit, so on such rows the backward is not
  the gradient of the forward;
* with no text (tt = 0) the wrapper adds a fully masked block of 128 text
  keys.

Each function has two versions: plain PyTorch (``*_reference``), the CPU
path and the kernels' oracle on the card; and a CUDA kernel
(``csrc/banded_attention_fwd.cu``, ``_bwd_dq.cu``, ``_bwd_dkv.cu``),
launched for CUDA tensors, where a failed build or launch raises.
:class:`BandedAttention` binds them into one autograd function, and
``LAUNCHES_BANDED_FWD/_DQ/_DKV`` count the kernel launches.

Dropout follows the TPU kernels' interpret-mode rule (the counter hash of
``fused_attention.py:64-80``): lane ``(b * H + h) * nc + chunk``, counter
``row * 3c + col`` for the band draw and ``row * tt + col + 2^20`` for the
text draw, row and col local to the chunk; keep iff the bits are
``>= uint32(rate * 0xFFFFFFFF)``.  K5 regenerates query chunk i's band draw
under i's lane and takes the columns of the key chunk's block.

A call may hold a part of one process's call (the mesh's model and seq
axes, ``models/windowed_attention.py``): its heads ``head0 ..`` of
``heads``, and with ``chunks = (chunk0, nc_all)`` its query chunks
``chunk0 ..`` of ``nc_all``.  The lane is then ``(b * heads + head0 + h) *
nc_all + chunk0 + chunk`` (:class:`Place`), so the call draws one process's
bits for its rows.  With ``chunks`` the keys, the values and the speech
mask carry one halo chunk of c rows on each side, (B, H, T + 2c, d) and
(B, T + 2c): the neighbours' edge chunks.  A halo is a phantom only at a
global edge (the left one when chunk0 = 0, the right one when chunk0 + T /
c = nc_all); a phantom is read, masked, as the clipped copy of the call's
own edge chunk, exactly as one process reads it.  K5 then writes dk and dv
for all T + 2c key rows: the halo rows hold what the call's query chunks
owe the neighbour's keys (zeros for a phantom), and K4's text gradients
sum over the call's query chunks only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from a3t_tpu_torch.ops import native
from a3t_tpu_torch.ops.fused_attention import NEG, hash_bits, threshold

# draw offset of the text keep-mask (banded_attention.py:39)
TEXT_DRAW = 1 << 20
# a fully masked text block stands in for missing text (banded_attention.py
# :469-475)
EMPTY_TEXT = 128
LIBRARIES = {"banded_attention_fwd": ("banded_attention_fwd.cu",),
             "banded_attention_bwd_dq": ("banded_attention_bwd_dq.cu",),
             "banded_attention_bwd_dkv": ("banded_attention_bwd_dkv.cu",)}

# query rows per CTA of K3 and K4: the fp32 kernels' tiles of 64 and 32,
# the bf16 kernels' two warpgroups of 64
FWD_ROWS = {torch.float32: 64, torch.bfloat16: 128}
DQ_ROWS = {torch.float32: 32, torch.bfloat16: 128}

# kernel launches since the last reset (launches only, not plain-version
# calls): K3 forward, K4 dq pass, K5 dk/dv pass
LAUNCHES_BANDED_FWD = 0
LAUNCHES_BANDED_DQ = 0
LAUNCHES_BANDED_DKV = 0


def reset_launches() -> None:
    global LAUNCHES_BANDED_FWD, LAUNCHES_BANDED_DQ, LAUNCHES_BANDED_DKV
    LAUNCHES_BANDED_FWD = LAUNCHES_BANDED_DQ = LAUNCHES_BANDED_DKV = 0


def _scale(d: int) -> float:
    return float(np.float32(1.0 / np.sqrt(d)))


def _keep_scale(rate: float) -> float:
    return float(np.float32(1.0 / (1.0 - rate)))


class Place(NamedTuple):
    """A call's place in one process's call: its heads start at ``head0``
    of ``heads`` (None: the call's own H), its query chunks at ``chunk0``
    of ``nc_all`` (None: the call's own nc)."""

    head0: int = 0
    heads: Optional[int] = None
    chunk0: int = 0
    nc_all: Optional[int] = None


def _place(h: int, nc: int, head0: int = 0, heads=None,
           chunks=None) -> Place:
    """The :class:`Place` of a call of ``h`` heads and ``nc`` query chunks
    from the wrapper's ``head0``, ``heads`` and ``chunks``, checked."""
    chunk0, nc_all = (0, nc) if chunks is None else map(int, chunks)
    heads = h if heads is None else int(heads)
    if not (0 <= head0 and head0 + h <= heads):
        raise ValueError(f"head0={head0}: heads {head0}..{head0 + h - 1} "
                         f"outside the {heads} heads")
    if not (0 <= chunk0 and chunk0 + nc <= nc_all):
        raise ValueError(f"chunks={tuple(chunks)}: query chunks {chunk0}.."
                         f"{chunk0 + nc - 1} outside the {nc_all} chunks")
    return Place(int(head0), heads, chunk0, nc_all)


def _reach(nc: int, chunks=None) -> tuple:
    """(first, lo, hi): the key tensor's chunk index of query chunk 0 (1
    with halos, 0 without) and the neighbour chunks a call reads, lo .. hi
    in query-chunk numbers (-1 and nc are the halos where they are real;
    a neighbour outside is a phantom, read as the clipped copy)."""
    if chunks is None:
        return 0, 0, nc - 1
    chunk0, nc_all = chunks
    return (1, -1 if chunk0 > 0 else 0,
            nc if chunk0 + nc < nc_all else nc - 1)


def _chunks(x: torch.Tensor, c: int) -> torch.Tensor:
    """(B, H, T, d) -> (B, H, nc, c, d) in float32."""
    b, h, t, d = x.shape
    return x.float().reshape(b, h, t // c, c, d)


def _band(xc: torch.Tensor, chunks=None) -> torch.Tensor:
    """(B, H, n, c, d) -> (B, H, nc, 3c, d): chunks i-1, i, i+1 of each
    query chunk i, the missing edge neighbours clipped to chunk 0 and nc-1
    (the TPU kernels' BlockSpec index maps clip, banded_attention.py:42-45).
    With ``chunks`` the n = nc + 2 chunks hold the halos, which stand for
    chunks -1 and nc unless they are phantoms."""
    nc = xc.shape[2] - (0 if chunks is None else 2)
    first, lo, hi = _reach(nc, chunks)
    i = torch.arange(nc, device=xc.device)
    return torch.cat([xc[:, :, (i - 1).clamp(lo, hi) + first],
                      xc[:, :, i + first],
                      xc[:, :, (i + 1).clamp(lo, hi) + first]], dim=3)


def band_mask(spm: torch.Tensor, c: int, chunks=None) -> torch.Tensor:
    """(B, T) speech-key validity (B, T + 2c with ``chunks``) -> (B, nc, 3c)
    bool band validity per query chunk, phantom edge chunks false
    (banded_attention.py:482-486)."""
    m = spm.reshape(spm.shape[0], -1, c) > 0
    nc = m.shape[1] - (0 if chunks is None else 2)
    first, lo, hi = _reach(nc, chunks)
    i = torch.arange(nc, device=spm.device)

    def block(nb):
        real = ((nb >= lo) & (nb <= hi)).view(1, nc, 1)
        return m[:, nb.clamp(lo, hi) + first] & real

    return torch.cat([block(i - 1), block(i), block(i + 1)], dim=2)


def _lanes(b: int, h: int, chunks: torch.Tensor, nc: int,
           place: Place = Place()) -> torch.Tensor:
    """(B, H, len(chunks), 1, 1) int64 dropout lanes (b * heads + head0 +
    h) * nc_all + chunk0 + chunk."""
    dev = chunks.device
    heads = h if place.heads is None else place.heads
    nc_all = nc if place.nc_all is None else place.nc_all
    bh = (torch.arange(b, dtype=torch.int64, device=dev).view(b, 1) * heads
          + place.head0
          + torch.arange(h, dtype=torch.int64, device=dev).view(1, h))
    return (bh[:, :, None] * nc_all + place.chunk0
            + chunks.view(1, 1, -1))[..., None, None]


def band_keep(b: int, h: int, nc: int, c: int, seed: int, rate: float,
              chunks: torch.Tensor | None = None, device=None,
              place: Place = Place()) -> torch.Tensor:
    """(B, H, n, c, 3c) bool band keep-mask of query chunks ``chunks``
    (default all nc), counter row * 3c + col under each chunk's lane."""
    if chunks is None:
        chunks = torch.arange(nc, dtype=torch.int64, device=device)
    ctr = torch.arange(c * 3 * c, dtype=torch.int64,
                       device=chunks.device).view(c, 3 * c)
    return hash_bits(ctr, seed, _lanes(b, h, chunks, nc, place)) \
        >= threshold(rate)


def text_keep(b: int, h: int, nc: int, c: int, tt: int, seed: int,
              rate: float, device=None,
              place: Place = Place()) -> torch.Tensor:
    """(B, H, nc, c, tt) bool text keep-mask, counter row * tt + col + 2^20."""
    chunks = torch.arange(nc, dtype=torch.int64, device=device)
    ctr = torch.arange(c * tt, dtype=torch.int64,
                       device=device).view(c, tt) + TEXT_DRAW
    return hash_bits(ctr, seed, _lanes(b, h, chunks, nc, place)) \
        >= threshold(rate)


def _scores(q, k, k_text, txm, spm, c: int, chunks=None):
    """Masked band and text scores (B, H, nc, c, 3c) / (.., tt), float32,
    with the chunked q and the band k."""
    b, h, t, d = q.shape
    qc = _chunks(q, c)
    kb = _band(_chunks(k, c), chunks)
    scale = _scale(d)
    band = torch.einsum("bhncd,bhnkd->bhnck", qc, kb) * scale
    text = torch.einsum("bhncd,bhsd->bhncs", qc, k_text.float()) * scale
    bm = band_mask(spm, c, chunks)[:, None, :, None, :]
    tm = (txm > 0).view(b, 1, 1, 1, -1)
    band = torch.where(bm, band, torch.full_like(band, NEG))
    text = torch.where(tm, text, torch.full_like(text, NEG))
    return qc, kb, band, text


def banded_attention_reference(q, k, v, k_text, v_text, txm, spm,
                               window: int, seed: int = 0, rate: float = 0.0,
                               head0: int = 0, heads=None, chunks=None):
    """Plain PyTorch version of K3: (out (B, H, T, d) in q's dtype, lse
    (B, H, T) float32).

    q (B, H, T, d); k/v (B, H, T, d), or (B, H, T + 2c, d) with ``chunks``
    (module docstring); k_text/v_text (B, H, tt, d) with tt > 0; txm (B,
    tt) and spm (B, T) or (B, T + 2c), nonzero = valid.
    """
    b, h, t, d = q.shape
    c = window // 2
    nc, tt = t // c, k_text.shape[2]
    pl = _place(h, nc, head0, heads, chunks)
    qc, kb, band, text = _scores(q, k, k_text, txm, spm, c, chunks)
    m = torch.maximum(band.amax(-1, keepdim=True), text.amax(-1, keepdim=True))
    eb = torch.exp(band - m)
    et = torch.exp(text - m)
    denom = eb.sum(-1, keepdim=True) + et.sum(-1, keepdim=True)
    if rate > 0.0:
        ks = _keep_scale(rate)
        eb = eb * (band_keep(b, h, nc, c, seed, rate, device=q.device,
                             place=pl).float() * ks)
        et = et * (text_keep(b, h, nc, c, tt, seed, rate, device=q.device,
                             place=pl).float() * ks)
    vb = _band(_chunks(v, c), chunks)
    res = (torch.einsum("bhnck,bhnkd->bhncd", eb, vb)
           + torch.einsum("bhncs,bhsd->bhncd", et, v_text.float())) / denom
    lse = (m + torch.log(denom)).reshape(b, h, t)
    return res.reshape(b, h, t, d).to(q.dtype), lse


def banded_attention_bwd_dq_reference(q, k, v, k_text, v_text, txm, spm,
                                      window: int, seed: int, rate: float,
                                      g, lse, delta, head0: int = 0,
                                      heads=None, chunks=None):
    """Plain PyTorch version of K4 (``_bwd_dq_call``, :172-283): (dq in q's
    dtype, dk_text, dv_text float32 (B, H, tt, d)), from the forward's
    inputs, the output gradient g, lse and delta (B, H, T) float32."""
    b, h, t, d = q.shape
    c = window // 2
    nc, tt = t // c, k_text.shape[2]
    pl = _place(h, nc, head0, heads, chunks)
    qc, kb, band, text = _scores(q, k, k_text, txm, spm, c, chunks)
    vb = _band(_chunks(v, c), chunks)
    gc = _chunks(g, c)
    l_i = lse.reshape(b, h, nc, c, 1)
    d_i = delta.reshape(b, h, nc, c, 1)
    pb = torch.exp(band - l_i)
    pt = torch.exp(text - l_i)
    dp_b = torch.einsum("bhncd,bhnkd->bhnck", gc, vb)
    dp_t = torch.einsum("bhncd,bhsd->bhncs", gc, v_text.float())
    pt_d = pt
    if rate > 0.0:
        ks = _keep_scale(rate)
        keep_b = band_keep(b, h, nc, c, seed, rate, device=q.device,
                           place=pl).float() * ks
        keep_t = text_keep(b, h, nc, c, tt, seed, rate, device=q.device,
                           place=pl).float() * ks
        dp_b = dp_b * keep_b
        dp_t = dp_t * keep_t
        pt_d = pt * keep_t
    ds_b = pb * (dp_b - d_i)
    ds_t = pt * (dp_t - d_i)
    scale = _scale(d)
    dq = (torch.einsum("bhnck,bhnkd->bhncd", ds_b, kb)
          + torch.einsum("bhncs,bhsd->bhncd", ds_t, k_text.float())) * scale
    dkt = torch.einsum("bhncs,bhncd->bhsd", ds_t, qc) * scale
    dvt = torch.einsum("bhncs,bhncd->bhsd", pt_d, gc)
    return dq.reshape(b, h, t, d).to(q.dtype), dkt, dvt


def banded_attention_bwd_dkv_reference(q, k, v, spm, window: int, seed: int,
                                       rate: float, g, lse, delta,
                                       head0: int = 0, heads=None,
                                       chunks=None):
    """Plain PyTorch version of K5 (``_bwd_dkv_call``, :286-388): (dk, dv) in
    q's dtype, k's shape.  Key chunk j takes query chunks j + off, off = -1,
    0, 1, that exist, masks its keys by its own validity only, and
    regenerates the query chunk's band keep-mask at block 1 - off.  With
    ``chunks`` the key chunks run from -1 to nc (the halos); a phantom halo
    gets zeros."""
    b, h, t, d = q.shape
    c = window // 2
    nc = t // c
    pl = _place(h, nc, head0, heads, chunks)
    first, lo, hi = _reach(nc, chunks)
    scale = _scale(d)
    qc, gc = _chunks(q, c), _chunks(g, c)
    kc, vc = _chunks(k, c), _chunks(v, c)
    nk = kc.shape[2]
    l_c = lse.reshape(b, h, nc, c, 1)
    d_c = delta.reshape(b, h, nc, c, 1)
    kmask = (spm.reshape(b, nk, c) > 0)[:, None, :, None, :]
    j = torch.arange(nk, dtype=torch.int64, device=q.device) - first
    dk = torch.zeros_like(kc)
    dv = torch.zeros_like(vc)
    for off in (-1, 0, 1):
        i_q = j + off
        src = i_q.clamp(0, nc - 1)
        w = ((i_q >= 0) & (i_q <= nc - 1) & (j >= lo) & (j <= hi)) \
            .float().view(1, 1, nk, 1, 1)
        qq, gg = qc[:, :, src], gc[:, :, src]
        s = torch.einsum("bhnrd,bhnkd->bhnrk", qq, kc) * scale
        s = torch.where(kmask, s, torch.full_like(s, NEG))
        p = torch.exp(s - l_c[:, :, src])
        dp = torch.einsum("bhnrd,bhnkd->bhnrk", gg, vc)
        p_d = p
        if rate > 0.0:
            blk = 1 - off
            keep = band_keep(b, h, nc, c, seed, rate, chunks=i_q, place=pl)[
                ..., blk * c:(blk + 1) * c].float() * _keep_scale(rate)
            dp = dp * keep
            p_d = p * keep
        ds = p * (dp - d_c[:, :, src])
        dv = dv + w * torch.einsum("bhnrk,bhnrd->bhnkd", p_d, gg)
        dk = dk + w * scale * torch.einsum("bhnrk,bhnrd->bhnkd", ds, qq)
    return (dk.reshape(k.shape).to(q.dtype),
            dv.reshape(v.shape).to(q.dtype))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point of library ``name``, built and loaded on first use:
    (pointers, ints) per kernel."""
    n_ptr, n_int = {"banded_attention_fwd": (9, 12),
                    "banded_attention_bwd_dq": (14, 13),
                    "banded_attention_bwd_dkv": (9, 11)}[name]
    return native.bind(name, LIBRARIES[name], f"a3t_{name}", n_ptr, n_int)


def fwd_grid(b: int, h: int, t: int, window: int, dtype):
    """K3's grid as the kernel launches it: (query-row tiles of a chunk,
    chunks, b * h)."""
    c = window // 2
    return -(-c // FWD_ROWS[dtype]), t // c, b * h


def dq_grid(b: int, h: int, t: int, window: int, dtype):
    """K4's grid as the kernel launches it: (query-row tiles of a chunk,
    chunks, b * h).  It writes one text-gradient partial per CTA of a
    (b, h), grid[0] * grid[1] of them."""
    c = window // 2
    return -(-c // DQ_ROWS[dtype]), t // c, b * h


def _flags(q, seed: int, rate: float):
    """The kernels' trailing arguments: scale, seed, threshold, keep scale,
    dropout on/off."""
    return (_scale(q.shape[-1]), seed & 0xFFFFFFFF, threshold(rate),
            _keep_scale(rate), int(rate > 0.0))


def _place_ints(pl: Place, chunks) -> tuple:
    """The kernels' place arguments: head0, H_all, chunk0, nc_all, and
    whether K/V and the speech mask carry the halos."""
    return pl.head0, pl.heads, pl.chunk0, pl.nc_all, int(chunks is not None)


def _dtype_code(q) -> int:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"banded_attention kernels take float32 or bfloat16, "
                        f"not {q.dtype}")
    return 0 if q.dtype == torch.float32 else 1


def _key_rows(t: int, window: int, chunks) -> int:
    """The rows of K, V and the speech mask: T, or T + 2c with the halos."""
    return t if chunks is None else t + 2 * (window // 2)


def _check(q, window: int, named, masks=()):
    """Raise unless the kernels take q (B, H, T, d), ``named`` ((name,
    tensor, shape), q's dtype) and ``masks`` ((name, tensor, shape), int32)
    as they are."""
    b, h, t, d = q.shape
    c = window // 2
    if c <= 0 or t % c != 0:
        raise ValueError(f"T={t} not a multiple of half-window {c}")
    if not 0 < d <= 256:
        raise ValueError(f"head width {d} outside 1..256")
    _dtype_code(q)
    for name, x, shape in named:
        if x.dtype != q.dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {tuple(x.shape)} {x.dtype}, expected "
                             f"{shape} {q.dtype}")
    for name, x, shape in masks:
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {tuple(x.shape)} {x.dtype}, expected "
                             f"{shape} int32")
    tensors = [q] + [x for _, x, _ in named] + [x for _, x, _ in masks]
    if any(x.device != q.device for x in tensors):
        raise ValueError("banded_attention inputs lie on different devices")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("banded_attention kernels take contiguous tensors")


def _check_rows(q, named):
    """Raise unless each of ``named`` is a contiguous (B, H, T) float32."""
    b, h, t, _ = q.shape
    for name, x in named:
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, t)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name}: {tuple(x.shape)} {x.dtype}, expected "
                             f"contiguous {(b, h, t)} float32 on {q.device}")


def _launch(name: str, ptrs, ints, flags, q) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry(name)(*ptrs, *ints, *flags, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _kernel_fwd(q, k, v, k_text, v_text, txm, spm, window, seed, rate,
                head0=0, heads=None, chunks=None):
    global LAUNCHES_BANDED_FWD
    b, h, t, d = q.shape
    tt = k_text.shape[2]
    tk = _key_rows(t, window, chunks)
    pl = _place(h, t // (window // 2), head0, heads, chunks)
    _check(q, window, (("k", k, (b, h, tk, d)), ("v", v, (b, h, tk, d)),
                       ("k_text", k_text, (b, h, tt, d)),
                       ("v_text", v_text, (b, h, tt, d))),
           (("txm", txm, (b, tt)), ("spm", spm, (b, tk))))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch("banded_attention_fwd",
            [x.data_ptr() for x in (q, k, v, k_text, v_text, txm, spm, out,
                                    lse)],
            (b, h, t, d, window // 2, tt, _dtype_code(q),
             *_place_ints(pl, chunks)),
            _flags(q, seed, rate), q)
    LAUNCHES_BANDED_FWD += 1
    return out, lse


def _kernel_bwd_dq(q, k, v, k_text, v_text, txm, spm, window, seed, rate, g,
                   lse, delta, text_grads: bool = True, head0=0, heads=None,
                   chunks=None):
    global LAUNCHES_BANDED_DQ
    b, h, t, d = q.shape
    tt = k_text.shape[2]
    tk = _key_rows(t, window, chunks)
    pl = _place(h, t // (window // 2), head0, heads, chunks)
    _check(q, window, (("k", k, (b, h, tk, d)), ("v", v, (b, h, tk, d)),
                       ("g", g, (b, h, t, d)),
                       ("k_text", k_text, (b, h, tt, d)),
                       ("v_text", v_text, (b, h, tt, d))),
           (("txm", txm, (b, tt)), ("spm", spm, (b, tk))))
    _check_rows(q, (("lse", lse), ("delta", delta)))
    dq = torch.empty_like(q)
    dkt = dvt = parts = None
    ptrs = [0, 0, 0]
    if text_grads:
        # one partial (tt, d) sum per CTA, summed in a fixed order by the
        # library's second launch
        rows, n_chunks, _ = dq_grid(b, h, t, window, q.dtype)
        n_parts = rows * n_chunks
        parts = torch.empty((2, b, h, n_parts, tt, d), dtype=torch.float32,
                            device=q.device)
        dkt = torch.empty((b, h, tt, d), dtype=torch.float32, device=q.device)
        dvt = torch.empty_like(dkt)
        ptrs = [dkt.data_ptr(), dvt.data_ptr(), parts.data_ptr()]
    _launch("banded_attention_bwd_dq",
            [x.data_ptr() for x in (q, k, v, k_text, v_text, txm, spm, g, lse,
                                    delta, dq)] + ptrs,
            (b, h, t, d, window // 2, tt, _dtype_code(q), int(text_grads),
             *_place_ints(pl, chunks)),
            _flags(q, seed, rate), q)
    LAUNCHES_BANDED_DQ += 1
    return dq, dkt, dvt


def _kernel_bwd_dkv(q, k, v, spm, window, seed, rate, g, lse, delta,
                    head0=0, heads=None, chunks=None):
    global LAUNCHES_BANDED_DKV
    b, h, t, d = q.shape
    tk = _key_rows(t, window, chunks)
    pl = _place(h, t // (window // 2), head0, heads, chunks)
    _check(q, window, (("k", k, (b, h, tk, d)), ("v", v, (b, h, tk, d)),
                       ("g", g, (b, h, t, d))), (("spm", spm, (b, tk)),))
    _check_rows(q, (("lse", lse), ("delta", delta)))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("banded_attention_bwd_dkv",
            [x.data_ptr() for x in (q, k, v, spm, g, lse, delta, dk, dv)],
            (b, h, t, d, window // 2, _dtype_code(q),
             *_place_ints(pl, chunks)),
            _flags(q, seed, rate), q)
    LAUNCHES_BANDED_DKV += 1
    return dk, dv


# ---------------------------------------------------------------------------
# the wrappers: the plain version for CPU tensors, the kernel for CUDA
# ---------------------------------------------------------------------------

def _on_device(q, rate: float) -> str:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"banded_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return q.device.type


def banded_attention_fwd(q, k, v, k_text, v_text, txm, spm, window: int,
                         seed: int = 0, rate: float = 0.0, head0: int = 0,
                         heads=None, chunks=None):
    """(out, lse): the plain version for CPU tensors, K3 for CUDA."""
    at = dict(head0=head0, heads=heads, chunks=chunks)
    if _on_device(q, rate) == "cpu":
        return banded_attention_reference(q, k, v, k_text, v_text, txm, spm,
                                          window, seed, rate, **at)
    return _kernel_fwd(q, k, v, k_text, v_text, txm, spm, window, seed, rate,
                       **at)


def banded_attention_bwd_dq(q, k, v, k_text, v_text, txm, spm, window: int,
                            seed: int, rate: float, g, lse, delta,
                            text_grads: bool = True, head0: int = 0,
                            heads=None, chunks=None):
    """(dq, dk_text, dv_text): the plain version for CPU tensors, K4 for
    CUDA; K4 leaves the text gradients out (None) unless ``text_grads``."""
    at = dict(head0=head0, heads=heads, chunks=chunks)
    if _on_device(q, rate) == "cpu":
        return banded_attention_bwd_dq_reference(
            q, k, v, k_text, v_text, txm, spm, window, seed, rate, g, lse,
            delta, **at)
    return _kernel_bwd_dq(q, k, v, k_text, v_text, txm, spm, window, seed,
                          rate, g, lse, delta, text_grads, **at)


def banded_attention_bwd_dkv(q, k, v, spm, window: int, seed: int,
                             rate: float, g, lse, delta, head0: int = 0,
                             heads=None, chunks=None):
    """(dk, dv): the plain version for CPU tensors, K5 for CUDA."""
    at = dict(head0=head0, heads=heads, chunks=chunks)
    if _on_device(q, rate) == "cpu":
        return banded_attention_bwd_dkv_reference(q, k, v, spm, window, seed,
                                                  rate, g, lse, delta, **at)
    return _kernel_bwd_dkv(q, k, v, spm, window, seed, rate, g, lse, delta,
                           **at)


class BandedAttention(torch.autograd.Function):
    """K3 forward, K4 and K5 backward (their plain versions on the CPU), as
    the JAX package's ``custom_vjp`` binds the three Pallas calls.  Saves the
    inputs, ``out`` and ``lse``; the dropout masks are regenerated from the
    int seed."""

    @staticmethod
    def forward(ctx, q, k, v, k_text, v_text, txm, spm, window: int,
                seed: int, rate: float, at: dict):
        out, lse = banded_attention_fwd(q, k, v, k_text, v_text, txm, spm,
                                        window, seed, rate, **at)
        ctx.save_for_backward(q, k, v, k_text, v_text, txm, spm, out, lse)
        ctx.window, ctx.seed, ctx.rate, ctx.at = window, seed, rate, at
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, k_text, v_text, txm, spm, out, lse = ctx.saved_tensors
        g = g.contiguous()
        # delta = rowsum(g * out), outside the kernels as in the JAX
        # package (banded_attention.py:412-414)
        delta = (g.float() * out.float()).sum(-1)
        text_grads = ctx.needs_input_grad[3] or ctx.needs_input_grad[4]
        dq, dkt, dvt = banded_attention_bwd_dq(
            q, k, v, k_text, v_text, txm, spm, ctx.window, ctx.seed,
            ctx.rate, g, lse, delta, text_grads=text_grads, **ctx.at)
        dk, dv = banded_attention_bwd_dkv(q, k, v, spm, ctx.window, ctx.seed,
                                          ctx.rate, g, lse, delta, **ctx.at)
        if dkt is not None:
            dkt, dvt = dkt.to(k_text.dtype), dvt.to(v_text.dtype)
        return dq, dk, dv, dkt, dvt, None, None, None, None, None, None


def banded_attention(q, k, v, k_text, v_text, text_mask, window: int,
                     speech_mask=None, dropout_rate: float = 0.0,
                     seed: int = 0, head0: int = 0, heads=None,
                     chunks=None):
    """Banded attention of the speech queries, (B, H, T, d), differentiable
    through K4 and K5.

    Args mirror ``a3t_tpu.ops.banded_attention.banded_attention``
    (:426-489): q/k/v (B, H, T, d) with T a multiple of ``window // 2``;
    k_text/v_text (B, H, tt, d); text_mask (B, tt) and speech_mask (B, T)
    validity.  Dropout takes an int ``seed``, which the caller draws from
    its CPU generator (the JAX wrapper draws it from its rng).  ``head0``,
    ``heads`` and ``chunks = (chunk0, nc_all)``: the call's place in one
    process's call (module docstring); with ``chunks`` k, v and
    speech_mask carry the halos, (B, H, T + 2c, d) and (B, T + 2c), and
    k's gradient has k's shape.
    """
    b, h, t, d = q.shape
    c = window // 2
    if c <= 0 or t % c != 0:
        raise ValueError(f"T={t} not a multiple of half-window {c}")
    tk = _key_rows(t, window, chunks)
    if k.shape[2] != tk or v.shape[2] != tk:
        raise ValueError(f"k/v hold {k.shape[2]}/{v.shape[2]} rows, expected "
                         f"{tk} for T={t} and chunks={chunks}")
    _place(h, t // c, head0, heads, chunks)
    if k_text.shape[2] == 0:
        # speech only: a non-empty but fully masked text block
        k_text = q.new_zeros((b, h, EMPTY_TEXT, d))
        v_text = q.new_zeros((b, h, EMPTY_TEXT, d))
        text_mask = torch.zeros((b, EMPTY_TEXT), dtype=torch.bool,
                                device=q.device)
    txm = text_mask.to(torch.int32).contiguous()
    if speech_mask is None:
        spm = torch.ones((b, tk), dtype=torch.int32, device=q.device)
    else:
        spm = speech_mask.to(torch.int32).contiguous()
    at = dict(head0=int(head0), heads=heads,
              chunks=None if chunks is None else tuple(map(int, chunks)))
    return BandedAttention.apply(q, k, v, k_text, v_text, txm, spm, window,
                                 int(seed), float(dropout_rate), at)
