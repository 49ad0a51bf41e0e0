"""The design of the banded-attention forward kernel K3 in bf16
(a3t_tpu_torch/csrc/banded_attention_fwd.cu), held on the CPU.

The CUDA kernel cannot run here, so a torch model of its arithmetic runs in
its place: the exact tile order of the kernel (for each query chunk, the
band keys of chunks i-1, i, i+1 in 64-key tiles that never straddle a chunk,
the phantom neighbours read from the clipped chunk, then the text keys in
64-key tiles; keys past a chunk's end or past tt get -inf), an online
softmax across the tiles (a running max that starts at -inf, the first
tile's rescale 0, undropped row sums), the dropout keep-mask on p, and P
rounded to bf16 as the operand of O += P.V.  It is held against the plain
version and against the JAX package's Pallas ``_fwd_call`` in interpret
mode, within chip_smoke.py's tolerances: 2e-2 relative on out in bf16 (on
the rows with a valid key and apart on the fully masked rows, each against
its own largest value) and 1e-4 on lse.

The cases have padded speech tails, fully masked rows (speech only, or text
all padding), the phantom edge chunks, 3 or 5 text keys or the 128-key
stand-in block, a chunk of two tiles (c = 96: 64 keys and 32), and dropout
rates 0 and 0.2.  Also K3's launch grid at the training shape.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3t_tpu_torch.ops import banded_attention as ba

# the module, not the function that a3t_tpu.ops re-exports under its name
jba = importlib.import_module("a3t_tpu.ops.banded_attention")

# chip_smoke.py's tolerances: out within 2e-2 of its largest |value| in
# bf16 (TOL_BWD_BF16), lse within 1e-4 (TOL_F32)
TOL_OUT = 2e-2
TOL_LSE = 1e-4
KT = 64  # keys per tile
SEED = 97531

CASES = {
    # c = 8, 6 chunks; entry 1: 4 valid chunks and its 5 text keys all
    # padding, so chunk 5's rows see no valid key
    "text": ((2, 2, 48, 16), 16, 5, (48, 32)),
    # c = 16, 6 chunks, speech only (the 128-key masked stand-in block);
    # entry 1's chunk 5 fully masked
    "speech_only": ((2, 2, 96, 64), 32, 0, (96, 64)),
    # c = 96: each band block is a tile of 64 keys and one of 32; 3 text
    # keys, a padded tail inside the last chunk
    "two_tiles": ((1, 2, 288, 32), 192, 3, (248,)),
}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, returned in fp32."""
    return x.to(torch.bfloat16).float()


def tile_order(c: int, tt: int):
    """K3's key tiles over the columns [band (3c); text (tt)] of a query
    chunk: (column index, live) pairs of 64 keys each, the band blocks of
    chunks i-1, i, i+1 in tiles that never straddle a chunk, then the text
    keys; a key past a chunk's end or past tt is not live ("none")."""
    tiles = []
    for first, n in [(blk * c, c) for blk in range(3)] + [(3 * c, tt)]:
        for w0 in range(0, n, KT):
            j = torch.arange(w0, w0 + KT)
            live = j < n
            tiles.append((torch.where(live, first + j, 0), live))
    return tiles


def model_fwd(q, k, v, kt, vt, txm, spm, window: int, seed: int,
              rate: float):
    """K3's bf16 arithmetic over its tiles: (out bf16 (B, H, T, d), lse
    (B, H, T) fp32)."""
    b, h, t, d = q.shape
    c = window // 2
    nc, tt = t // c, kt.shape[2]
    qc = ba._chunks(q, c)                                  # (B, H, nc, c, d)
    keys = torch.cat([ba._band(ba._chunks(k, c)),
                      kt.float()[:, :, None].expand(b, h, nc, tt, d)], -2)
    vals = torch.cat([ba._band(ba._chunks(v, c)),
                      vt.float()[:, :, None].expand(b, h, nc, tt, d)], -2)
    valid = torch.cat([ba.band_mask(spm, c),
                       (txm > 0)[:, None, :].expand(b, nc, tt)], -1)
    keep = torch.ones(b, h, nc, c, 3 * c + tt)
    if rate > 0:
        keep = torch.cat([ba.band_keep(b, h, nc, c, seed, rate),
                          ba.text_keep(b, h, nc, c, tt, seed, rate)],
                         -1).float() * float(np.float32(1.0 / (1.0 - rate)))
    m = torch.full((b, h, nc, c, 1), -float("inf"))
    l = torch.zeros((b, h, nc, c, 1))
    o = torch.zeros((b, h, nc, c, d))
    for idx, live in tile_order(c, tt):
        kk = torch.where(live[:, None], keys[..., idx, :], 0.0)  # zero-filled
        vv = torch.where(live[:, None], vals[..., idx, :], 0.0)
        s = torch.einsum("bhncd,bhnkd->bhnck", qc, kk) * ba._scale(d)
        s = torch.where(valid[:, None, :, None, idx], s, ba.NEG)
        s = torch.where(live, s, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m == -float("inf"), 0.0, torch.exp(m - m_new))
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p = p * keep[..., idx]
        o = o * alpha + torch.einsum("bhnck,bhnkd->bhncd", _bf16(p), vv)
        m = m_new
    out = (o / l).reshape(b, h, t, d).to(torch.bfloat16)
    return out, (m + torch.log(l)).reshape(b, h, t)


@functools.lru_cache(maxsize=None)
def _case(name: str, rate: float):
    """bf16 inputs as the wrapper hands them to K3, and the Pallas kernel's
    (out, lse)."""
    (b, h, t, d), window, tt, lengths = CASES[name]
    c = window // 2
    nc = t // c
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    if tt:
        kt, vt = (rng.standard_normal((b, h, tt, d)).astype(np.float32)
                  for _ in range(2))
        txm = np.ones((b, tt), np.int32)
        if b > 1:
            txm[-1] = 0  # its text all padding
    else:
        kt = vt = np.zeros((b, h, ba.EMPTY_TEXT, d), np.float32)
        txm = np.zeros((b, ba.EMPTY_TEXT), np.int32)
    spm = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    tq, tk, tv, tkt, tvt = (torch.tensor(x).to(torch.bfloat16)
                            for x in (q, k, v, kt, vt))
    args = (tq, tk, tv, tkt, tvt, torch.tensor(txm), torch.tensor(spm),
            window, SEED, rate)
    m = jnp.asarray(spm).reshape(b, nc, c)
    zero = jnp.zeros_like(m[:, :1])
    bandm = jnp.concatenate([jnp.concatenate([zero, m[:, :-1]], 1), m,
                             jnp.concatenate([m[:, 1:], zero], 1)],
                            2)[:, :, None, :]
    jq, jk, jv, jkt, jvt = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                            for x in (tq, tk, tv, tkt, tvt))
    out, lse = jba._fwd_call(jq, jk, jv, jkt, jvt, jnp.asarray(txm)[:, None, :],
                             bandm, jnp.asarray([SEED], jnp.int32), window,
                             rate, True)
    pallas = (torch.tensor(np.asarray(out.astype(jnp.float32))),
              torch.tensor(np.asarray(lse)).reshape(b, h, t))
    return args, pallas


def _fully_masked(txm, spm, c: int):
    """(B, T) bool: the query rows that see no valid band or text key."""
    seen = ba.band_mask(spm, c).any(-1) | (txm > 0).any(-1, keepdim=True)
    return (~seen).repeat_interleave(c, dim=1)


def _split_rel_err(got, want, rows):
    """max|got - want| / max|want| over the (B, T) rows where ``rows``
    holds, and apart over the others, each against its own largest |want|;
    0 for an empty set."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    errs = []
    for sel in (rows, ~rows):
        m = sel[:, None, :, None].expand_as(diff)
        errs.append(0.0 if not bool(sel.any()) else
                    (diff[m].max() / ref[m].max().clamp_min(1e-30)).item())
    return errs


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_k3_bf16_tiles_within_tolerance(name, rate):
    """The tile-by-tile online softmax with P in bf16 stays within 2e-2 of
    the plain version and of the Pallas kernel on out (valid and fully
    masked rows apart) and within 1e-4 on lse."""
    args, (p_out, p_lse) = _case(name, rate)
    got, lse = model_fwd(*args)
    want, want_lse = ba.banded_attention_reference(*args)
    masked = _fully_masked(args[5], args[6], args[7] // 2)
    if name != "two_tiles":
        assert bool(masked.any()) and not bool(masked.all())
    assert got.dtype == want.dtype == torch.bfloat16
    for ref, ref_lse in ((want, want_lse), (p_out, p_lse)):
        assert max(_split_rel_err(got, ref, ~masked)) <= TOL_OUT
        assert (lse - ref_lse).abs().max().item() <= TOL_LSE
    # the rounding of P is there, and it is small
    assert (got.float() - want.float()).abs().max().item() > 0.0
    # a fully masked row's max is -1e30: p = 1 on all 3c + tt keys
    rows = masked[:, None, :].expand_as(lse)
    assert (lse[rows] <= -1e29).all() and (lse[~rows] > -1e29).all()


def test_fwd_grid_at_the_training_shape():
    """bf16 at (4, 2, 8192, 192), window 512: K3 runs 512 CTAs of 128 query
    rows (two per chunk of 256) on the 132 SMs; fp32 tiles of 64 rows."""
    grid = ba.fwd_grid(4, 2, 8192, 512, torch.bfloat16)
    assert grid == (2, 32, 8) and np.prod(grid) == 512
    assert ba.fwd_grid(4, 2, 8192, 512, torch.float32) == (4, 32, 8)
    # a ragged chunk (c = 4) is one CTA, its tiles zero-filled
    assert ba.fwd_grid(2, 2, 64, 8, torch.bfloat16) == (1, 16, 4)
