"""The design of the banded-attention backward kernels K4 and K5
(a3t_tpu_torch/csrc/banded_attention_bwd_dq.cu, _bwd_dkv.cu), held on the
CPU.

The CUDA kernels cannot run here, so these tests hold what their bf16
design adds to the function, against the plain versions and against the
JAX package's Pallas kernels (``_bwd_dq_call``, ``_bwd_dkv_call``) in
interpret mode:

* K5 rounds P_d and dS (scaled) to bf16 as the A operands of dv += P_d^T.G
  and dk += dS^T.Q; K4 rounds dS (scaled) to bf16 as the operand of
  dq += dS.K.  A model of those roundings stays within the bf16 tolerance
  that ``chip_smoke.py`` holds the kernels to, on valid rows and on fully
  masked rows (where p = 1 on every key) alike;
* K4 keeps the text keys' gradients in fp32: each CTA's partial over its
  128 query rows of a chunk, the partials summed in a fixed order.  That
  stays within the 1e-4 the text gradients are held to, and the fixed-order
  sum equals the plain version within 1e-6;
* K4's launch grid at the training shape.

The cases have a padded speech tail two chunks long, so the last chunk's
rows see no valid key (fully masked: speech only, or text all padding), the
phantom edge chunks, 5 text keys or the 128-key stand-in block, and dropout
rates 0 and 0.2.
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

# chip_smoke.py's tolerances: dq, dk, dv within 2e-2 of each one's largest
# |value| in bf16 (TOL_BWD_BF16), the fp32 text gradients within 1e-4
# (TOL_BWD_F32)
TOL_BWD_BF16 = 2e-2
TOL_TEXT = 1e-4
# the fixed-order partial sum adds the same fp32 products in another order
TOL_SUM = 1e-6
# query rows per K4 CTA in bf16: two warpgroups of 64
ROWS = ba.DQ_ROWS[torch.bfloat16]

CASES = {
    # c = 8, 6 chunks; entry 1: 4 valid chunks and its 5 text keys all
    # padding, so chunk 5's rows see no valid key
    "text": ((2, 2, 48, 16), 16, 5, (48, 32)),
    # c = 16, 6 chunks, speech only (the 128-key masked stand-in block);
    # entry 1's chunk 5 fully masked
    "speech_only": ((2, 2, 96, 64), 32, 0, (96, 64)),
}
SEED = 4321


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, returned in fp32."""
    return x.to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _case(name: str, rate: float):
    """bf16 inputs as the wrapper hands them to the kernels, the forward's
    lse, delta, and the Pallas kernels' two backward passes."""
    (b, h, t, d), window, tt, lengths = CASES[name]
    c = window // 2
    nc = t // c
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((b, h, t, d)).astype(np.float32)
                  for _ in range(4))
    if tt:
        kt, vt = (rng.standard_normal((b, h, tt, d)).astype(np.float32)
                  for _ in range(2))
        txm = np.ones((b, tt), np.int32)
        txm[1] = 0
    else:
        kt = vt = np.zeros((b, h, ba.EMPTY_TEXT, d), np.float32)
        txm = np.zeros((b, ba.EMPTY_TEXT), np.int32)
    spm = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    tq, tk, tv, tkt, tvt, tg = (torch.tensor(x).to(torch.bfloat16)
                                for x in (q, k, v, kt, vt, g))
    args = (tq, tk, tv, tkt, tvt, torch.tensor(txm), torch.tensor(spm),
            window, SEED, rate)
    out, lse = ba.banded_attention_reference(*args)
    delta = (tg.float() * out.float()).sum(-1)

    m = jnp.asarray(spm).reshape(b, nc, c)
    zero = jnp.zeros_like(m[:, :1])
    bandm = jnp.concatenate([jnp.concatenate([zero, m[:, :-1]], 1), m,
                             jnp.concatenate([m[:, 1:], zero], 1)],
                            2)[:, :, None, :]
    jq, jk, jv, jkt, jvt, jg = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                for x in (tq, tk, tv, tkt, tvt, tg))
    jtxm = jnp.asarray(txm)[:, None, :]
    jlse = jnp.asarray(lse.numpy()).reshape(b, h, nc, 1, c)
    jdelta = jnp.asarray(delta.numpy()).reshape(b, h, nc, 1, c)
    jseed = jnp.asarray([SEED], jnp.int32)
    dq, dkt, dvt = jba._bwd_dq_call(jq, jk, jv, jkt, jvt, jtxm, bandm, jg,
                                    jlse, jdelta, jseed, window, rate, True)
    dk, dv = jba._bwd_dkv_call(jq, jk, jv, m[:, :, None, :], jg, jlse, jdelta,
                               jseed, window, rate, True)
    pallas = [torch.tensor(np.asarray(x.astype(jnp.float32)))
              for x in (dq, dkt, dvt, dk, dv)]
    return args, tg, lse, delta, pallas


def _quantities(q, k, v, kt, vt, txm, spm, window, seed, rate, g, lse,
                delta):
    """The plain K4's fp32 quantities per chunk: chunked q and g, band keys,
    p_d of the text keys, ds (scaled) of the band and text keys."""
    b, h, t, d = q.shape
    c = window // 2
    nc, tt = t // c, kt.shape[2]
    qc, kb, band, text = ba._scores(q, k, kt, txm, spm, c)
    vb = ba._band(ba._chunks(v, c))
    gc = ba._chunks(g, c)
    l_i = lse.reshape(b, h, nc, c, 1)
    d_i = delta.reshape(b, h, nc, c, 1)
    pb, pt = torch.exp(band - l_i), torch.exp(text - l_i)
    dp_b = torch.einsum("bhncd,bhnkd->bhnck", gc, vb)
    dp_t = torch.einsum("bhncd,bhsd->bhncs", gc, vt.float())
    pt_d = pt
    if rate > 0.0:
        ks = float(np.float32(1.0 / (1.0 - rate)))
        keep_b = ba.band_keep(b, h, nc, c, seed, rate).float() * ks
        keep_t = ba.text_keep(b, h, nc, c, tt, seed, rate).float() * ks
        dp_b, dp_t, pt_d = dp_b * keep_b, dp_t * keep_t, pt * keep_t
    scale = ba._scale(d)
    return (qc, gc, kb, pt_d, pb * (dp_b - d_i) * scale,
            pt * (dp_t - d_i) * scale)


def text_partials(x, y, rows: int = ROWS):
    """x^T . y summed over the rows of every chunk as K4 sums them: one fp32
    partial per CTA (chunk i, rows r0 .. r0 + rows - 1), the partials added
    in the order of the CTAs (chunk-major).  x (B, H, nc, c, tt), y (B, H,
    nc, c, d) -> (B, H, tt, d)."""
    b, h, nc, c, _ = x.shape
    acc = torch.zeros(b, h, x.shape[-1], y.shape[-1])
    for ci in range(nc):
        for r0 in range(0, c, rows):
            acc = acc + x[:, :, ci, r0:r0 + rows].transpose(-1, -2) \
                @ y[:, :, ci, r0:r0 + rows]
    return acc


def rounded_bwd_dq(q, k, v, kt, vt, txm, spm, window, seed, rate, g, lse,
                   delta):
    """The bf16 K4's arithmetic: ds in fp32 as the plain version has it,
    rounded to bf16 as dq's operand; dk_text and dv_text in fp32 through
    the 128-row partials.  (dq in q's dtype, dk_text, dv_text fp32)."""
    b, h, t, d = q.shape
    qc, gc, kb, pt_d, ds_b, ds_t = _quantities(
        q, k, v, kt, vt, txm, spm, window, seed, rate, g, lse, delta)
    dq = _bf16(ds_b) @ kb + _bf16(ds_t) @ kt.float()[:, :, None]
    return (dq.reshape(b, h, t, d).to(q.dtype), text_partials(ds_t, qc),
            text_partials(pt_d, gc))


def rounded_bwd_dkv(q, k, v, spm, window, seed, rate, g, lse, delta):
    """The bf16 K5's arithmetic: the plain version's p, p_d and ds (scaled)
    in fp32, P_d and dS rounded to bf16 as the operands of dv and dk; a
    missing neighbour adds nothing.  (dk, dv) in q's dtype."""
    b, h, t, d = q.shape
    c = window // 2
    nc = t // c
    scale = ba._scale(d)
    qc, gc = ba._chunks(q, c), ba._chunks(g, c)
    kc, vc = ba._chunks(k, c), ba._chunks(v, c)
    l_c = lse.reshape(b, h, nc, c, 1)
    d_c = delta.reshape(b, h, nc, c, 1)
    kmask = (spm.reshape(b, nc, c) > 0)[:, None, :, None, :]
    j = torch.arange(nc)
    dk, dv = torch.zeros_like(kc), torch.zeros_like(vc)
    for off in (-1, 0, 1):
        i_q = j + off
        src = i_q.clamp(0, nc - 1)
        w = ((i_q >= 0) & (i_q <= nc - 1)).float().view(1, 1, nc, 1, 1)
        qq, gg = qc[:, :, src], gc[:, :, src]
        s = torch.einsum("bhnrd,bhnkd->bhnrk", qq, kc) * scale
        p = torch.exp(torch.where(kmask, s, torch.full_like(s, ba.NEG))
                      - l_c[:, :, src])
        dp = torch.einsum("bhnrd,bhnkd->bhnrk", gg, vc)
        p_d = p
        if rate > 0.0:
            keep = ba.band_keep(b, h, nc, c, seed, rate, chunks=i_q)[
                ..., (1 - off) * c:(2 - off) * c].float() \
                * float(np.float32(1.0 / (1.0 - rate)))
            dp, p_d = dp * keep, p * keep
        ds = p * (dp - d_c[:, :, src]) * scale
        dv = dv + w * (_bf16(p_d).transpose(-1, -2) @ gg)
        dk = dk + w * (_bf16(ds).transpose(-1, -2) @ qq)
    return (dk.reshape(b, h, t, d).to(q.dtype),
            dv.reshape(b, h, t, d).to(q.dtype))


def _split_rel_err(got, want, rows):
    """max|got - want| / max|want| over the (B, T) rows where ``rows``
    holds, and apart over the others, each against its own largest |want|
    (chip_smoke.py's split); 0 for an empty set."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    errs = []
    for sel in (rows, ~rows):
        m = sel[:, None, :, None].expand_as(diff)
        errs.append(0.0 if not bool(sel.any()) else
                    (diff[m].max() / ref[m].max().clamp_min(1e-30)).item())
    return errs


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _fully_masked(txm, spm, c: int):
    """(B, T) bool: the query rows that see no valid band or text key."""
    seen = ba.band_mask(spm, c).any(-1) | (txm > 0).any(-1, keepdim=True)
    return (~seen).repeat_interleave(c, dim=1)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_k4_bf16_rounding_within_tolerance(name, rate):
    """dS in bf16 keeps K4's dq within 2e-2 of the plain version and of the
    Pallas kernel on valid and on fully masked rows; the fp32 text partials
    keep dk_text and dv_text within 1e-4."""
    args, g, lse, delta, pallas = _case(name, rate)
    got = rounded_bwd_dq(*args, g, lse, delta)
    want = ba.banded_attention_bwd_dq_reference(*args, g, lse, delta)
    masked = _fully_masked(args[5], args[6], args[7] // 2)
    assert bool(masked.any()) and not bool(masked.all())
    assert got[0].dtype == want[0].dtype == torch.bfloat16
    for ref in (want[0], pallas[0]):
        assert max(_split_rel_err(got[0], ref, masked)) <= TOL_BWD_BF16
    # the rounding is there, and it is small
    assert (got[0].float() - want[0].float()).abs().max().item() > 0.0
    for a, ref, pal in zip(got[1:], want[1:], pallas[1:3]):
        assert a.dtype == ref.dtype == torch.float32
        assert _rel_err(a, ref) <= TOL_TEXT
        assert _rel_err(a, pal) <= TOL_TEXT


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_k5_bf16_rounding_within_tolerance(name, rate):
    """P_d and dS in bf16 keep K5's dk and dv within 2e-2 of the plain
    version and of the Pallas kernel, on valid and on padded keys (whose
    gradients come from the fully masked rows, p = 1)."""
    args, g, lse, delta, pallas = _case(name, rate)
    q, k, v, spm, window = args[0], args[1], args[2], args[6], args[7]
    got = rounded_bwd_dkv(q, k, v, spm, window, SEED, rate, g, lse, delta)
    want = ba.banded_attention_bwd_dkv_reference(q, k, v, spm, window, SEED,
                                                 rate, g, lse, delta)
    keys = spm > 0
    for a, ref, pal in zip(got, want, pallas[3:]):
        assert a.dtype == ref.dtype == torch.bfloat16
        assert max(_split_rel_err(a, ref, keys)) <= TOL_BWD_BF16
        assert max(_split_rel_err(a, pal, keys)) <= TOL_BWD_BF16
        assert (a.float() - ref.float()).abs().max().item() > 0.0
        # padded keys get gradients from the fully masked rows
        pad = (~keys)[:, None, :, None].expand_as(ref)
        assert ref.float().abs()[pad].max().item() > 0.0


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("t,window", [(1024, 512), (800, 400)])
def test_text_partials_fixed_order_sum(t, window, rate):
    """The fixed-order sum of K4's per-CTA partials (128-row groups of each
    chunk: c = 256 gives 2 per chunk, c = 200 a group of 128 and one of 72)
    equals the plain dk_text and dv_text within 1e-6, in fp32."""
    b, h, d, tt = 1, 2, 16, 5
    rng = np.random.default_rng(t + int(10 * rate))
    q, k, v, g = (torch.tensor(rng.standard_normal((b, h, t, d)),
                               dtype=torch.float32) for _ in range(4))
    kt, vt = (torch.tensor(rng.standard_normal((b, h, tt, d)),
                           dtype=torch.float32) for _ in range(2))
    txm = torch.tensor([[1, 1, 1, 0, 1]], dtype=torch.int32)
    spm = (torch.arange(t)[None] < t - 3 * window // 4).to(torch.int32)
    args = (q, k, v, kt, vt, txm, spm, window, 11, rate)
    out, lse = ba.banded_attention_reference(*args)
    delta = (g * out).sum(-1)
    qc, gc, _, pt_d, _, ds_t = _quantities(*args, g, lse, delta)
    _, dkt, dvt = ba.banded_attention_bwd_dq_reference(*args, g, lse, delta)
    c = window // 2
    assert -(-c // ROWS) == 2
    assert _rel_err(text_partials(ds_t, qc), dkt) <= TOL_SUM
    assert _rel_err(text_partials(pt_d, gc), dvt) <= TOL_SUM


def test_dq_grid_at_the_training_shape():
    """bf16 at (4, 2, 8192, 192), window 512: K4 runs 512 CTAs of 128 rows,
    64 text-gradient partials per (b, h) (50 MB for 64 text keys, a quarter
    of the fp32 kernel's 256 partials of 32 rows)."""
    grid = ba.dq_grid(4, 2, 8192, 512, torch.bfloat16)
    assert grid == (2, 32, 8) and np.prod(grid) == 512
    n_parts = grid[0] * grid[1]
    assert n_parts == 64
    assert 2 * 8 * n_parts * 64 * 192 * 4 == 50_331_648
    assert ba.dq_grid(4, 2, 8192, 512, torch.float32) == (8, 32, 8)
    # a ragged chunk (c = 4) is one CTA, its tiles zero-filled
    assert ba.dq_grid(2, 2, 64, 8, torch.bfloat16) == (1, 16, 4)
