"""The port's banded attention (a3t_tpu_torch/ops/banded_attention.py): the
plain versions of K3, K4 and K5 against the Pallas kernels of
``a3t_tpu/ops/banded_attention.py`` run in interpret mode on the CPU, as
tests/test_ops.py runs them, at t = 32, d = 16, window 8 (c = 4, 8 chunks).

Each case has a padded speech tail of 5 chunks in one batch entry, so query
rows whose every band key is masked exist (speech-only, they are fully
masked), and an output gradient that is non-zero on those rows.  The port
follows the Pallas kernels there (clipped phantom chunks, -1e30 scores, no
credit for the phantom copy in K5).

Tolerances: fp32 atol 1e-5 on values of O(1..20) (the same fp32 products
summed in another order; measured <= 2e-6).  bf16 inputs (both sides read
the same bf16 values and compute in fp32, rounding their bf16 outputs once):
outputs within 2^-7 of each output's largest magnitude (one bf16 ulp at the
top of the range), fp32 text gradients atol 1e-5.  Dropout masks are the
interpret-mode hash, bit for bit, so rate 0.2 is held to the same
tolerances.  The kernels themselves run only on a card (``cuda`` marker).
"""

import functools
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu_torch.ops import banded_attention as ba

# the module, not the function that a3t_tpu.ops re-exports under its name
jba = importlib.import_module("a3t_tpu.ops.banded_attention")
jfa = importlib.import_module("a3t_tpu.ops.fused_attention")

B, H, T, D, WINDOW = 2, 2, 32, 16, 8
C, NC = WINDOW // 2, T // (WINDOW // 2)
ATOL = 1e-5
BF16_REL = 2.0 ** -7


def _inputs(tt: int, dtype=np.float32, seed: int = 0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                  for _ in range(4))
    kt, vt = (rng.standard_normal((B, H, tt, D)).astype(np.float32)
              for _ in range(2))
    tmask = np.ones((B, tt), bool)
    if tt:
        tmask[1, tt - 3:] = False
    smask = np.ones((B, T), bool)
    smask[0, 12:] = False  # valid through chunk 2; chunks 4..7 see no key
    if dtype != np.float32:
        q, k, v, g, kt, vt = (np.asarray(jnp.asarray(x, jnp.bfloat16)
                                         .astype(jnp.float32))
                              for x in (q, k, v, g, kt, vt))
    return dict(q=q, k=k, v=v, kt=kt, vt=vt, g=g, tmask=tmask, smask=smask)


def _jax_seed(key) -> int:
    """The seed JAX's wrapper draws from its dropout rng."""
    return int(jax.random.randint(key, (1,), minval=0,
                                  maxval=np.iinfo(np.int32).max,
                                  dtype=jnp.int32)[0])


def _jax_kernel_args(x, dtype):
    """The Pallas calls' arguments, prepared as JAX's wrapper prepares them
    (the 128-key masked block when there is no text)."""
    kt, vt, tmask = x["kt"], x["vt"], x["tmask"]
    if kt.shape[2] == 0:
        kt = np.zeros((B, H, ba.EMPTY_TEXT, D), np.float32)
        vt = kt.copy()
        tmask = np.zeros((B, ba.EMPTY_TEXT), bool)
    tt = kt.shape[2]
    txm = jnp.broadcast_to(jnp.asarray(tmask)[:, None, :].astype(jnp.int32),
                           (B, 1, tt))
    m = jnp.asarray(x["smask"]).astype(jnp.int32).reshape(B, NC, C)
    zero = jnp.zeros_like(m[:, :1])
    bandm = jnp.concatenate([jnp.concatenate([zero, m[:, :-1]], 1), m,
                             jnp.concatenate([m[:, 1:], zero], 1)],
                            2)[:, :, None, :]
    arrays = [jnp.asarray(a, dtype) for a in (x["q"], x["k"], x["v"], kt,
                                              vt)]
    return arrays, txm, bandm, m[:, :, None, :], tmask


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(dtype)


CASES = {
    "text-rate0": (8, 0.0, np.float32),
    "text-rate0.2": (8, 0.2, np.float32),
    "speech_only-rate0.2": (0, 0.2, np.float32),
    "text-rate0.2-bf16": (8, 0.2, jnp.bfloat16),
}


@functools.lru_cache(maxsize=None)
def _pallas(case: str):
    """The Pallas kernels' outputs for one case: out, lse, and the two
    backward passes on the case's cotangent (one interpret-mode call each)."""
    tt, rate, dtype = CASES[case]
    x = _inputs(tt, dtype)
    (q, k, v, kt, vt), txm, bandm, spm, tmask = _jax_kernel_args(x, dtype)
    seed = jnp.asarray([4321], jnp.int32)
    out, lse = jba._fwd_call(q, k, v, kt, vt, txm, bandm, seed, WINDOW, rate,
                             True)
    g = jnp.asarray(x["g"], dtype)
    delta = (g.astype(jnp.float32) * out.astype(jnp.float32)).sum(-1)
    delta = delta.reshape(B, H, NC, 1, C)
    dq, dkt, dvt = jba._bwd_dq_call(q, k, v, kt, vt, txm, bandm, g, lse,
                                    delta, seed, WINDOW, rate, True)
    dk, dv = jba._bwd_dkv_call(q, k, v, spm, g, lse, delta, seed, WINDOW,
                               rate, True)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return x, tmask, as_np(dict(out=out, lse=lse, delta=delta, dq=dq,
                                dkt=dkt, dvt=dvt, dk=dk, dv=dv))


def _port_args(case: str):
    tt, rate, dtype = CASES[case]
    x, tmask, ref = _pallas(case)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    kt = x["kt"] if tt else np.zeros((B, H, ba.EMPTY_TEXT, D), np.float32)
    vt = x["vt"] if tt else kt
    args = [_t(a, tdt) for a in (x["q"], x["k"], x["v"], kt, vt)]
    args += [torch.tensor(tmask).to(torch.int32),
             torch.tensor(x["smask"]).to(torch.int32), WINDOW, 4321, rate]
    return args, _t(x["g"], tdt), ref, tdt


def _close(got, want, tdt, err_msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=0, err_msg=err_msg,
                                   atol=BF16_REL * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_match_pallas(case):
    """Plain K3 (out, lse), K4 (dq, dk_text, dv_text) and K5 (dk, dv) on the
    Pallas kernels' own inputs (lse and delta included)."""
    args, g, ref, tdt = _port_args(case)
    out, lse = ba.banded_attention_reference(*args)
    assert out.dtype == tdt and lse.dtype == torch.float32
    _close(out, ref["out"], tdt, "out")
    # fully masked rows: lse is -1e30 in both (fp32 absorbs log(denom))
    np.testing.assert_allclose(lse.numpy(), ref["lse"].reshape(B, H, T),
                               atol=ATOL, rtol=1e-6)
    lse_p = torch.tensor(ref["lse"].reshape(B, H, T))
    delta = torch.tensor(ref["delta"].reshape(B, H, T))
    dq, dkt, dvt = ba.banded_attention_bwd_dq_reference(
        *args[:8], *args[8:], g, lse_p, delta)
    dk, dv = ba.banded_attention_bwd_dkv_reference(
        *args[:3], args[6], WINDOW, *args[8:], g, lse_p, delta)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert got.dtype == tdt
        _close(got, ref[name], tdt, name)
    if CASES[case][0]:  # the masked stand-in block's gradients are unused
        for name, got in (("dkt", dkt), ("dvt", dvt)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref[name], atol=ATOL,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["text-rate0", "speech_only-rate0.2"])
def test_wrapper_gradients_match_jax_grad(case):
    """banded_attention (wrapper + BandedAttention) and its autograd against
    JAX's banded_attention and jax.grad through its custom_vjp, with the
    seed JAX's wrapper draws; the cotangent weighs every row, fully masked
    ones included."""
    tt, rate, _ = CASES[case]
    x = _inputs(tt, seed=1)
    key = jax.random.PRNGKey(7)
    w = x["g"]

    def loss(q, k, v, kt, vt):
        out = jba.banded_attention(
            q, k, v, kt, vt, jnp.asarray(x["tmask"]), WINDOW,
            speech_mask=jnp.asarray(x["smask"]), dropout_rate=rate,
            dropout_rng=key if rate else None, interpret=True)
        return (out * w).sum(), out

    jin = [jnp.asarray(x[n]) for n in ("q", "k", "v", "kt", "vt")]
    (_, ref_out), ref_grads = jax.value_and_grad(
        loss, argnums=tuple(range(5)), has_aux=True)(*jin)

    tin = [torch.tensor(x[n]).requires_grad_()
           for n in ("q", "k", "v", "kt", "vt")]
    out = ba.banded_attention(*tin, torch.tensor(x["tmask"]), WINDOW,
                              speech_mask=torch.tensor(x["smask"]),
                              dropout_rate=rate,
                              seed=_jax_seed(key) if rate else 0)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), tin,
                                allow_unused=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=ATOL, rtol=0)
    for name, got, want in zip(("q", "k", "v", "k_text", "v_text"), grads,
                               ref_grads):
        want = np.asarray(want)
        if want.size:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                                       err_msg=name)


def test_keep_masks_are_the_pallas_interpret_masks():
    """Band and text keep bits of the plain rule equal the Pallas kernels'
    interpret-mode draws, for every lane (b, h, chunk), and K5's slices of a
    neighbour's band draw are that neighbour's columns."""
    rate, seed = 0.3, 2024
    band = ba.band_keep(B, H, NC, C, seed, rate)
    text = ba.text_keep(B, H, NC, C, 5, seed, rate)
    n_band = n_text = 0
    for bi in range(B):
        for hi in range(H):
            for ci in range(NC):
                lane = (bi * H + hi) * NC + ci
                jb = np.asarray(jfa._dropout_mask(
                    (C, 3 * C), rate, jnp.int32(seed), lane, True)) > 0
                jt = np.asarray(jfa._dropout_mask(
                    (C, 5), rate, jnp.int32(seed), lane, True,
                    offset=jba._TEXT_DRAW)) > 0
                n_band += int((band[bi, hi, ci].numpy() != jb).sum())
                n_text += int((text[bi, hi, ci].numpy() != jt).sum())
    assert n_band == 0 and n_text == 0
    assert 0.6 < band.float().mean().item() < 0.8
    # K5 regenerates query chunk j + off's draw and takes block 1 - off
    j = torch.arange(NC)
    for off in (-1, 0, 1):
        sub = ba.band_keep(B, H, NC, C, seed, rate, chunks=j + off)
        ok = (j + off >= 0) & (j + off < NC)
        assert torch.equal(sub[:, :, ok], band[:, :, (j + off)[ok]])


def test_wrapper_rules():
    q = torch.zeros(1, 2, 10, 4)
    kt = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError, match="multiple of half-window"):
        ba.banded_attention(q, q, q, kt, kt, torch.ones(1, 3), 8)
    with pytest.raises(ValueError, match="dropout rate"):
        ba.banded_attention_fwd(q, q, q, kt, kt, torch.ones(1, 3), None, 8,
                                0, 1.0)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """K3, K4 and K5 against their plain versions on the card (fp32 and
    bf16, rates 0 and 0.2, fully masked rows); relative to each output's
    largest magnitude, 1e-4 in fp32 and 2e-2 in bf16 (chip_smoke.py's
    tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for case in CASES:
        args, g, _, tdt = _port_args(case)
        args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
        g = g.cuda()
        out, lse = ba.banded_attention_fwd(*args)
        ref, ref_lse = ba.banded_attention_reference(*args)
        delta = (g.float() * out.float()).sum(-1)
        got = ba.banded_attention_bwd_dq(*args, g, lse, delta) \
            + ba.banded_attention_bwd_dkv(*args[:3], args[6], *args[7:], g,
                                          lse, delta)
        want = ba.banded_attention_bwd_dq_reference(*args, g, lse, delta) \
            + ba.banded_attention_bwd_dkv_reference(*args[:3], args[6],
                                                    *args[7:], g, lse, delta)
        tol = 1e-4 if tdt == torch.float32 else 2e-2
        for a, w in [(out, ref)] + list(zip(got, want)):
            err = (a.float() - w.float()).abs().max() / w.float().abs().max()
            assert err.item() <= tol, case
        assert (lse - ref_lse).abs().max().item() <= 1e-4
