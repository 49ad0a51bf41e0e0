"""The design of the fused-attention kernels K1 and K2 (a3t_tpu_torch/csrc/
fused_attention_fwd.cu, _bwd.cu), held on the CPU.

The CUDA kernels cannot run here, so these tests hold what their design
adds to the function, against the plain versions and against the JAX
package's Pallas kernels in interpret mode:

* the bf16 kernels round P (forward, per 64-key tile of the online
  softmax), P_d and ds (backward) to bf16 as wgmma operands, and K2's dq
  pass reads ds as the bf16 dbias.  A model of those roundings stays within
  the bf16 tolerances that ``chip_smoke.py`` holds the kernels to;
* K1 splits the keys of a small grid into ranges whose partials (max, sum,
  unnormalised output) are combined in a fixed order: the combine equals
  the plain forward;
* K1's planner fills 132 SMs at the serving shapes and does not split the
  training shape.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3t_tpu.ops.fused_attention import _bwd_call, _fwd_call
from a3t_tpu_torch.ops import fused_attention as fa

# chip_smoke.py's bf16 tolerances: out within 2e-2 (one bf16 ulp at
# |out| < 4), each gradient within 2e-2 of its largest |value|
TOL_BF16 = 2e-2
TOL_BWD_BF16 = 2e-2
# the split combine sums the same fp32 terms in another order
TOL_COMBINE = 1e-6


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, returned in fp32."""
    return x.to(torch.bfloat16).float()


def _inputs(seed, b, h, l, d, pad):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, l, d)).astype(np.float32)
                  for _ in range(4))
    bias = rng.standard_normal((b, h, l, l)).astype(np.float32)
    mask = np.ones((b, l), bool)
    if pad:
        mask[-1, l - pad:] = False
    return q, k, v, g, bias, mask


def _scores(q, k, bias, mask):
    """(s with masked keys at -1e30, valid (B, 1, 1, L)) in fp32."""
    b, h, l, d = q.shape
    scale = float(np.float32(1.0 / np.sqrt(d)))
    s = (q.float() @ k.float().transpose(-1, -2) + bias.float()) * scale
    valid = (mask.reshape(b, l) > 0).view(b, 1, 1, l)
    return torch.where(valid, s, torch.full_like(s, fa.NEG)), valid, scale


def _keep_weight(valid, b, h, l, seed, rate):
    """valid * keep / (1 - rate) as fp32 (B, H, L, L)."""
    w = valid.expand(b, h, l, l).float()
    if rate > 0.0:
        w = w * fa.keep_mask(b, h, l, seed, rate).float() \
            * float(np.float32(1.0 / (1.0 - rate)))
    return w


def rounded_fwd(q, k, v, bias, mask, seed, rate, tile=64):
    """The bf16 K1's arithmetic: an online softmax over key tiles of 64 in
    fp32, with the tile's exp(s - running max) * keep / (1 - rate) rounded
    to bf16 before P.V; (out in q's dtype, lse (B, H, 1, L))."""
    b, h, l, d = q.shape
    s, valid, _ = _scores(q, k, bias, mask)
    w = _keep_weight(valid, b, h, l, seed, rate)
    m = torch.full((b, h, l, 1), -math.inf)
    den = torch.zeros(b, h, l, 1)
    acc = torch.zeros(b, h, l, d)
    for c0 in range(0, l, tile):
        st = s[..., c0:c0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _bf16(p * w[..., c0:c0 + tile]) \
            @ v.float()[..., c0:c0 + tile, :]
        m = m_new
    return (acc / den).to(q.dtype), (m + torch.log(den))[..., 0][:, :, None]


def rounded_bwd(q, k, v, bias, mask, seed, rate, out, lse, g):
    """The bf16 K2's arithmetic: p, dp and ds in fp32 as the plain version
    has them, P_d and ds rounded to bf16 as the operands of dv, dk and dq
    (dq reads the bf16 dbias); (dq, dk, dv, dbias) in the inputs' dtypes."""
    b, h, l, d = q.shape
    s, valid, scale = _scores(q, k, bias, mask)
    p = torch.where(valid, torch.exp(s - lse[:, :, 0, :, None]),
                    torch.zeros_like(s))
    w = _keep_weight(valid, b, h, l, seed, rate)
    gf = g.float()
    delta = (gf * out.float()).sum(-1, keepdim=True)
    p_d = p * w
    dp = (gf @ v.float().transpose(-1, -2)) * (w if rate > 0.0 else 1.0)
    ds = p * (dp - delta) * scale
    dv = _bf16(p_d).transpose(-1, -2) @ gf
    dk = _bf16(ds).transpose(-1, -2) @ q.float()
    dq = _bf16(ds) @ k.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.to(bias.dtype)


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rel_err(a, b) -> float:
    return _max_err(a, b) / b.float().abs().max().item()


def _pallas_fwd(q, k, v, bias, mask, seed, rate):
    b, l = mask.shape
    out, lse = _fwd_call(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                           for t in (q, k, v, bias)),
                         jnp.asarray(mask.numpy().astype(np.int32)
                                     .reshape(b, 1, l)),
                         jnp.asarray([seed], jnp.int32), rate, True)
    return (torch.tensor(np.asarray(out.astype(jnp.float32))),
            torch.tensor(np.asarray(lse)))


def _pallas_bwd(q, k, v, bias, mask, seed, rate, out, lse, g):
    b, l = mask.shape
    bf = [jnp.asarray(t.float().numpy(), jnp.bfloat16)
          for t in (q, k, v, bias)]
    grads = _bwd_call(*bf, jnp.asarray(mask.numpy().astype(np.int32)
                                       .reshape(b, 1, l)),
                      jnp.asarray([seed], jnp.int32),
                      jnp.asarray(out.float().numpy(), jnp.bfloat16),
                      jnp.asarray(lse.numpy()),
                      jnp.asarray(g.float().numpy(), jnp.bfloat16), rate, True)
    return [torch.tensor(np.asarray(x.astype(jnp.float32))) for x in grads]


SHAPES = [(2, 2, 40, 16), (2, 2, 72, 192), (2, 2, 56, 64)]


def _bf16_inputs(shape, seed, pad):
    q, k, v, g, bias, mask = _inputs(seed, *shape, pad)
    q, k, v, g, bias = (torch.tensor(x).to(torch.bfloat16)
                        for x in (q, k, v, g, bias))
    return q, k, v, g, bias, torch.tensor(mask)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_forward_rounding_within_tolerance(shape, rate):
    """P in bf16 (per 64-key tile) keeps K1's bf16 output within TOL_BF16
    of the plain version and of the Pallas kernel, lse unchanged."""
    q, k, v, _, bias, mask = _bf16_inputs(shape, 11, shape[2] // 5)
    got, got_lse = rounded_fwd(q, k, v, bias, mask, 321, rate)
    ref, ref_lse = fa.fused_attention_reference(q, k, v, bias, mask, 321, rate)
    pal, pal_lse = _pallas_fwd(q, k, v, bias, mask, 321, rate)
    assert got.dtype == ref.dtype == torch.bfloat16
    # the rounding is there, and it is small
    assert 0.0 < _max_err(got, ref) <= TOL_BF16
    assert _max_err(got, pal) <= TOL_BF16
    assert _max_err(got_lse, ref_lse) <= 1e-5
    assert _max_err(got_lse, pal_lse) <= 1e-5


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_backward_rounding_within_tolerance(shape, rate):
    """P_d and ds in bf16, and dq from the bf16 dbias, keep K2's bf16
    gradients within TOL_BWD_BF16 (relative to each gradient's largest
    |value|) of the plain backward and of the Pallas kernel."""
    q, k, v, g, bias, mask = _bf16_inputs(shape, 12, shape[2] // 5)
    out, lse = fa.fused_attention_reference(q, k, v, bias, mask, 99, rate)
    got = rounded_bwd(q, k, v, bias, mask, 99, rate, out, lse, g)
    ref = fa.fused_attention_bwd_reference(q, k, v, bias, mask, 99, rate,
                                           out, lse, g)
    pal = _pallas_bwd(q, k, v, bias, mask, 99, rate, out, lse, g)
    for name, a, r, p in zip(("dq", "dk", "dv", "dbias"), got, ref, pal):
        assert a.dtype == r.dtype, name
        assert _rel_err(a, r) <= TOL_BWD_BF16, name
        assert _rel_err(a, p) <= TOL_BWD_BF16, name
    # dq, dk and dv take a rounding the plain version does not have
    assert all(_max_err(a, r) > 0.0 for a, r in zip(got[:3], ref[:3]))


def split_combine(q, k, v, bias, mask, seed, rate, splits, kps):
    """K1's key split in fp32: each range [s kps, (s + 1) kps) gives its
    (max, sum, unnormalised out); the ranges are combined in split order."""
    b, h, l, d = q.shape
    s, valid, _ = _scores(q, k, bias, mask)
    w = _keep_weight(valid, b, h, l, seed, rate)
    parts = []
    for i in range(splits):
        sl = slice(i * kps, min(l, (i + 1) * kps))
        m_i = s[..., sl].amax(-1, keepdim=True)
        e = torch.exp(s[..., sl] - m_i)
        parts.append((m_i, e.sum(-1, keepdim=True),
                      (e * w[..., sl]) @ v[..., sl, :]))
    m = parts[0][0]
    for m_i, _, _ in parts[1:]:
        m = torch.maximum(m, m_i)
    den = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_i, l_i, a_i in parts:
        den = den + torch.exp(m_i - m) * l_i
        acc = acc + torch.exp(m_i - m) * a_i
    return acc / den, (m + torch.log(den))[..., 0][:, :, None]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("b,l", [(1, 296), (1, 552), (1, 696), (1, 872),
                                 (2, 320)])
def test_split_combine_equals_plain_forward(b, l, rate):
    """The key ranges of K1's plan at the serving shapes, combined in a
    fixed order, give the plain forward within 1e-6 in fp32, lse included;
    with a padded key tail and, for b = 2, a fully masked utterance."""
    splits, kps = fa._fwd_plan(b, 2, l)
    assert splits > 1
    q, k, v, _, bias, mask = (torch.tensor(x) for x in
                              _inputs(l + b, b, 2, l, 16, l // 7))
    if b == 2:
        mask[0] = False
    got, got_lse = split_combine(q, k, v, bias, mask, 5, rate, splits, kps)
    ref, ref_lse = fa.fused_attention_reference(q, k, v, bias, mask, 5, rate)
    assert _max_err(got, ref) <= TOL_COMBINE
    assert _max_err(got_lse, ref_lse) <= TOL_COMBINE


@pytest.mark.parametrize("l", [296, 552, 696, 872])
def test_plan_fills_the_card_at_serving_shapes(l):
    """B = 1, H = 2: >= 132 CTAs, key ranges a multiple of 16 keys, none
    empty (the C entry's contract)."""
    splits, kps = fa._fwd_plan(1, 2, l, 132)
    assert splits * 2 * math.ceil(l / fa.ROW_TILE) >= 132
    assert kps % fa.SPLIT_UNIT == 0
    assert (splits - 1) * kps < l <= splits * kps


@pytest.mark.parametrize("b,h,l", [(88, 2, 496), (4, 2, 8192), (8, 2, 552)])
def test_plan_does_not_split_a_full_grid(b, h, l):
    """The training shape's 1408 row tiles fill the card unsplit."""
    assert b * h * math.ceil(l / fa.ROW_TILE) >= 132
    assert fa._fwd_plan(b, h, l, 132) == (1, l)
