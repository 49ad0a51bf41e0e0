"""The port's fused attention (a3t_tpu_torch/ops/fused_attention.py), forward
and backward, against the JAX package's Pallas kernels, run in interpret
mode as tests/test_fused_attention.py runs them, and against the XLA
branch's math.

On the CPU the wrappers take the plain PyTorch versions; the CUDA kernels
are checked against them on the card (marked ``cuda``, skipped elsewhere).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.ops.fused_attention import (_fused_attention, _fwd_call,
                                        _random_bits)
from a3t_tpu_torch.ops import fused_attention as fa

# tests/test_fused_attention.py's shapes
B, L, D, H = 2, 32, 32, 2


def _inputs(rng, b=B, h=H, l=L, d=16, pad=5):
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((b, h, l, l)).astype(np.float32)
    mask = np.ones((b, l), bool)
    if pad:
        mask[0, -pad:] = False
    return q, k, v, bias, mask


def _pallas(q, k, v, bias, mask, seed, rate):
    b, l = mask.shape
    out, lse = _fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(bias),
                         jnp.asarray(mask.astype(np.int32).reshape(b, 1, l)),
                         jnp.asarray([seed], jnp.int32), rate, True)
    return np.asarray(out), np.asarray(lse)


def _torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 12345),
                                       (0.3, 2**31 - 7)])
@pytest.mark.parametrize("shape", [(2, 2, 32, 16), (1, 2, 40, 24),
                                   (2, 1, 17, 8)])
def test_plain_matches_pallas_interpret(rng, rate, seed, shape):
    """Same inputs, same int seed: out and lse agree to fp32 rounding
    (atol 1e-5); the keep-masks are equal bit for bit, since one differing
    bit moves an output by ~p / (1 - rate) >> 1e-5."""
    b, h, l, d = shape
    q, k, v, bias, mask = _inputs(rng, b, h, l, d, pad=3)
    out_j, lse_j = _pallas(q, k, v, bias, mask, seed, rate)
    out_t, lse_t = fa.fused_attention_reference(*_torch(q, k, v, bias, mask),
                                                seed=seed, rate=rate)
    assert out_t.shape == out_j.shape and lse_t.shape == lse_j.shape
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,lane", [(0, 0), (7, 4097), (2**31 - 1, 8193)])
def test_keep_mask_equals_interpret_bits(seed, lane):
    """The hash in int64 arithmetic equals the interpret-mode uint32 bits."""
    l = 24
    bits = np.asarray(_random_bits((l, l), jnp.asarray(seed, jnp.int32),
                                   lane, True)).astype(np.int64)
    ctr = torch.arange(l * l, dtype=torch.int64).view(l, l)
    got = fa.hash_bits(ctr, seed, torch.tensor(lane, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), bits)


def test_plain_matches_dense_formulation(rng):
    """tests/test_fused_attention.py's dense check, on the plain version
    (atol 2e-5 as there)."""
    q, k, v, bias, mask = _inputs(rng)
    out = fa.fused_attention(*_torch(q, k, v, bias, mask)).numpy()
    s = (np.einsum("bhld,bhmd->bhlm", q, k) + bias) / np.sqrt(q.shape[-1])
    s = np.where(mask[:, None, None, :], s, -1e30)
    e = np.exp(s - s.max(-1, keepdims=True))
    p = np.where(mask[:, None, None, :], e / e.sum(-1, keepdims=True), 0.0)
    np.testing.assert_allclose(out, np.einsum("bhlm,bhmd->bhld", p, v),
                               atol=2e-5)


def test_flash_matches_xla_branch(rng):
    """The port's attention module, flash branch (plain version on the CPU)
    and plain branch, against the flax module's XLA branch: atol 2e-5, the
    tolerance tests/test_fused_attention.py holds the kernel to."""
    import jax

    from a3t_tpu.models.attention import RelPositionMultiHeadedAttention as JA
    from a3t_tpu_torch.compat.from_jax import attention, load_state
    from a3t_tpu_torch.models.attention import RelPositionMultiHeadedAttention

    x = rng.standard_normal((B, L, D)).astype(np.float32)
    pos = rng.standard_normal((1, L, D)).astype(np.float32)
    mask = np.ones((B, 1, L), bool)
    mask[1, 0, L - 6:] = False
    jmod = JA(H, dropout_rate=0.0)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(pos), jnp.asarray(mask))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(pos),
                                jnp.asarray(mask), True))
    for flash in (True, False):
        mod = RelPositionMultiHeadedAttention(D, H, use_flash=flash)
        load_state(mod, {k.split(".", 1)[1]: v for k, v in
                         attention(variables["params"], "m").items()})
        with torch.no_grad():
            out = mod(*_torch(x, pos, mask)).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_wrapper_takes_plain_version_on_cpu(rng):
    """CPU tensors go to the plain version, and no kernel launch is counted."""
    q, k, v, bias, mask = _inputs(rng)
    before = fa.LAUNCHES
    out = fa.fused_attention(*_torch(q, k, v, bias, mask), dropout_rate=0.1,
                             seed=3)
    ref, _ = fa.fused_attention_reference(*_torch(q, k, v, bias, mask),
                                          seed=3, rate=0.1)
    assert fa.LAUNCHES == before
    assert torch.equal(out, ref)


def test_wrapper_refuses_other_devices_and_rates(rng):
    q, k, v, bias, mask = _torch(*_inputs(rng))
    with pytest.raises(ValueError):
        fa.fused_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"),
                               bias.to("meta"), mask.to("meta"))
    with pytest.raises(ValueError):
        fa.fused_attention_fwd(q, k, v, bias, mask, rate=1.0)


def _jax_grads(q, k, v, bias, mask, seed, rate, w):
    """jax.grad of sum(out * w) through the Pallas custom_vjp in interpret
    mode: (dq, dk, dv, dbias) as numpy."""
    b, l = mask.shape
    m = jnp.asarray(mask.astype(np.int32).reshape(b, 1, l))
    sd = jnp.asarray([seed], jnp.int32)

    def f(q, k, v, bias):
        return (_fused_attention(q, k, v, bias, m, sd, rate, True) * w).sum()

    grads = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    return [np.asarray(g) for g in grads]


def _port_grads(q, k, v, bias, mask, seed, rate, w):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    out = fa.fused_attention(*ts, torch.tensor(mask), dropout_rate=rate,
                             seed=seed)
    return [g.numpy() for g in torch.autograd.grad(
        (out * torch.tensor(w)).sum(), ts)]


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 12345),
                                       (0.3, 2**31 - 7)])
@pytest.mark.parametrize("shape", [(2, 2, 32, 16), (1, 2, 40, 24)])
def test_grads_match_pallas_interpret(rng, rate, seed, shape):
    """dq, dk, dv and dbias through the port's FusedAttention (the plain
    backward on the CPU) against jax.grad through the Pallas kernels in
    interpret mode, with a padded key tail.  The keep-masks are equal, so
    the only difference is fp32 summation order: atol 1e-5 on gradients of
    O(1)."""
    b, h, l, d = shape
    q, k, v, bias, mask = _inputs(rng, b, h, l, d, pad=6)
    w = rng.standard_normal((b, h, l, d)).astype(np.float32)
    for got, want in zip(_port_grads(q, k, v, bias, mask, seed, rate, w),
                         _jax_grads(q, k, v, bias, mask, seed, rate, w)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_grads_of_a_fully_masked_row_match_pallas(rng):
    """A batch element whose keys are all masked: lse = -1e30 + log L, p is
    re-zeroed, so it adds nothing; equal to the Pallas gradients (atol
    1e-5, fp32 order)."""
    q, k, v, bias, mask = _inputs(rng, 2, 2, 24, 8, pad=0)
    mask[1] = False
    w = rng.standard_normal(q.shape).astype(np.float32)
    got = _port_grads(q, k, v, bias, mask, 5, 0.2, w)
    for g, want in zip(got, _jax_grads(q, k, v, bias, mask, 5, 0.2, w)):
        np.testing.assert_allclose(g, want, atol=1e-5, rtol=0)
    assert all(not g[1].any() for g in got)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_bwd_reference_matches_autograd(rng, rate):
    """fused_attention_bwd_reference against torch autograd through
    fused_attention_reference, same mask: atol 1e-5 (fp32 order)."""
    q, k, v, bias, mask = _inputs(rng, 2, 2, 30, 12, pad=4)
    w = torch.tensor(rng.standard_normal(q.shape).astype(np.float32))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    out, lse = fa.fused_attention_reference(*ts, torch.tensor(mask), 9, rate)
    want = torch.autograd.grad((out * w).sum(), ts)
    got = fa.fused_attention_bwd_reference(
        *[t.detach() for t in ts], torch.tensor(mask), 9, rate,
        out.detach(), lse.detach(), w)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=0)


def test_backward_takes_plain_version_on_cpu(rng):
    """Both halves of FusedAttention take the plain versions for CPU
    tensors; no kernel launch is counted."""
    q, k, v, bias, mask = _inputs(rng)
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    _port_grads(q, k, v, bias, mask, 3, 0.1,
                np.ones(q.shape, np.float32))
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_matches_plain_on_card(cuda_device, rng, dtype, tol, rate):
    """The CUDA kernel against the plain version on the card; fp32 sums in
    another order (1e-4), bf16 rounds the output once (2e-2)."""
    q, k, v, bias, mask = (t.to(cuda_device) for t in
                           _torch(*_inputs(rng, b=2, h=2, l=70, d=20, pad=9)))
    q, k, v, bias = (t.to(dtype) for t in (q, k, v, bias))
    before = fa.LAUNCHES
    out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 99, rate)
    ref, ref_lse = fa.fused_attention_reference(q, k, v, bias, mask, 99, rate)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_bwd_kernel_matches_plain_on_card(cuda_device, rng, dtype, tol, rate):
    """K2 against the plain backward on the card, relative to each
    gradient's largest |value|: fp32 sums in another order (1e-4), bf16
    rounds each output once (2e-2)."""
    q, k, v, bias, mask = (t.to(cuda_device) for t in
                           _torch(*_inputs(rng, b=2, h=2, l=70, d=20, pad=9)))
    q, k, v, bias = (t.to(dtype) for t in (q, k, v, bias))
    g = torch.randn(q.shape, device=cuda_device).to(dtype)
    out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 99, rate)
    before = fa.LAUNCHES_BWD
    got = fa.fused_attention_bwd(q, k, v, bias, mask, 99, rate, out, lse, g)
    ref = fa.fused_attention_bwd_reference(q, k, v, bias, mask, 99, rate,
                                           out, lse, g)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BWD == before + 1
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err.item() <= tol
