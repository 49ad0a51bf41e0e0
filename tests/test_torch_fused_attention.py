"""The port's fused-attention forward (a3t_tpu_torch/ops/fused_attention.py)
against the JAX package's Pallas kernel, run in interpret mode as
tests/test_fused_attention.py runs it, and against the XLA branch's math.

On the CPU the wrapper takes the plain PyTorch version; the CUDA kernel is
checked against it on the card (marked ``cuda``, skipped elsewhere).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from a3t_tpu.ops.fused_attention import _fwd_call, _random_bits
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
