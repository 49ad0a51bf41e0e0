"""The port's attention and Conformer pieces (a3t_tpu_torch/models/
attention.py, conformer.py) against their flax counterparts, weights carried
across by a3t_tpu_torch/compat/from_jax.py.  fp32 on the CPU; the JAX
modules take their XLA attention branch here, so the port's plain branch is
the counterpart, and its flash branch (the kernel's plain version on the CPU)
must agree too.  Tolerances are stated per test."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.models import attention as ja
from a3t_tpu.models import conformer as jc
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.models import attention as ta
from a3t_tpu_torch.models import conformer as tc


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _port_config(cfg: jc.EncoderConfig, **over) -> tc.EncoderConfig:
    fields = {f.name for f in dataclasses.fields(tc.EncoderConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg).items() if k in fields}
    return tc.EncoderConfig(**{**kw, **over})


@pytest.mark.parametrize("shift", ["legacy", "latest"])
def test_rel_shift(rng, shift):
    t2 = 9 if shift == "legacy" else 17
    x = rng.standard_normal((2, 3, 9, t2)).astype(np.float32)
    jfn = ja.legacy_rel_shift if shift == "legacy" else ja.latest_rel_shift
    tfn = ta.legacy_rel_shift if shift == "legacy" else ta.latest_rel_shift
    np.testing.assert_array_equal(tfn(*_t(x)).numpy(),
                                  np.asarray(jfn(jnp.asarray(x))))


@pytest.mark.parametrize("mask_kind", ["none", "keys", "full"])
def test_apply_attn_mask(rng, mask_kind):
    """finfo.min fill, softmax, masked columns re-zeroed (atol 1e-6)."""
    s = rng.standard_normal((2, 2, 6, 6)).astype(np.float32)
    mask = None
    if mask_kind == "keys":
        mask = np.ones((2, 1, 6), bool)
        mask[1, 0, 4:] = False
    elif mask_kind == "full":
        mask = rng.random((2, 6, 6)) < 0.7
        mask[..., 0] = True
    ref = np.asarray(ja.apply_attn_mask(
        jnp.asarray(s), None if mask is None else jnp.asarray(mask)))
    got = ta.apply_attn_mask(torch.from_numpy(s),
                             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("flash", [True, False])
def test_rel_pos_attention_per_query_mask(rng, flash):
    """A (B, T, T) mask takes the plain branch on both sides (atol 2e-5)."""
    b, t, d, h = 2, 12, 16, 2
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    pos = rng.standard_normal((1, t, d)).astype(np.float32)
    mask = rng.random((b, t, t)) < 0.8
    mask[..., 0] = True
    jmod = ja.RelPositionMultiHeadedAttention(h)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(pos),
                  jnp.asarray(mask))
    ref = np.asarray(jmod.apply(v, jnp.asarray(x), jnp.asarray(pos),
                                jnp.asarray(mask), True))
    mod = ta.RelPositionMultiHeadedAttention(d, h, use_flash=flash)
    from_jax.load_state(mod, {k.split(".", 1)[1]: a for k, a in
                              from_jax.attention(v["params"], "m").items()})
    with torch.no_grad():
        got = mod(*_t(x, pos, mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("t", [7, 6000])
def test_rel_pos_encoding_legacy_table(rng, t):
    """Row i holds position max(T, 5000) - 1 - i; x is scaled by sqrt(d)."""
    x = rng.standard_normal((1, t, 8)).astype(np.float32)
    jx, jpos = jc.RelPosEncoding(8, 0.0).apply({}, jnp.asarray(x))
    tx, tpos = tc.RelPosEncoding(8)(torch.from_numpy(x))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("kernel", [7, 31])
@pytest.mark.parametrize("flash", [True, False])
def test_conformer_stack(rng, kernel, flash):
    """Two blocks + after_norm with padded keys and running BatchNorm
    statistics away from (0, 1): atol 2e-5 on LayerNorm-scaled outputs."""
    cfg = jc.EncoderConfig(attention_dim=32, attention_heads=2,
                           linear_units=48, num_blocks=2,
                           cnn_module_kernel=kernel)
    b, t = 2, 40
    x = rng.standard_normal((b, t, 32)).astype(np.float32)
    pos = np.asarray(jc.RelPosEncoding(32, 0.0).apply(
        {}, jnp.asarray(x))[1])
    mask = np.ones((b, 1, t), bool)
    mask[1, 0, 30:] = False
    jmod = jc.ConformerStack(cfg)
    v = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(pos),
                  jnp.asarray(mask), False)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.1, 0.6, s.shape)).astype(np.float32),
        v["batch_stats"])
    ref = np.asarray(jmod.apply(v, jnp.asarray(x), jnp.asarray(pos),
                                jnp.asarray(mask), False))
    mod = tc.ConformerStack(_port_config(cfg, use_flash_attention=flash)).eval()
    from_jax.load_state(mod, {k.split(".", 1)[1]: a for k, a in
                              from_jax.stack(v["params"], v["batch_stats"],
                                             "m").items()})
    with torch.no_grad():
        got = mod(*_t(x, pos, mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_unported_options_raise():
    """A compute dtype other than float32 and bfloat16 is not ported, and an
    unknown attention kind raises; plain (selfattn) and latest rel-pos
    (rel_selfattn) attention build (tests/test_torch_fs2.py holds them
    against JAX); the rel-pos block with its conv module builds in
    bfloat16."""
    from a3t_tpu_torch.models.attention import (
        MultiHeadedAttention, RelPositionMultiHeadedAttention)

    plain = tc.ConformerBlock(tc.EncoderConfig(
        selfattention_layer_type="selfattn"))
    assert isinstance(plain.self_attn, MultiHeadedAttention)
    latest = tc.ConformerBlock(tc.EncoderConfig(
        selfattention_layer_type="rel_selfattn"))
    assert isinstance(latest.self_attn, RelPositionMultiHeadedAttention)
    assert not latest.self_attn.legacy
    with pytest.raises(ValueError, match="attention kind"):
        tc.ConformerBlock(tc.EncoderConfig(selfattention_layer_type="x"))
    with pytest.raises(NotImplementedError):
        tc.ConformerBlock(tc.EncoderConfig(compute_dtype="float16"))
    block = tc.ConformerBlock(tc.EncoderConfig(compute_dtype="bfloat16"))
    assert block.self_attn.dtype == block.conv_module.dtype == torch.bfloat16
