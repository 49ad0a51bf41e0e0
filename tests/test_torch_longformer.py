"""The port's longformer path (configs/a3t_longformer_16k.yaml) against the
JAX package: WindowedSelfAttention, the A3T model with a speech-only
pre-encoder and no decoder, mlm_loss, one train step and load_train_state,
at a tiny size (width 32, 2 heads, window 8, 1 pre-encoder + 2 encoder
blocks, postnet 2 x 16, 20 mel bins), in float32 and bfloat16.

On the CPU the JAX model runs its chunked-einsum attention (conformer.py
:200-202 engages the Pallas kernels on a TPU only), while the port follows
the Pallas kernels.  The two JAX paths differ on query rows whose every band
key is masked, so the model-level batches keep the speech padding under one
half-window (no such row); WindowedSelfAttention is also held to JAX's
``use_pallas=True`` module in interpret mode, fully masked rows included.

Tolerances.  float32: the same products summed in another order, outputs of
O(1..5) within atol 2e-5 (measured ~2e-6); attention outputs and gradients
(sums of many terms, up to ~50 with random biases) within 4e-6 of each
array's largest magnitude (at least 1e-5; measured 3e-7 of it).
bfloat16 compute: each framework rounds to bfloat16 at the same casts but
its matrix products and convolutions round their own way, so outputs agree
to about one bf16 ulp (2^-8 relative) per rounding; the model's outputs are
held within 1.5e-2 of their largest magnitude (measured 4.7e-3; JAX's own
bf16 output lies 6.3e-3 from its fp32 output on the same weights), the loss
within rtol 1e-2 and the gradient norm within rtol 3e-2.  The train step's
optimizer uses Adam eps 1e-3, for the reason tests/test_torch_train.py gives;
its first step moves a parameter by at most lr_1 = 32^-0.5 * 10^-1.5 =
5.6e-3.  After it, fp32 parameters agree within 2e-5; in bf16 a gradient
entry of Adam's eps' size (1e-3) carries bf16 noise of its own size, which
moves its step by a good share of lr_1, so bf16 parameters are held within
3e-3 (measured 1.2e-3).
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data import make_synthetic_batch as jax_synthetic_batch
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TModelConfig, EncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models import conformer as tc
from a3t_tpu_torch.models.mlm import mlm_loss
from a3t_tpu_torch.models.windowed_attention import WindowedSelfAttention
from a3t_tpu_torch.tasks.config import (FRONTEND_16K, OPTIM_24K,
                                        a3t_longformer_16k)
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_optimizer, make_train_step)
from test_torch_mlm import make_batch, port_config

jwa = importlib.import_module("a3t_tpu.models.windowed_attention")

WINDOW = 8
ENC = EncoderConfig(attention_dim=32, attention_heads=2, linear_units=48,
                    num_blocks=2, macaron_style=False, use_cnn_module=False,
                    selfattention_layer_type="longformer",
                    attention_window=WINDOW, pre_speech_layers=1,
                    dropout_rate=0.0, positional_dropout_rate=0.0,
                    attention_dropout_rate=0.0)
HOP = 200
FRONTEND = dict(fs=16000, n_fft=1024, hop_length=HOP, win_length=800,
                n_mels=20)
OPTIM = dict(lr=1.0, model_size=32, warmup_steps=10, grad_clip=1.0,
             adam_eps=1e-3)


def _config(dtype: str) -> A3TModelConfig:
    return A3TModelConfig(odim=20, vocab_size=40,
                          encoder=dataclasses.replace(ENC,
                                                      compute_dtype=dtype),
                          decoder=None, postnet_layers=2, postnet_chans=16)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_params(variables, seed: int = 1):
    """Biases and norms away from their zero / one init, so that every
    parameter matters."""
    rng = np.random.default_rng(seed)
    v = _np_tree(variables)
    v["params"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        v["params"])
    return v


# ---------------------------------------------------------------------------
# WindowedSelfAttention
# ---------------------------------------------------------------------------

def _attention_case(n_text: int, pad: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n_frames = 32
    x = rng.standard_normal((2, n_frames + n_text, 32)).astype(np.float32)
    mask = np.ones((2, n_frames + n_text), bool)
    mask[1, n_frames - pad:n_frames] = False
    if n_text:
        mask[1, -2:] = False
    w = rng.standard_normal(x.shape).astype(np.float32)
    return x, mask, n_frames, w


def _attention_pair(x, mask, n_frames, use_pallas: bool):
    jmod = jwa.WindowedSelfAttention(2, WINDOW, use_pallas=use_pallas)
    v = _random_params(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 n_frames, jnp.asarray(mask)))
    mod = WindowedSelfAttention(32, 2, WINDOW)
    from_jax.load_state(mod, {k.split(".", 1)[1]: a for k, a in
                              from_jax.attention(v["params"], "m").items()})
    return jmod, v, mod


def _attention_check(x, mask, n_frames, w, use_pallas: bool):
    """Outputs and the gradients of sum(out * w) by x and the parameters."""
    jmod, v, mod = _attention_pair(x, mask, n_frames, use_pallas)

    def loss(params, xx):
        out = jmod.apply({"params": params}, xx, n_frames, jnp.asarray(mask))
        return (out * w).sum(), out

    (_, ref), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        v["params"], jnp.asarray(x))
    xt = torch.tensor(x).requires_grad_()
    out = mod(xt, n_frames, torch.tensor(mask))
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(),
                                [xt] + list(mod.parameters()))
    _close(out.detach(), ref, "out")
    _close(grads[0], gx, "x")
    want = from_jax.attention(_np_tree(gp), "m")
    for (name, _), got in zip(mod.named_parameters(), grads[1:]):
        _close(got, want[f"m.{name}"], name)


def _close(got, want, name):
    """fp32: within 4e-6 of the array's largest magnitude, at least 1e-5."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, err_msg=name,
                               atol=max(1e-5, 4e-6 * np.abs(want).max()))


@pytest.mark.parametrize("n_text,pad", [(6, 20), (0, 16)])
def test_windowed_attention_matches_pallas_module(n_text, pad):
    """JAX's use_pallas=True module (interpret mode), with 16-20 padded
    frames: with text, padded queries still see the text; speech-only (the
    pre-encoder's case), chunks 6..7 of entry 1 are fully masked rows."""
    _attention_check(*_attention_case(n_text, pad), use_pallas=True)


@pytest.mark.parametrize("n_text,pad", [(6, 3), (0, 3)])
def test_windowed_attention_matches_chunked_path(n_text, pad):
    """JAX's chunked-einsum module, padding under one half-window."""
    _attention_check(*_attention_case(n_text, pad, seed=1), use_pallas=False)


def test_unported_longformer_options_raise():
    """Dilation and the chunked path are ported
    (tests/test_torch_dilation.py); a float16 compute dtype and bad windows,
    dilations and frame counts raise."""
    base = dict(selfattention_layer_type="longformer", attention_window=8,
                macaron_style=False, use_cnn_module=False)
    for ok in (dict(attention_dilation=2), dict(use_pallas_attention=False)):
        tc.ConformerBlock(tc.EncoderConfig(**base, **ok))
    with pytest.raises(NotImplementedError):
        tc.ConformerBlock(tc.EncoderConfig(**base, compute_dtype="float16"))
    with pytest.raises(ValueError, match="window"):
        WindowedSelfAttention(32, 2, 0)
    with pytest.raises(ValueError, match="dilation"):
        WindowedSelfAttention(32, 2, 8, dilation=0)
    mod = WindowedSelfAttention(32, 2, 8)
    with pytest.raises(ValueError, match="multiple of half-window"):
        mod(torch.zeros(1, 12, 32), 10)
    with pytest.raises(ValueError, match="x dilation 2"):
        WindowedSelfAttention(32, 2, 8, dilation=2)(torch.zeros(1, 12, 32),
                                                     12)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _model_batch():
    batch = make_batch(np.random.default_rng(0), 2, 32, 6, 20, 40)
    batch["speech_mask"][1] = True
    batch["speech_mask"][1, -3:] = False  # under one half-window
    return batch


@functools.lru_cache(maxsize=None)
def _jax_forward(dtype: str):
    cfg = _config(dtype)
    batch = _model_batch()
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    model = jax_mlm.A3TMLMModel(cfg)
    v = _random_params(model.init(jax.random.PRNGKey(0), **jb))
    before, after, _ = model.apply(v, **jb)
    return cfg, batch, v, np.asarray(before), np.asarray(after)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_longformer_model_forward_and_loss(dtype):
    cfg, batch, v, before, after = _jax_forward(dtype)
    model = build_model(port_config(cfg), device="cpu")
    assert model.pre_speech_encoders is not None
    assert not hasattr(model, "decoder")
    from_jax.load_state(model, from_jax.mlm_state(v))
    tb = {k: torch.tensor(a) for k, a in batch.items()}
    with torch.no_grad():
        got_b, got_a = model(**tb)
    assert got_b.dtype == got_a.dtype == torch.float32
    if dtype == "float32":
        tol = dict(atol=2e-5, rtol=0)
    else:
        tol = dict(atol=1.5e-2 * np.abs(after).max(), rtol=0)
    np.testing.assert_allclose(got_b.numpy(), before, **tol)
    np.testing.assert_allclose(got_a.numpy(), after, **tol)
    want = float(jax_mlm.mlm_loss(
        jnp.asarray(before), jnp.asarray(after), jnp.asarray(batch["speech"]),
        jnp.asarray(batch["masked_position"])))
    got = mlm_loss(got_b, got_a, tb["speech"], tb["masked_position"])
    assert float(got) == pytest.approx(
        want, rel=1e-5 if dtype == "float32" else 1e-2)


def test_bfloat16_casts_follow_flax():
    """Where flax keeps float32 (LayerNorm, embeddings, positional encoding,
    residual sums, sfc, the last BatchNorm) and where it computes in
    bfloat16 (attention projections, feed-forward convolutions, postnet
    convolutions)."""
    cfg = port_config(_config("bfloat16"))
    model = build_model(cfg, device="cpu")
    block = model.encoder.encoders[0]
    x = torch.randn(2, 12, 32)
    assert block.self_attn(x, 8).dtype == torch.bfloat16
    assert block.feed_forward(x).dtype == torch.bfloat16
    assert block(x, None, torch.ones(2, 1, 12, dtype=torch.bool),
                 n_frames=8).dtype == torch.float32
    pe, _ = model.posenc(x.to(torch.bfloat16))
    assert pe.dtype == torch.float32
    assert model.postnet(torch.randn(2, 12, 20)).dtype == torch.float32
    # the positional table is rounded to bfloat16 before the float32 sum
    zero = torch.zeros(1, 12, 32, dtype=torch.bfloat16)
    table = model.posenc(zero)[0]
    assert torch.equal(table, table.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# one train step and load_train_state
# ---------------------------------------------------------------------------

def _train_batch():
    """make_synthetic_batch at 16 kHz (F = 32 frames, 6 phones), with the
    audio lengths set so that each utterance's padding stays under one
    half-window (the two JAX attention paths then agree)."""
    batch = jax_synthetic_batch(np.random.default_rng(3), batch_size=2,
                                n_samples=HOP * 31, n_text=6, hop_length=HOP,
                                vocab_size=40, fs=16000)
    batch["audio_lengths"] = np.array([HOP * 31, HOP * 28 + 50], np.int32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_step(dtype: str):
    """One JAX train step (its default fused front-end) from random params,
    with the postnet's dropout set to 0 through the module namespace."""
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(_config(dtype))
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        batch = _train_batch()
        dev = {k: jnp.asarray(a) for k, a in batch.items()}
        state = jax_create_train_state(
            model, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
            jax_featurize(fe, dev))
        init = _random_params({"params": state.params,
                               "batch_stats": state.batch_stats})
        state = state.replace(params=jax.tree_util.tree_map(
            jnp.asarray, init["params"]))
        step = jax_make_train_step(model, fe, donate=False)
        state, stats = step(state, dev, jax.random.PRNGKey(0))
    finally:
        jax_mlm.Postnet = postnet
    return batch, init, state, {k: float(x) for k, x in stats.items()}


def _port_state(dtype: str, init):
    model = build_model(port_config(_config(dtype)), device="cpu")
    model.postnet.dropout.rate = 0.0
    from_jax.load_state(model, from_jax.mlm_state(init))
    state = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                               device="cpu")
    fe = LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu")
    return state, make_train_step(model, fe, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_longformer_train_step_matches_jax(dtype):
    batch, init, jstate, jstats = _jax_step(dtype)
    state, step = _port_state(dtype, init)
    state, stats = step(state, batch, 0)
    f32 = dtype == "float32"
    assert float(stats["loss"]) == pytest.approx(jstats["loss"],
                                                 rel=2e-5 if f32 else 1e-2)
    assert float(stats["grad_norm"]) == pytest.approx(
        jstats["grad_norm"], rel=2e-4 if f32 else 3e-2)
    assert int(stats["notfinite_count"]) == 0
    want = from_jax.mlm_state({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
    got = state.model.state_dict()
    atol = 2e-5 if f32 else 3e-3
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value, atol=atol,
                                       rtol=0, err_msg=name)
    assert state.step == int(jstate.step) == 1


def test_load_train_state_longformer():
    """A JAX longformer state after one step resumes in the port: weights,
    running statistics, Adam's moments by parameter name, counts."""
    _, _, jstate, _ = _jax_step("float32")
    model = build_model(port_config(_config("float32")), device="cpu")
    state = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                               device="cpu")
    from_jax.load_train_state(state, jstate)
    assert state.step == 1
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("pre_speech_encoders.") for n in names)
    adam = from_jax._inner_states(jstate.opt_state)[0]
    mu = from_jax.mlm_state({"params": adam.mu,
                             "batch_stats": jstate.batch_stats})
    flat = np.concatenate([mu[n].reshape(-1) for n in names])
    np.testing.assert_array_equal(state.opt_state.mu.numpy(), flat)
    assert int(state.opt_state.count) == 1


def test_longformer_16k_config_and_bucket_rule():
    """The yaml's model: 2 pre-encoder + 4 encoder blocks of window 512, no
    decoder, bf16; a step refuses frames that are no multiple of 256."""
    cfg = a3t_longformer_16k()
    e = cfg.encoder
    assert (e.num_blocks, e.pre_speech_layers, e.attention_window,
            e.compute_dtype, e.macaron_style, e.use_cnn_module) == \
        (4, 2, 512, "bfloat16", False, False)
    assert cfg.decoder is None and FRONTEND_16K.fs == 16000
    assert OPTIM_24K.warmup_steps == 4000
    model = build_model(port_config(_config("float32")), device="cpu")
    state = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                               device="cpu")
    step = make_train_step(model, LogMelFrontend(LogMelConfig(**FRONTEND),
                                                 device="cpu"), device="cpu")
    batch = _train_batch()
    batch["masked_position"] = batch["masked_position"][:, :30]
    batch["speech_segment_pos"] = batch["speech_segment_pos"][:, :30]
    batch["audio"] = batch["audio"][:, :HOP * 29]
    with pytest.raises(ValueError, match="half-window"):
        step(state, batch, 0)
