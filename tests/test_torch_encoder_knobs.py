"""The encoder knobs of the JAX package's EncoderConfig in the port
(a3t_tpu_torch/models/conformer.py, models/layers.py): the shifted
lowerings ``positionwise_layer_type: conv1d_shifted`` and
``cnn_module_shifted``, ``cnn_module_bn_compute_dtype``, ``remat``,
``remat_attention`` and ``normalize_before: false``.

* Each knob on a small model of the 24 kHz shape (2 encoder + 1 decoder
  blocks of width 32, conv modules of kernel 7 and 31, postnet 1 x 8, 20
  mel bins), against JAX's model with the same knob, weights carried by
  compat/from_jax.py (the shifted modules' parameters have the unshifted
  names and layouts, layers.py:80-140): the eval forward, and in train mode
  at dropout 0 the loss, every parameter's gradient and the BatchNorm
  running statistics.  float32: the same products summed in another order;
  outputs within 2e-5, the loss within rtol 1e-5, each gradient within
  1e-5 of its largest magnitude (at least 1e-6; the key projections' and
  depthwise convolutions' biases, whose true gradient is zero, within 1e-5
  of the largest gradient of all leaves), running statistics within 1e-6.
* ``cnn_module_bn_compute_dtype`` in bfloat16 on the conv module in train
  mode, against flax's ``BatchNorm(dtype=bfloat16)`` (layers.py:216-220):
  its values and running statistics equal the float32 round trip's bit for
  bit in both packages; its input gradient is what moves, since the two float32
  copies' gradients are rounded to bf16 and summed there.  Both frameworks
  round their bf16 convolutions their own way, so the port's gradient is
  held to twice the distance between JAX's two BatchNorm modes (the
  movement of the knob itself) in root mean square, and must itself have
  moved from the round trip's by at least a tenth of JAX's movement.
* ``remat`` and ``remat_attention`` at dropout 0.2 on every site, for the
  24 kHz shape and the longformer shape: the same loss, gradients, BatchNorm
  running statistics and generator state as without, bit for bit on the
  CPU (the recomputation replays the generator's draws and leaves the
  running statistics alone).
* The shifted knobs give the unshifted outputs bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.models import A3TModelConfig, EncoderConfig
from a3t_tpu.models import layers as jl
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models import layers as tl
from a3t_tpu_torch.models.mlm import mlm_loss
from test_torch_bf16_24k import _random, _rms, _sub
from test_torch_mlm import make_batch, port_config

KNOBS = {
    "conv1d_shifted": dict(positionwise_layer_type="conv1d_shifted"),
    "cnn_module_shifted": dict(cnn_module_shifted=True),
    "cnn_module_bn_compute_dtype": dict(cnn_module_bn_compute_dtype=True),
    "remat": dict(remat=True),
    "remat_attention": dict(remat_attention=True),
    "normalize_before_false": dict(normalize_before=False),
}


ZERO_GRADIENT = ("linear_k.bias", "depthwise_conv.bias")


def _config(knob: dict, rate: float = 0.0, **kw) -> A3TModelConfig:
    stack = dict(attention_dim=32, attention_heads=2, linear_units=48,
                 dropout_rate=rate, positional_dropout_rate=rate,
                 attention_dropout_rate=rate, **knob, **kw)
    return A3TModelConfig(
        odim=20, vocab_size=40,
        encoder=EncoderConfig(cnn_module_kernel=7, num_blocks=2, **stack),
        decoder=EncoderConfig(cnn_module_kernel=31, num_blocks=1, **stack),
        postnet_layers=1, postnet_chans=8)


def _batch():
    return make_batch(np.random.default_rng(0), 2, 24, 6, 20, 40)


@functools.lru_cache(maxsize=None)
def _jax_run(name: str):
    """JAX's model with the knob: eval outputs, and at train=True the loss,
    the gradients and the updated running statistics."""
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(_config(KNOBS[name]))
        batch = {k: jnp.asarray(a) for k, a in _batch().items()}
        v = _random(jax.jit(model.init)(jax.random.PRNGKey(0), **batch))
        before, after, _ = jax.jit(model.apply)(v, **batch)

        @jax.jit
        @functools.partial(jax.value_and_grad, has_aux=True)
        def loss(params):
            (b, a, _), upd = model.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, **batch,
                train=True, mutable=["batch_stats"])
            return jax_mlm.mlm_loss(b, a, batch["speech"],
                                    batch["masked_position"]), upd

        (value, upd), grads = loss(v["params"])
    finally:
        jax_mlm.Postnet = postnet
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": grads, "batch_stats": upd["batch_stats"]})
    return (v, np.asarray(before), np.asarray(after), float(value),
            from_jax.mlm_state(tree))


def _port_model(cfg, v=None, seed=0):
    model = build_model(port_config(cfg), device="cpu", seed=seed)
    model.postnet.dropout.rate = 0.0
    if v is not None:
        from_jax.load_state(model, from_jax.mlm_state(v))
    return model


def _port_train(model, batch, generator=None):
    """(loss, {name: gradient}) in train mode."""
    model.train()
    tb = {k: torch.tensor(a) for k, a in batch.items()}
    before, after = model(**tb, generator=generator)
    loss = mlm_loss(before, after, tb["speech"], tb["masked_position"])
    names, params = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_knob_matches_jax_float32(name):
    v, before, after, jloss, jstate = _jax_run(name)
    model = _port_model(_config(KNOBS[name]), v)
    if name == "normalize_before_false":
        assert model.encoder.after_norm is None
        assert model.decoder.after_norm is None
    batch = _batch()
    model.eval()
    with torch.no_grad():
        got_b, got_a = model(**{k: torch.tensor(a) for k, a in batch.items()})
    np.testing.assert_allclose(got_b.numpy(), before, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_a.numpy(), after, atol=2e-5, rtol=0)
    loss, grads = _port_train(model, batch)
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    top = max(np.abs(jstate[n]).max() for n in grads)
    for n, g in grads.items():
        # two kinds of bias have a true gradient of zero, rounding noise in
        # both runs: the key projections' and the depthwise convolutions'
        # (chip_smoke.py's ZERO_GRADIENT); they are held to the largest
        # gradient of all leaves
        want = jstate[n]
        ref = top if n.endswith(ZERO_GRADIENT) else np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, err_msg=n,
                                   atol=max(1e-6, 1e-5 * ref))
    state = model.state_dict()
    for n, want in jstate.items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[n].numpy(), want, atol=1e-6,
                                       rtol=0, err_msg=n)


def test_shifted_knobs_equal_unshifted_bit_for_bit():
    batch = {k: torch.tensor(a) for k, a in _batch().items()}
    outs = []
    for knob in ({}, KNOBS["conv1d_shifted"], KNOBS["cnn_module_shifted"]):
        model = _port_model(_config(knob, compute_dtype="bfloat16"),
                            seed=3).eval()
        with torch.no_grad():
            outs.append(model(**batch))
    for got in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, outs[0]))


def _conv_module_bf16(bn_compute_dtype: bool):
    """Train mode in bf16: (output, running statistics, input gradient,
    parameter gradients) of the port's and of flax's conv module."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, 16)).astype(np.float32)
    x[2, 30:] = 0.0
    w = rng.standard_normal(x.shape).astype(np.float32)
    jmod = jl.ConvolutionModule(7, dtype=jnp.bfloat16,
                                bn_compute_dtype=bn_compute_dtype)
    v = _random(jl.ConvolutionModule(7).init(jax.random.PRNGKey(0),
                                             jnp.asarray(x), False))

    def f(params, xx):
        out, upd = jmod.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, xx, True,
                              mutable=["batch_stats"])
        return (out.astype(jnp.float32) * w).sum(), (out, upd)

    (_, (out, upd)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    jax_side = (np.asarray(out, np.float32),
                jax.tree_util.tree_map(np.asarray, upd["batch_stats"]),
                np.asarray(gx),
                _sub(from_jax.conv_module(
                    jax.tree_util.tree_map(np.asarray, gp),
                    upd["batch_stats"], "m")))
    mod = tl.ConvolutionModule(16, 7, dtype=torch.bfloat16,
                               bn_compute_dtype=bn_compute_dtype)
    from_jax.load_state(mod, _sub(from_jax.conv_module(
        v["params"], v["batch_stats"], "m")))
    xt = torch.tensor(x, requires_grad=True)
    out = mod.train()(xt)
    names, params = zip(*mod.named_parameters())
    grads = torch.autograd.grad((out.float() * torch.tensor(w)).sum(),
                                (xt,) + params)
    port_side = (out.detach().float().numpy(),
                 {"mean": mod.norm.running_mean.numpy(),
                  "var": mod.norm.running_var.numpy()},
                 grads[0].numpy(),
                 {n: g.numpy() for n, g in zip(names, grads[1:])})
    return port_side, jax_side


def test_bn_compute_dtype_bf16_matches_flax():
    (pk, jk), (pr, jr) = _conv_module_bf16(True), _conv_module_bf16(False)
    # the values and running statistics are the round trip's, bit for bit
    # in both packages (the round trip's are held to flax in
    # tests/test_torch_bf16_24k.py)
    assert np.array_equal(pk[0], pr[0]) and np.array_equal(jk[0], jr[0])
    for key in ("mean", "var"):
        np.testing.assert_array_equal(pk[1][key], pr[1][key])
        np.testing.assert_array_equal(jk[1]["BatchNorm_0"][key],
                                      jr[1]["BatchNorm_0"][key])
    # the input gradient moves with the knob
    moved_jax = _rms(jk[2] - jr[2])
    assert moved_jax > 0
    assert _rms(pk[2] - jk[2]) <= 2 * moved_jax
    assert _rms(pk[2] - pr[2]) >= 0.1 * moved_jax
    for n, g in pk[3].items():
        want = jk[3][n]
        assert _rms(g - want) <= 2 * max(_rms(jk[3][n] - jr[3][n]),
                                         _rms(pr[3][n] - jr[3][n])), n


def _remat_case(kind: str, knob: dict):
    if kind == "longformer":
        enc = EncoderConfig(
            attention_dim=32, attention_heads=2, linear_units=48,
            num_blocks=2, macaron_style=False, use_cnn_module=False,
            selfattention_layer_type="longformer", attention_window=8,
            pre_speech_layers=1, dropout_rate=0.2,
            positional_dropout_rate=0.2, attention_dropout_rate=0.2, **knob)
        cfg = A3TModelConfig(odim=20, vocab_size=40, encoder=enc,
                             decoder=None, postnet_layers=1,
                             postnet_chans=8)
        batch = make_batch(np.random.default_rng(0), 2, 32, 6, 20, 40)
    else:
        cfg = _config(knob, rate=0.2)
        batch = _batch()
    model = build_model(port_config(cfg), device="cpu", seed=1)
    gen = torch.Generator().manual_seed(5)
    loss, grads = _port_train(model, batch, gen)
    stats = {n: b.clone() for n, b in model.named_buffers()}
    return float(loss.detach()), grads, stats, gen.get_state()


@pytest.mark.parametrize("kind,knob", [
    ("24k", "remat"), ("24k", "remat_attention"), ("longformer", "remat")])
def test_remat_changes_nothing_at_dropout(kind, knob):
    plain = _remat_case(kind, {})
    remat = _remat_case(kind, KNOBS[knob])
    assert remat[0] == plain[0]
    assert remat[1].keys() == plain[1].keys()
    for n, g in plain[1].items():
        assert torch.equal(remat[1][n], g), n
    for n, b in plain[2].items():
        assert torch.equal(remat[2][n], b), n
    assert torch.equal(remat[3], plain[3])
