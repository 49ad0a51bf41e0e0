"""The 24 kHz A3T model in bfloat16 compute (the JAX bench's mixed precision,
bench.py:90-94) against the JAX package with ``compute_dtype="bfloat16"``:
rel-pos attention (the port's plain branch and its flash branch, whose
kernels run their plain versions on the CPU), the conv module in train mode
(BatchNorm statistics too) and the linear feed-forward, each against flax
with ``dtype=bfloat16``; then a small model of the 24 kHz shape (2 + 2
blocks of width 64, conv modules of kernel 7 and 31, postnet 2 x 16, 20 mel
bins): forward, mlm_loss and one train step at dropout 0.  Weights come
from JAX's init (moved off their zero / one init) through from_jax; inputs
from numpy with a seed.

Tolerance.  Both frameworks round to bfloat16 at the same casts, but their
matrix products, convolutions and sigmoids round their own way (XLA's CPU
backend expands a bf16 sigmoid as 1 / (1 + exp(-x)) rounded at every step;
flax rounds a product to bf16 before it adds the bias, where the port's
fused bias rounds once), so they agree only to bf16 rounding, and a bf16
output one rounding step apart already differs by about the gap below.
Each comparison is held to JAX's own bf16-vs-fp32 gap, measured in the
test on the same weights and inputs, as tests/test_torch_longformer.py
reasons.  With random biases on the products: two bf16 computations of the
same function, each within the gap of the fp32 answer, lie within twice the
gap of each other, so max|port - JAX bf16| <= 2 max|JAX bf16 - JAX fp32|
(measured 0.05-1.24 gaps).  The port must also have computed in bf16: for
arrays, its own distance to JAX's fp32 answer is at least a tenth of the
gap (measured 0.26-1.16 gaps); a port that kept float32 where bf16 was due
would sit on that answer.

Those bounds cannot see one cast site computed at the wrong precision: that
adds one rounding among many.  So the modules and the forward have sharp
twins whose products' biases stay at their zero init, where the port's
single rounding and flax's double one agree.  There the distances are root
mean squares over the elements, held to one gap: rms(port - JAX bf16) <=
rms(JAX bf16 - JAX fp32) (measured 0.07-0.96 gaps).  The plain attention
branch then reproduces flax's bf16 bit for bit, and is held to a tenth of
the gap.  The train step, from random biases, also holds each leaf that it
moved apart in bf16 to twice that leaf's own gap in root mean square
(measured up to 1.61).  A port with one cast site wrong fails these tests:
BatchNorm statistics taken in bf16 (the conv module's output 1.03 gaps
away, a depthwise bias after the step 2.3), the softmax taken over bf16
scores (the plain attention 0.67 gaps, the model's output 1.06), or the
positional scores rounded to bf16 before the sum (0.52 and 1.02).  A zero-
bias train step is no sharp twin: its gradient norm is large (1379, where
random biases give 201), and two bf16 runs of it differ by 6-12 of JAX's
gaps, while the fp32 runs agree within 5e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data import make_synthetic_batch as jax_synthetic_batch
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TModelConfig, EncoderConfig
from a3t_tpu.models import attention as ja
from a3t_tpu.models import layers as jl
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import attention as ta
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models import layers as tl
from a3t_tpu_torch.models.mlm import mlm_loss
from a3t_tpu_torch.tasks.config import a3t_conformer_24k
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_optimizer, make_train_step)
from test_torch_mlm import make_batch, port_config

BF16 = jnp.bfloat16


def _random(variables, seed: int = 1, product_biases: bool = True):
    """Parameters moved off their zero / one init, so that every one
    matters; BatchNorm statistics away from (0, 1).  Without
    ``product_biases`` the biases of the products (a ``bias`` beside a
    ``kernel``) keep their zero init."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def move(path, a):
        moved = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if product_biases or path[-1].key != "bias":
            return moved
        parent = functools.reduce(lambda d, k: d[k.key], path[:-1],
                                  v["params"])
        return a if "kernel" in parent else moved

    v["params"] = jax.tree_util.tree_map_with_path(move, v["params"])
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda s: (s + rng.uniform(0.2, 0.8, s.shape)).astype(s.dtype),
            v["batch_stats"])
    return v


def _within_gap(got, want_bf16, want_f32, what: str) -> None:
    got, want_bf16, want_f32 = (np.asarray(a, np.float32)
                                for a in (got, want_bf16, want_f32))
    gap = np.abs(want_bf16 - want_f32).max()
    err = np.abs(got - want_bf16).max()
    own = np.abs(got - want_f32).max()
    assert gap > 1e-6 * np.abs(want_f32).max(), f"{what}: no bf16 gap"
    assert err <= 2 * gap, f"{what}: max|port - JAX bf16| {err:.3g} > " \
        f"twice JAX's bf16-vs-fp32 gap {gap:.3g}"
    if got.size > 1:  # a scalar may land near the fp32 answer by chance
        assert own >= 0.1 * gap, f"{what}: max|port - JAX fp32| " \
            f"{own:.3g}, the port ran no bf16 (JAX's gap {gap:.3g})"


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _within_rms_gap(got, want_bf16, want_f32, what: str,
                   within: float = 1.0) -> None:
    """The sharp twins' bound: rms(port - JAX bf16) <= ``within`` x
    rms(JAX bf16 - JAX fp32), and the port computed in bf16."""
    got, want_bf16, want_f32 = (np.asarray(a, np.float32)
                                for a in (got, want_bf16, want_f32))
    gap = _rms(want_bf16 - want_f32)
    err = _rms(got - want_bf16)
    own = _rms(got - want_f32)
    assert gap > 1e-6 * np.abs(want_f32).max(), f"{what}: no bf16 gap"
    assert err <= within * gap, f"{what}: rms(port - JAX bf16) {err:.3g} > " \
        f"{within:g} x JAX's bf16-vs-fp32 gap {gap:.3g}"
    if got.size > 1:
        assert own >= 0.1 * gap, f"{what}: rms(port - JAX fp32) " \
            f"{own:.3g}, the port ran no bf16 (JAX's gap {gap:.3g})"


def _sub(state):
    return {k.split(".", 1)[1]: a for k, a in state.items()}


def _attention(flash: bool, product_biases: bool):
    """(port bf16, flax bf16, flax fp32) rel-pos attention outputs."""
    rng = np.random.default_rng(0)
    b, t, d, h = 2, 20, 32, 2
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    pos = rng.standard_normal((1, t, d)).astype(np.float32)
    mask = np.ones((b, 1, t), bool)
    mask[1, 0, -5:] = False
    args = [jnp.asarray(a) for a in (x, pos, mask)]
    v = _random(ja.RelPositionMultiHeadedAttention(h).init(
        jax.random.PRNGKey(1), *args), product_biases=product_biases)
    want = {dt: np.asarray(ja.RelPositionMultiHeadedAttention(
        h, dtype=dt).apply(v, *args, True), np.float32)
        for dt in (None, BF16)}
    mod = ta.RelPositionMultiHeadedAttention(d, h, use_flash=flash,
                                             dtype=torch.bfloat16)
    from_jax.load_state(mod, _sub(from_jax.attention(v["params"], "m")))
    with torch.no_grad():
        got = mod(*(torch.tensor(a) for a in (x, pos, mask)))
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), want[BF16], want[None]


@pytest.mark.parametrize("flash", [False, True])
def test_rel_pos_attention_bf16_matches_flax(flash):
    _within_gap(*_attention(flash, True), "attention")


@pytest.mark.parametrize("flash", [False, True])
def test_rel_pos_attention_bf16_sharp(flash):
    """Zero product biases: the plain branch within a tenth of the gap (it
    rounds where flax rounds), the flash branch's kernels within one."""
    _within_rms_gap(*_attention(flash, False), "attention",
                    within=1.0 if flash else 0.1)


def _conv_module(product_biases: bool):
    """Train mode: batch statistics in a float32 round trip, running
    statistics moved by flax's rule.  [(what, port, flax bf16, flax fp32)]
    for the output and both running statistics."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, 16)).astype(np.float32)
    x[2, 30:] = 0.0
    v = _random(jl.ConvolutionModule(7).init(jax.random.PRNGKey(0),
                                             jnp.asarray(x), False),
                product_biases=product_biases)
    want = {}
    for dt in (None, BF16):
        out, upd = jl.ConvolutionModule(7, dtype=dt).apply(
            v, jnp.asarray(x), True, mutable=["batch_stats"])
        want[dt] = (np.asarray(out, np.float32),
                    jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
    mod = tl.ConvolutionModule(16, 7, dtype=torch.bfloat16)
    from_jax.load_state(mod, _sub(from_jax.conv_module(
        v["params"], v["batch_stats"], "m")))
    with torch.no_grad():
        got = mod.train()(torch.tensor(x))
    assert got.dtype == torch.bfloat16
    cases = [("conv module output", got.float().numpy(), want[BF16][0],
              want[None][0])]
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        cases.append((name, getattr(mod.norm, name).numpy(),
                      want[BF16][1]["BatchNorm_0"][key],
                      want[None][1]["BatchNorm_0"][key]))
    return cases


def test_convolution_module_bf16_train_matches_flax():
    for what, got, want16, want32 in _conv_module(True):
        _within_gap(got, want16, want32, what)


def test_convolution_module_bf16_train_sharp():
    for what, got, want16, want32 in _conv_module(False):
        _within_rms_gap(got, want16, want32, what)


def _feed_forward(product_biases: bool):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    v = _random(jl.PositionwiseFeedForward(32, 0.0).init(
        jax.random.PRNGKey(0), jnp.asarray(x), True),
        product_biases=product_biases)
    want = {dt: np.asarray(jl.PositionwiseFeedForward(32, 0.0, dtype=dt)
                           .apply(v, jnp.asarray(x), True), np.float32)
            for dt in (None, BF16)}
    mod = tl.PositionwiseFeedForward(16, 32, dtype=torch.bfloat16)
    from_jax.load_state(mod, _sub(from_jax.positionwise(v["params"], "m")))
    with torch.no_grad():
        got = mod(torch.tensor(x))
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), want[BF16], want[None]


def test_positionwise_feed_forward_bf16_matches_flax():
    _within_gap(*_feed_forward(True), "feed-forward")


def test_positionwise_feed_forward_bf16_sharp():
    _within_rms_gap(*_feed_forward(False), "feed-forward")


# ---------------------------------------------------------------------------
# the model of the 24 kHz shape
# ---------------------------------------------------------------------------

def _config(dtype: str) -> A3TModelConfig:
    stack = dict(attention_dim=64, attention_heads=2, linear_units=128,
                 num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
                 attention_dropout_rate=0.0, compute_dtype=dtype)
    return A3TModelConfig(
        odim=20, vocab_size=40,
        encoder=EncoderConfig(cnn_module_kernel=7, **stack),
        decoder=EncoderConfig(cnn_module_kernel=31, **stack),
        postnet_layers=2, postnet_chans=16)


@functools.lru_cache(maxsize=None)
def _jax_forward(product_biases: bool = True):
    batch = make_batch(np.random.default_rng(0), 2, 40, 8, 20, 40)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    v = _random(jax_mlm.A3TMLMModel(_config("float32")).init(
        jax.random.PRNGKey(0), **jb), product_biases=product_biases)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        before, after, _ = jax_mlm.A3TMLMModel(_config(dtype)).apply(v, **jb)
        loss = jax_mlm.mlm_loss(before, after, jb["speech"],
                                jb["masked_position"])
        outs[dtype] = (np.asarray(before), np.asarray(after), float(loss))
    return batch, v, outs


def _model_forward(flash: bool, product_biases: bool):
    """[(what, port, JAX bf16, JAX fp32)] for before, after and the loss."""
    batch, v, outs = _jax_forward(product_biases)
    model = build_model(port_config(_config("bfloat16"), flash), device="cpu")
    from_jax.load_state(model, from_jax.mlm_state(v))
    tb = {k: torch.tensor(a) for k, a in batch.items()}
    with torch.no_grad():
        before, after = model(**tb)
        loss = mlm_loss(before, after, tb["speech"], tb["masked_position"])
    assert before.dtype == after.dtype == torch.float32
    return [(what, got, outs["bfloat16"][i], outs["float32"][i])
            for i, (what, got) in enumerate((("before", before.numpy()),
                                             ("after", after.numpy()),
                                             ("loss", float(loss))))]


@pytest.mark.parametrize("flash", [False, True])
def test_model_forward_and_loss_bf16_match_jax(flash):
    for what, got, want16, want32 in _model_forward(flash, True):
        _within_gap(got, want16, want32, what)


@pytest.mark.parametrize("flash", [False, True])
def test_model_forward_and_loss_bf16_sharp(flash):
    for what, got, want16, want32 in _model_forward(flash, False):
        _within_rms_gap(got, want16, want32, what)


def test_24k_config_takes_bfloat16():
    cfg = a3t_conformer_24k(80, compute_dtype="bfloat16")
    assert cfg.encoder.compute_dtype == cfg.decoder.compute_dtype == \
        "bfloat16"
    assert a3t_conformer_24k(80).encoder.compute_dtype == "float32"
    assert cfg.encoder.use_cnn_module and cfg.decoder.cnn_module_kernel == 31


FRONTEND = dict(n_mels=20)
BATCH = dict(batch_size=2, n_samples=300 * 39, n_text=8, hop_length=300,
             vocab_size=40)
OPTIM = dict(lr=1.0, model_size=64, warmup_steps=10, grad_clip=1.0,
             adam_eps=1e-3)


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """One JAX train step (its default fused front-end) in each dtype from
    the same random parameters, the postnet's dropout set to 0 through the
    module namespace."""
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        batch = jax_synthetic_batch(np.random.default_rng(3), **BATCH)
        dev = {k: jnp.asarray(a) for k, a in batch.items()}
        init = None
        out = {}
        for dtype in ("float32", "bfloat16"):
            model = jax_mlm.A3TMLMModel(_config(dtype))
            state = jax_create_train_state(
                model, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
                jax_featurize(fe, dev))
            if init is None:
                init = _random({"params": state.params,
                                "batch_stats": state.batch_stats})
            state = state.replace(
                params=jax.tree_util.tree_map(jnp.asarray, init["params"]),
                batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                   init["batch_stats"]))
            state, stats = jax_make_train_step(model, fe, donate=False)(
                state, dev, jax.random.PRNGKey(0))
            out[dtype] = (from_jax.mlm_state(
                {"params": state.params, "batch_stats": state.batch_stats}),
                {k: float(x) for k, x in stats.items()})
    finally:
        jax_mlm.Postnet = postnet
    return batch, init, out


def _port_step(flash: bool):
    """(port stats, port state dict, JAX bf16 (state, stats), JAX fp32 (state,
    stats), the compared leaves)."""
    batch, init, out = _jax_steps()
    model = build_model(port_config(_config("bfloat16"), flash), device="cpu")
    model.postnet.dropout.rate = 0.0
    from_jax.load_state(model, from_jax.mlm_state(init))
    state = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                               device="cpu")
    fe = LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu")
    state, stats = make_train_step(model, fe, device="cpu")(state, batch, 0)
    assert int(stats["notfinite_count"]) == 0
    names = [n for n in out["bfloat16"][0]
             if not n.endswith("num_batches_tracked")]
    return stats, state.model.state_dict(), out["bfloat16"], \
        out["float32"], names


@pytest.mark.parametrize("flash", [False, True])
def test_train_step_bf16_matches_jax(flash):
    """Loss and grad_norm within the gap; every parameter and BatchNorm
    statistic after the step within the gap of the whole state; and each
    leaf that the step moved apart in bf16 within twice its own gap in root
    mean square (so that the largest leaf cannot hide the others)."""
    stats, got, (w16, s16), (w32, s32), names = _port_step(flash)
    for k in ("loss", "grad_norm"):
        _within_gap(float(stats[k]), s16[k], s32[k], k)
    _within_gap(np.concatenate([got[n].numpy().ravel() for n in names]),
                np.concatenate([w16[n].ravel() for n in names]),
                np.concatenate([w32[n].ravel() for n in names]),
                "the state after the step")
    for n in names:
        gap = _rms(w16[n] - w32[n])
        if gap > 0:  # a leaf the step moved apart in bf16
            err = _rms(got[n].numpy() - w16[n])
            assert err <= 2 * gap, f"{n}: rms(port - JAX bf16) {err:.3g} " \
                f"> twice JAX's bf16-vs-fp32 gap {gap:.3g}"
