"""Longformer attention dilation and the chunked-einsum path of the port
(a3t_tpu_torch/models/windowed_attention.py) against the JAX package's
WindowedSelfAttention, and the tiny longformer model with
``use_pallas_attention: false`` against JAX's CPU model.

* Dilation 1, 2 and 4 through the banded path (K3-K5's plain versions on
  the CPU) against JAX's ``use_pallas=True`` module, whose Pallas kernels
  run in interpret mode, on a batch whose second utterance is half padding,
  with 6 text tokens (2 padded) and with none (the pre-encoder's case,
  where the padded phases' rows see no key at all).  At dropout 0.2 the
  banded kernels draw their keep-masks from one seed by a counter hash of
  the batch row, so the port must put phase r of utterance bi in row
  bi * d + r, as JAX does; the test hands the port JAX's seed and holds the
  speech rows (the text rows' SeededDropout bits differ between the
  frameworks by design).
* The chunked path (``use_banded=False``) against JAX's ``use_pallas=False``
  module at dilation 1 and 2 on the same batches, every row included.
* One train step of the tiny longformer model (width 32, 1 pre-encoder + 2
  encoder blocks, window 8) on a batch whose second utterance is half
  padding, with ``use_pallas_attention: false`` on both sides: JAX's CPU
  model takes its chunked path there too.

Tolerances, float32: the same products summed in another order; outputs
and gradients within 4e-6 of each array's largest magnitude (at least
1e-5), as tests/test_torch_longformer.py holds dilation 1; the train step's
loss within rtol 2e-5 and grad_norm within rtol 2e-4, its parameters within
2e-5 (tests/test_torch_longformer.py's step limits).
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu.data import make_synthetic_batch as jax_synthetic_batch
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models import windowed_attention as wa
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_optimizer, make_train_step)
from test_torch_longformer import (FRONTEND, HOP, OPTIM, WINDOW, _close,
                                   _config, _np_tree, _random_params)
from test_torch_mlm import port_config

jwa = importlib.import_module("a3t_tpu.models.windowed_attention")
jba = importlib.import_module("a3t_tpu.ops.banded_attention")

N_FRAMES = 32


def _case(n_text: int, seed: int = 0):
    """(x, mask, w): utterance 1 has its second half padded (and its last 2
    text tokens); w weighs the speech rows of the output."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, N_FRAMES + n_text, 32)).astype(np.float32)
    mask = np.ones((2, N_FRAMES + n_text), bool)
    mask[1, N_FRAMES // 2:N_FRAMES] = False
    if n_text:
        mask[1, -2:] = False
    w = rng.standard_normal(x.shape).astype(np.float32)
    w[:, N_FRAMES:] = 0.0
    return x, mask, w


def _pair(x, mask, dilation, use_pallas, rate):
    jmod = jwa.WindowedSelfAttention(2, WINDOW, dropout_rate=rate,
                                     dilation=dilation, use_pallas=use_pallas)
    v = _random_params(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 N_FRAMES, jnp.asarray(mask)))
    mod = wa.WindowedSelfAttention(32, 2, WINDOW, rate, dilation=dilation,
                                   use_banded=use_pallas)
    from_jax.load_state(mod, {k.split(".", 1)[1]: a for k, a in
                              from_jax.attention(v["params"], "m").items()})
    return jmod, v, mod


def _jax_seed(jmod, v, x, mask, rng, monkeypatch):
    """The int seed JAX's module hands its banded kernels under ``rng``
    (banded_attention.py:457-461), read from an eager forward."""
    seen = []
    real = jba.banded_attention

    def spy(*args, dropout_rng=None, **kw):
        if dropout_rng is not None:
            seen.append(int(jax.random.randint(
                dropout_rng, (1,), minval=0,
                maxval=np.iinfo(np.int32).max, dtype=jnp.int32)[0]))
        return real(*args, dropout_rng=dropout_rng, **kw)

    monkeypatch.setattr(jba, "banded_attention", spy)
    jmod.apply(v, jnp.asarray(x), N_FRAMES, jnp.asarray(mask),
               deterministic=False, rngs={"dropout": rng})
    monkeypatch.setattr(jba, "banded_attention", real)
    assert len(seen) == 1
    return seen[0]


def _check(x, mask, w, dilation, use_pallas, rate, monkeypatch):
    jmod, v, mod = _pair(x, mask, dilation, use_pallas, rate)
    rng = jax.random.PRNGKey(7)
    det = rate == 0.0

    def loss(params, xx):
        out = jmod.apply({"params": params}, xx, N_FRAMES, jnp.asarray(mask),
                         deterministic=det, rngs={"dropout": rng})
        return (out * w).sum(), out

    if not det:
        seed = _jax_seed(jmod, v, x, mask, rng, monkeypatch)
        monkeypatch.setattr(wa, "draw_seed", lambda g: seed)
        mod.train()
    else:
        mod.eval()
    (_, ref), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        v["params"], jnp.asarray(x))
    xt = torch.tensor(x).requires_grad_()
    out = mod(xt, N_FRAMES, torch.tensor(mask), torch.Generator())
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(),
                                [xt] + list(mod.parameters()))
    rows = slice(None) if det else slice(0, N_FRAMES)
    _close(out.detach()[:, rows], np.asarray(ref)[:, rows], "out")
    _close(grads[0], gx, "x")
    want = from_jax.attention(_np_tree(gp), "m")
    for (name, _), got in zip(mod.named_parameters(), grads[1:]):
        _close(got, want[f"m.{name}"], name)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("n_text", [6, 0])
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_dilated_banded_matches_pallas_module(dilation, n_text, rate,
                                              monkeypatch):
    _check(*_case(n_text), dilation, True, rate, monkeypatch)


@pytest.mark.parametrize("n_text", [6, 0])
@pytest.mark.parametrize("dilation", [1, 2])
def test_chunked_path_matches_jax_chunked_module(dilation, n_text,
                                                 monkeypatch):
    _check(*_case(n_text, seed=1), dilation, False, 0.0, monkeypatch)


def test_phase_order_and_text_repeat():
    """Frame p * d + r of utterance bi is row bi * d + r, position p, and
    every phase of an utterance sees that utterance's text."""
    b, f, dl = 2, 8, 2
    seen = {}

    def spy(q, k, v, kt, vt, txm, window, speech_mask=None, **kw):
        seen.update(q=q, kt=kt, spm=speech_mask)
        return q

    mod = wa.WindowedSelfAttention(2, 1, 4, dilation=dl).eval()
    with torch.no_grad():
        for lin in (mod.linear_q, mod.linear_k, mod.linear_v,
                    mod.linear_out):
            lin.weight.copy_(torch.eye(2))
            lin.bias.zero_()
    x = torch.arange(b * (f + 3) * 2, dtype=torch.float32).view(b, f + 3, 2)
    mask = torch.ones(b, f + 3, dtype=torch.bool)
    mask[1, 5:f] = False
    real = wa.banded_attention
    wa.banded_attention = spy
    try:
        mod(x, f, mask)
    finally:
        wa.banded_attention = real
    q = seen["q"]
    assert q.shape == (b * dl, 1, f // dl, 2)
    for bi in range(b):
        for r in range(dl):
            assert torch.equal(q[bi * dl + r, 0], x[bi, r:f:dl])
            assert torch.equal(seen["kt"][bi * dl + r, 0], x[bi, f:])
            assert torch.equal(seen["spm"][bi * dl + r], mask[bi, r:f:dl])


# ---------------------------------------------------------------------------
# the tiny longformer model through the chunked path
# ---------------------------------------------------------------------------

def _chunked_config(dtype="float32"):
    cfg = _config(dtype)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, use_pallas_attention=False))


def _half_padded_batch():
    batch = jax_synthetic_batch(np.random.default_rng(3), batch_size=2,
                                n_samples=HOP * 31, n_text=6, hop_length=HOP,
                                vocab_size=40, fs=16000)
    batch["audio_lengths"] = np.array([HOP * 31, HOP * 16], np.int32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_chunked_step():
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(_chunked_config())
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        batch = _half_padded_batch()
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


def test_chunked_longformer_step_matches_jax_cpu_model():
    """The port's model with use_pallas_attention false takes JAX's chunked
    formula, padded rows included, so its step equals JAX's CPU step on a
    half-padded batch; the banded path (the Pallas semantics) does not
    there (ROADMAP C1)."""
    batch, init, jstate, jstats = _jax_chunked_step()
    runs = {}
    for chunked in (True, False):
        cfg = port_config(_chunked_config())
        if not chunked:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, use_pallas_attention=True))
        model = build_model(cfg, device="cpu")
        model.postnet.dropout.rate = 0.0
        from_jax.load_state(model, from_jax.mlm_state(init))
        state = create_train_state(
            model, make_optimizer(OptimConfig(**OPTIM)), device="cpu")
        fe = LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu")
        state, stats = make_train_step(model, fe, device="cpu")(
            state, batch, 0)
        runs[chunked] = (state, {k: float(v) for k, v in stats.items()})
    state, stats = runs[True]
    assert stats["loss"] == pytest.approx(jstats["loss"], rel=2e-5)
    assert stats["grad_norm"] == pytest.approx(jstats["grad_norm"], rel=2e-4)
    want = from_jax.mlm_state({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
    got = state.model.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value, atol=2e-5,
                                       rtol=0, err_msg=name)
    # JAX's CPU step reads 117.2337 here, the banded path 116.4650
    banded = runs[False][1]["grad_norm"]
    assert abs(banded - jstats["grad_norm"]) > 2e-3 * jstats["grad_norm"]
