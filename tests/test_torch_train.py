"""The port's training slice (a3t_tpu_torch/train/train_step.py) against the
JAX package's ``make_train_step(model, fe, use_fused=False)`` (the port's
step takes ``use_fused=False`` too: the rfft front-end on both sides), for a
tiny
config (2+2 blocks of width 64, postnet 2x16, 20 mel bins) with every
dropout rate 0.

Dropout bits cannot match across frameworks, so both run with dropout off:
the encoder configs set their three rates to 0, and the postnet's fixed 0.5
is set to 0 on both sides (the port's module attribute; in JAX the test
hands A3TMLMModel a Postnet with dropout_rate=0 through its module
namespace, leaving the package's files as they are).

The batches come from the port's make_synthetic_batch and equal JAX's bit
for bit.  Both start from the same init, carried across by from_jax, and
take three steps.  The optimizer is the yaml's Adam + Noam with a short
warmup (10 steps, model_size 64) so that the parameters move, and Adam's
eps set to 1e-3: parameters whose gradient is zero in exact arithmetic (the
key bias, which softmax ignores, and the depthwise-conv bias, which
BatchNorm removes) get rounding noise of ~1e-7 as gradient in both
frameworks, which eps 1e-8 would turn into full +-lr steps of random sign;
with 1e-3 they stay put while real gradients (|g| ~ 0.1..10) still take
full Adam steps.  The optimizer itself is held to optax at eps 1e-8 in
tests/test_torch_optim.py.

Tolerances (fp32, CPU): losses rtol 2e-5 and grad_norm rtol 2e-4 (the
front-ends differ by ~1e-5 in log-mel, and the two frameworks sum the
same products in another order); parameters and BatchNorm running
statistics atol 2e-5 after three steps of size ~1e-2.  On the CPU the JAX
model takes its XLA attention branch (conformer.py:216-219); the port runs
both its flash branch (the kernels' plain versions) and its plain branch.
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
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_eval_step as jax_make_eval_step
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.compat.from_jax import (load_state, load_train_state,
                                           mlm_state)
from a3t_tpu_torch.data import make_synthetic_batch
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_eval_step, make_optimizer,
                                 make_train_step)
from test_torch_mlm import port_config

ENC = EncoderConfig(attention_dim=64, attention_heads=2, linear_units=128,
                    num_blocks=2, cnn_module_kernel=7, dropout_rate=0.0,
                    positional_dropout_rate=0.0, attention_dropout_rate=0.0)
CFG = A3TModelConfig(odim=20, vocab_size=40, encoder=ENC, decoder=ENC,
                     postnet_layers=2, postnet_chans=16)
FRONTEND = dict(n_mels=20)
BATCH = dict(batch_size=2, n_samples=300 * 47, n_text=8, hop_length=300,
             vocab_size=40)
OPTIM = dict(lr=1.0, model_size=64, warmup_steps=10, grad_clip=1.0,
             adam_eps=1e-3)
N_STEPS = 3
PARAM_ATOL = 2e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps on batches 0..2 (one compiled step, shared by the
    tests of this module): the initial variables, the states after steps 2
    and 3, each step's stats, and the eval loss on batch 0 after step 3."""
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(CFG)
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        batches = [jax_synthetic_batch(np.random.default_rng(i), **BATCH)
                   for i in range(N_STEPS)]
        dev = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        state = jax_create_train_state(
            model, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
            jax_featurize(fe, dev[0], use_fused=False))
        init = _np_tree({"params": state.params,
                         "batch_stats": state.batch_stats})
        step = jax_make_train_step(model, fe, use_fused=False, donate=False)
        states, stats = [], []
        for i in range(N_STEPS):
            state, s = step(state, dev[i], jax.random.PRNGKey(i))
            states.append(_np_tree(state))
            stats.append({k: float(v) for k, v in s.items()})
        eval_loss = float(jax_make_eval_step(model, fe)(state, dev[0])["loss"])
    finally:
        jax_mlm.Postnet = postnet
    return dict(batches=batches, init=init, states=states, stats=stats,
                eval_loss=eval_loss)


def _port_state(init, flash: bool = True):
    model = build_model(port_config(CFG, flash), device="cpu")
    model.postnet.dropout.rate = 0.0
    load_state(model, mlm_state(init))
    state = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                               device="cpu")
    fe = LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu")
    return state, make_train_step(model, fe, device="cpu",
                                  use_fused=False), fe


def _assert_state_matches(state, jax_state):
    want = mlm_state({"params": jax_state.params,
                      "batch_stats": jax_state.batch_stats})
    got = state.model.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value,
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=name)
    assert state.step == int(jax_state.step)


def _assert_stats_match(stats, want):
    assert float(stats["loss"]) == pytest.approx(want["loss"], rel=2e-5)
    assert float(stats["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                      rel=2e-4)
    assert float(stats["masked_frames"]) == want["masked_frames"]
    assert int(stats["notfinite_count"]) == want["notfinite_count"] == 0


def test_synthetic_batches_equal_jax():
    """The same np.random.Generator state gives the same arrays, bit for
    bit, at the bench's layout and at the test's."""
    for kw in (BATCH, dict(batch_size=3, n_samples=300 * 431, n_text=64,
                           hop_length=300, vocab_size=80)):
        ours = make_synthetic_batch(np.random.default_rng(0), **kw)
        want = jax_synthetic_batch(np.random.default_rng(0), **kw)
        assert ours.keys() == want.keys()
        for k in want:
            assert ours[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(ours[k], want[k], err_msg=k)


@pytest.mark.parametrize("flash", [True, False])
def test_three_steps_match_jax(jax_run, flash):
    state, step, _ = _port_state(jax_run["init"], flash)
    for i in range(N_STEPS):
        state, stats = step(state, jax_run["batches"][i], i)
        _assert_stats_match(stats, jax_run["stats"][i])
    _assert_state_matches(state, jax_run["states"][-1])


def test_resume_from_a_jax_state(jax_run):
    """JAX takes two steps; the port takes over its whole state (weights,
    batch_stats, Adam's moments, the counts) through from_jax; both take
    step 3 and agree."""
    state, step, _ = _port_state(jax_run["init"])
    load_train_state(state, jax_run["states"][1])
    assert state.step == 2 and state.opt_state.count.item() == 2
    state, stats = step(state, jax_run["batches"][2], 2)
    _assert_stats_match(stats, jax_run["stats"][2])
    _assert_state_matches(state, jax_run["states"][2])
    adam = [s for s in jax_run["states"][2].opt_state.inner_state
            if hasattr(s, "mu")][0]
    mu = mlm_state({"params": adam.mu,
                    "batch_stats": jax_run["states"][2].batch_stats})
    names = [n for n, _ in state.model.named_parameters()]
    np.testing.assert_allclose(
        state.opt_state.mu.numpy(),
        np.concatenate([mu[n].ravel() for n in names]), atol=1e-4, rtol=0)


def test_eval_step_matches_jax(jax_run):
    """After three steps the eval loss (running statistics, no dropout)
    equals JAX's within rtol 2e-5."""
    state, step, fe = _port_state(jax_run["init"])
    for i in range(N_STEPS):
        state, _ = step(state, jax_run["batches"][i], i)
    loss = make_eval_step(state.model, fe, device="cpu")(
        state, jax_run["batches"][0])["loss"]
    assert float(loss) == pytest.approx(jax_run["eval_loss"], rel=2e-5)
    assert not state.model.training


def test_int16_audio_is_dequantized(jax_run):
    """int16 PCM batches give the features of audio / 32768 (train_step.py
    :115-118)."""
    _, _, fe = _port_state(jax_run["init"])
    from a3t_tpu_torch.train import featurize

    batch = dict(jax_run["batches"][0])
    pcm = np.round(batch["audio"] * 32767).astype(np.int16)
    a = featurize(fe, {**batch, "audio": pcm})
    b = featurize(fe, {**batch, "audio": pcm.astype(np.float32) / 32768.0})
    assert torch.equal(a["speech"], b["speech"])
    assert torch.equal(a["masked_position"],
                       torch.tensor(batch["masked_position"])
                       & a["speech_mask"])


def test_dropout_step_is_seeded(jax_run):
    """With the yaml's dropout rates, the same rng gives the same step and
    another rng another one; the loss stays finite."""
    cfg = dataclasses.replace(
        CFG, encoder=dataclasses.replace(ENC, dropout_rate=0.2,
                                         positional_dropout_rate=0.2,
                                         attention_dropout_rate=0.2))
    cfg = dataclasses.replace(cfg, decoder=cfg.encoder)
    losses = []
    for rng in (5, 5, 6):
        model = build_model(port_config(cfg), device="cpu", seed=0)
        state = create_train_state(model, make_optimizer(), device="cpu")
        fe = LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu")
        _, stats = make_train_step(model, fe, device="cpu")(
            state, jax_run["batches"][0], rng)
        losses.append(float(stats["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("recipe", ["24k", "16k"])
def test_featurize_matches_jax_fused_frontend(recipe):
    """The port's featurize with its rfft front-end (``use_fused=False``)
    against JAX's default ``featurize(fe, batch, use_fused=True)`` (the
    matmul DFT) at the shipped front-ends, 80 mel bins, 4 utterances of 432
    frames: log-mel features within atol 5e-5 (the same fp32 chain, the DFT
    summed another way; measured 8.8e-6 at 24 kHz and 9.3e-6 at 16 kHz on
    features up to 2.9), masks equal."""
    from a3t_tpu_torch.tasks.config import FRONTEND_16K, FRONTEND_24K
    from a3t_tpu_torch.train import featurize

    cfg = {"24k": FRONTEND_24K, "16k": FRONTEND_16K}[recipe]
    kw = dataclasses.asdict(cfg)
    batch = jax_synthetic_batch(
        np.random.default_rng(0), batch_size=4,
        n_samples=cfg.hop_length * 431, n_text=16,
        hop_length=cfg.hop_length, vocab_size=40, fs=cfg.fs)
    want = jax_featurize(JaxLogMelFrontend(JaxLogMelConfig(**kw)),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         use_fused=True)
    got = featurize(LogMelFrontend(cfg, device="cpu"), batch,
                    use_fused=False)
    assert tuple(got["speech"].shape) == want["speech"].shape == (4, 432, 80)
    np.testing.assert_allclose(got["speech"].numpy(),
                               np.asarray(want["speech"]), atol=5e-5, rtol=0)
    for k in ("speech_mask", "masked_position"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
