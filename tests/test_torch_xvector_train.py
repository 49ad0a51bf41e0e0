"""The port's x-vector trainer (a3t_tpu_torch/models/xvector.py:
speaker_classification_loss, sample_crops, xvector_step, train_xvector;
train/optim.py::ClipAdam) against the JAX package's
(a3t_tpu/models/xvector.py:89-236), on the CPU, at a narrow width
(channels 32, embedding 16, 20 mel bins) on a generated 16 kHz corpus of 3
speakers.

* The loss and the accuracy: within 1e-6 relative (fp32).
* One step from carried weights (clip 5.0 -> Adam at lr 1e-3): the loss
  within rtol 1e-5 and each parameter after the update within atol 1e-6
  (an Adam step moves each by ~1e-3; the frameworks' gradients differ by
  summation order only).
* train_xvector's batches: with JAX's corpus extraction patched to return
  the port's mels (the two FFTs round differently), every batch of every
  step equals JAX's bit for bit, and so do the corpus statistics.
* The written directory: the report's keys are JAX's, and the port's and
  JAX's load_xvector read it to the same embeddings within 1e-5 of their
  largest value.
"""

import dataclasses
import functools
import json
import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.dsp import frontend as jax_frontend
from a3t_tpu.models import xvector as jxv
from a3t_tpu_torch.compat.from_jax import load_state, xvector_state
from a3t_tpu_torch.data.miniature import generate_speechlike_corpus
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import xvector as xv
from a3t_tpu_torch.train.optim import ClipAdam

FE = dict(fs=16000, n_fft=1024, hop_length=200, win_length=800, n_mels=20)
NET = dict(n_mels=20, channels=32, embed_dim=16)
TRAIN = dict(crop_frames=16, batch_size=4, total_steps=4, lr=1e-3, seed=3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("xv16k")
    kw = dict(n_speakers=3, fs=16000, n_phones_range=(4, 10),
              speaker_seed=0)
    return (generate_speechlike_corpus(str(d / "train"), n_utts=12, seed=1,
                                       **kw),
            generate_speechlike_corpus(str(d / "valid"), n_utts=4, seed=2,
                                       **kw))


def test_speaker_classification_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 5)).astype(np.float32) * 3
    logits[3] = 1.0  # a tie: the first maximum wins in both
    ids = rng.integers(0, 5, 16).astype(np.int32)
    loss, acc = xv.speaker_classification_loss(torch.tensor(logits),
                                               torch.tensor(ids))
    want_loss, want_acc = jxv.speaker_classification_loss(
        jnp.asarray(logits), jnp.asarray(ids))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert float(acc) == float(want_acc)


def test_step_from_carried_weights_matches_jax():
    cfg = jxv.XVectorConfig(**NET, n_speakers=3)
    model = jxv.XVectorNet(cfg)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((4, 32, 20)).astype(np.float32)
    sid = np.array([0, 2, 1, 2], np.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(mel))["params"]
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))

    # JAX train_xvector's step (xvector.py:178-187)
    def loss_fn(p):
        _, logits = model.apply({"params": p}, jnp.asarray(mel), train=True)
        return jxv.speaker_classification_loss(logits, jnp.asarray(sid))

    (want_loss, _), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = xvector_state({"params": optax.apply_updates(params, updates)})

    net = load_state(xv.XVectorNet(xv.XVectorConfig(**NET, n_speakers=3)),
                     xvector_state({"params": params}))
    ctx = ClipAdam(1e-3, 5.0)
    loss, _ = xv.xvector_step(net, ctx, ctx.init(net.parameters()), mel, sid)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    got = net.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-6, rtol=0,
                                   err_msg=k)


class _Recorder(types.SimpleNamespace):
    """jax.numpy with asarray recording its host arguments."""

    def __init__(self):
        super().__init__(seen=[])

    def asarray(self, x, *a, **kw):
        if isinstance(x, np.ndarray):
            self.seen.append(np.array(x))
        return jnp.asarray(x, *a, **kw)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The port's and JAX's train_xvector on the same corpus, JAX's
    extraction returning the port's mels; each side's batches."""
    d = tmp_path_factory.mktemp("xvruns")
    fe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    port_batches = []
    sample = xv.sample_crops

    def record(*a, **kw):
        out = sample(*a, **kw)
        port_batches.append(out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(xv, "sample_crops", record)
    try:
        model, report = xv.train_xvector(
            corpus[0], fe, str(d / "port"), xv.XVectorConfig(**NET),
            eval_data_dir=corpus[1], log_fn=lambda s: None, **TRAIN)
    finally:
        mp.undo()

    recorder = _Recorder()
    mp.setattr(jax_frontend, "extract_corpus_mels",
               functools.partial(_port_mels, fe))
    mp.setattr(jxv, "jnp", recorder)
    try:
        jxv.train_xvector(
            corpus[0], JaxLogMelFrontend(JaxLogMelConfig(**FE)),
            str(d / "jax"), jxv.XVectorConfig(**NET),
            eval_data_dir=corpus[1], log_fn=lambda s: None, **TRAIN)
    finally:
        mp.undo()
    n = TRAIN["total_steps"]
    jax_batches = list(zip(recorder.seen[0:2 * n:2], recorder.seen[1:2 * n:2]))
    return dict(port=str(d / "port"), jax=str(d / "jax"), model=model,
                report=report, port_batches=port_batches,
                jax_batches=jax_batches)


def _port_mels(fe, _jax_frontend, wavs, chunk=32):
    from a3t_tpu_torch.dsp.frontend import extract_corpus_mels

    return extract_corpus_mels(fe, wavs, chunk)


def test_train_xvector_batches_equal_jax(runs):
    assert len(runs["port_batches"]) == TRAIN["total_steps"]
    for (pm, ps), (jm, js) in zip(runs["port_batches"], runs["jax_batches"]):
        assert pm.dtype == jm.dtype and ps.dtype == js.dtype
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(ps, js)
    lengths = {m.shape[1] for m, _ in runs["port_batches"]}
    assert lengths <= {16, 32, 64}
    with open(os.path.join(runs["port"], "xvector.json")) as f:
        port_meta = json.load(f)
    with open(os.path.join(runs["jax"], "xvector.json")) as f:
        jax_meta = json.load(f)
    assert port_meta["mel_mean"] == jax_meta["mel_mean"]
    assert port_meta["mel_std"] == jax_meta["mel_std"]


def test_train_xvector_files_read_by_both_loaders(runs):
    with open(os.path.join(runs["port"], "xvector.json")) as f:
        meta = json.load(f)
    with open(os.path.join(runs["jax"], "xvector.json")) as f:
        assert set(meta) == set(json.load(f))
    report = runs["report"]
    assert meta["speakers"] == report["speakers"] and len(
        report["speakers"]) == 3
    assert report["eval_n"] == 4 and 0.0 <= report["eval_acc"] <= 1.0
    assert [h["step"] for h in report["train_history"]] == [4]
    assert np.isfinite(report["train_history"][0]["loss"])
    feats = np.random.default_rng(4).standard_normal(
        (2, 40, 20)).astype(np.float32)
    port_model, mvn = xv.load_xvector(runs["port"], device="cpu")
    jm, jv, jmvn = jxv.load_xvector(runs["port"])
    np.testing.assert_array_equal(mvn[0], jmvn[0])
    with torch.no_grad():
        got = port_model(torch.tensor(feats))[0].numpy()
        direct = runs["model"](torch.tensor(feats))[0].numpy()
    want = np.asarray(jm.apply(jv, jnp.asarray(feats))[0])
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert port_model.config == dataclasses.replace(
        xv.XVectorConfig(**NET), n_speakers=3)
