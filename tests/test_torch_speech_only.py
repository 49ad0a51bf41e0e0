"""Speech-only training in the port (models/mlm.py ``speech_only``,
data/dataset.py and data/batcher.py's speech-only branches, the steps'
``speech_only=``) against the JAX package, on the CPU, at a toy width.

* The model's speech-only forward (the sentinel token takes
  ``segment_emb(0)``, the speech none) against ``A3TMLMModel.apply(...,
  speech_only=True)``, weights carried across by compat/from_jax.py: fp32,
  atol 1e-5 on outputs of O(1) (1+1 blocks of width 32).
* A speech-only dataset and its batches (the sentinel token, frame spans
  masked at 0.15) against JAX's, bit for bit over two epochs, on the same
  16 kHz corpus written by both packages.
* One dropout-0 speech-only train step against JAX's ``make_train_step(
  ..., speech_only=True, use_fused=False)`` from one init: loss within
  rtol 2e-5 and the parameters within atol 2e-5, test_torch_train.py's
  tolerances (the rfft front-ends differ by ~1e-5 in log-mel); and the
  speech-only eval step against JAX's within rtol 2e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data.batcher import BatcherConfig as JaxBatcherConfig
from a3t_tpu.data.batcher import BucketBatcher as JaxBucketBatcher
from a3t_tpu.data.dataset import A3TDataset as JaxA3TDataset
from a3t_tpu.data import miniature as jax_miniature
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TMLMModel, A3TModelConfig, EncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_eval_step as jax_make_eval_step
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.data import miniature
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_eval_step, make_optimizer,
                                 make_train_step)
from test_torch_mlm import jax_variables, make_batch, port_config

FE = dict(fs=16000, n_fft=1024, hop_length=200, win_length=800, n_mels=20,
          fmin=80.0, fmax=7600.0)
BATCHER = dict(batch_bins=20 * 128 * 3, bucket_frames=(64, 128),
               min_frames=16)
NO_DROPOUT = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                  attention_dropout_rate=0.0)
ENC = EncoderConfig(attention_dim=32, attention_heads=2, linear_units=32,
                    num_blocks=1, cnn_module_kernel=7, **NO_DROPOUT)
CFG = A3TModelConfig(odim=20, vocab_size=12, encoder=ENC, decoder=ENC,
                     postnet_layers=2, postnet_chans=16)
OPTIM = dict(lr=1.0, model_size=32, warmup_steps=10, grad_clip=1.0,
             adam_eps=1e-3)
@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """One 16 kHz corpus written by both packages (21-110 frames)."""
    d = tmp_path_factory.mktemp("so16k")
    kw = dict(n_utts=12, n_speakers=2, fs=16000, n_phones_range=(3, 10),
              seed=9)
    return (miniature.generate_speechlike_corpus(str(d / "port"), **kw),
            jax_miniature.generate_speechlike_corpus(str(d / "jax"), **kw))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the toy models' many small ops run no slower,
    and the test workers running beside this one do not oversubscribe the
    cores (with a thread pool per worker, a Trainer run here took 40 times
    its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batchers(corpora):
    port = BucketBatcher(A3TDataset(corpora[0], speech_only=True),
                         LogMelConfig(**FE), BatcherConfig(**BATCHER))
    jax_ = JaxBucketBatcher(JaxA3TDataset(corpora[1], speech_only=True),
                            JaxLogMelConfig(**FE), JaxBatcherConfig(**BATCHER))
    return port, jax_


def test_speech_only_forward_matches_jax(rng):
    batch = make_batch(rng, 2, 40, 8, 20, 12)
    batch["text"][:, 1:] = 0
    batch["text_mask"][:, 1:] = False
    batch["text"][:, 0] = 1
    jm = A3TMLMModel(CFG)
    v = jax_variables(jm, batch, rng)
    jb, ja, _ = jm.apply(v, **{k: jnp.asarray(a) for k, a in batch.items()},
                         speech_only=True)
    model = build_model(port_config(CFG), device="cpu")
    load_state(model, mlm_state(v))
    with torch.no_grad():
        tb = {k: torch.tensor(a) for k, a in batch.items()}
        before, after = model(**tb, speech_only=True)
        ordinary = model(**tb)[1]
    np.testing.assert_allclose(before.numpy(), np.asarray(jb), atol=1e-5)
    np.testing.assert_allclose(after.numpy(), np.asarray(ja), atol=1e-5)
    assert (ordinary - after).abs().max() > 1e-3  # the flag matters


def test_speech_only_dataset_and_batches_equal_jax(corpora, batchers):
    port, jax_ = batchers
    assert port.dataset.speech_only and port.dataset.uids == \
        jax_.dataset.uids
    for uid in port.dataset.uids:
        assert port.dataset.num_phones(uid) == 0
        assert port.dataset.get_meta(uid) == jax_.dataset.get_meta(uid)
    assert [dataclasses.astuple(b) for b in port.buckets] == [
        dataclasses.astuple(b) for b in jax_.buckets]
    n = 0
    for epoch in (1, 2):
        for got, want in zip(port.epoch_iterator(epoch),
                             jax_.epoch_iterator(epoch), strict=True):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            filled = got["audio_lengths"] > 0
            assert (got["text"][filled, 0] == 1).all()
            assert not got["text_mask"][:, 1:].any()
            assert got["masked_position"][filled].any()
            assert (got["speech_segment_pos"] == 0).all()
            n += 1
    assert n >= 4


def test_speech_only_step_matches_jax(batchers):
    port_b, jax_b = batchers
    host = next(port_b.epoch_iterator(0))
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(CFG)
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FE))
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        state = jax_create_train_state(
            model, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
            jax_featurize(fe, jb, use_fused=False))
        init = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        step = jax_make_train_step(model, fe, speech_only=True,
                                   use_fused=False, donate=False)
        state, stats = step(state, jb, jax.random.PRNGKey(0))
        want_eval = float(jax_make_eval_step(
            model, fe, speech_only=True)(state, jb)["loss"])
    finally:
        jax_mlm.Postnet = postnet

    tm = build_model(port_config(CFG), device="cpu")
    tm.postnet.dropout.rate = 0.0
    load_state(tm, mlm_state(init))
    ts = create_train_state(tm, make_optimizer(OptimConfig(**OPTIM)),
                            device="cpu")
    pfe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    ts, got = make_train_step(tm, pfe, device="cpu", use_fused=False,
                              speech_only=True)(ts, host, 0)
    assert float(got["loss"]) == pytest.approx(float(stats["loss"]),
                                               rel=2e-5)
    assert float(got["masked_frames"]) == float(stats["masked_frames"])
    want = mlm_state({"params": jax.tree_util.tree_map(np.asarray,
                                                       state.params),
                      "batch_stats": jax.tree_util.tree_map(
                          np.asarray, state.batch_stats)})
    sd = tm.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[name].numpy(), value, atol=2e-5,
                                       rtol=0, err_msg=name)
    got_eval = make_eval_step(tm, pfe, device="cpu", speech_only=True)(
        ts, host)
    assert float(got_eval["loss"]) == pytest.approx(want_eval, rel=2e-5)
