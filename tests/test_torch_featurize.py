"""The port's featurize options and the train step that uses them
(a3t_tpu_torch/train/train_step.py) against the JAX package's: gather_audio
from a flat int16 corpus (offsets clamped as ``dynamic_slice`` clamps them),
featurize with ``use_fused``, ``normalizer`` and ``corpus`` +
``audio_offset``, key by key, and one tiny train step with a GlobalMVN
normalizer, the matmul-DFT front-end and the corpus against JAX's
``make_train_step(..., normalizer=..., use_fused=True, corpus=...)``.
Inputs from numpy with a seed; fp32 on the CPU.

Tolerances.  Features (|x| up to ~3, normalized up to ~5) within atol 1e-5:
the same fp32 chain summed in another order (measured ~1e-6); masks,
integer tensors and gathered PCM equal.  The step: the tiny config of
tests/test_torch_train.py at dropout 0 and its tolerances (loss rtol 2e-5,
grad_norm rtol 2e-4, parameters and BatchNorm statistics atol 2e-5).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data import make_synthetic_batch as jax_synthetic_batch
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.dsp import normalize as jn
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu.train.train_step import gather_audio as jax_gather_audio
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.dsp import (GlobalMVN, LogMelConfig, LogMelFrontend,
                               UtteranceMVN)
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.train import (OptimConfig, create_train_state, featurize,
                                 gather_audio, make_optimizer,
                                 make_train_step)
from test_torch_mlm import port_config
from test_torch_train import BATCH, CFG, FRONTEND, OPTIM, PARAM_ATOL

HOP = BATCH["hop_length"]


def _corpus_batch(seed: int, **kw):
    """A synthetic batch, and the same audio as int16 PCM laid out in a flat
    corpus (in reverse order, with gaps): (batch with int16 ``audio``, batch
    with ``audio_offset`` and no ``audio``, the corpus)."""
    batch = jax_synthetic_batch(np.random.default_rng(seed), **kw)
    pcm = np.round(batch["audio"] * 32767).astype(np.int16)
    b, s = pcm.shape
    corpus = np.zeros(b * (s + 37) + 11, np.int16)
    offsets = np.zeros(b, np.int32)
    for i, pos in enumerate(range(b - 1, -1, -1)):
        off = 11 + pos * (s + 37)
        n = int(batch["audio_lengths"][i])
        pcm[i, n:] = 0  # as a host batcher pads
        corpus[off:off + n] = pcm[i, :n]
        offsets[i] = off
    pcm_batch = {**batch, "audio": pcm}
    off_batch = {k: v for k, v in batch.items() if k != "audio"}
    off_batch["audio_offset"] = offsets
    return pcm_batch, off_batch, corpus


def test_gather_audio_matches_jax():
    """Utterances zero past their lengths; offsets past the corpus's end are
    clamped so the slice fits (the last one here)."""
    _, batch, corpus = _corpus_batch(0, **BATCH)
    batch["audio_offset"][-1] = len(corpus) - 5
    want = jax_gather_audio(jnp.asarray(corpus),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            HOP)
    got = gather_audio(torch.tensor(corpus), batch, HOP)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="corpus"):
        gather_audio(torch.tensor(corpus[:100]), batch, HOP)


def _normalizers(kind: str):
    if kind == "none":
        return None, None
    if kind == "utterance":
        return jn.UtteranceMVN(), UtteranceMVN()
    rng = np.random.default_rng(5)
    mean = rng.uniform(-2.0, 1.0, FRONTEND["n_mels"]).astype(np.float32)
    std = rng.uniform(0.5, 1.5, FRONTEND["n_mels"]).astype(np.float32)
    return jn.GlobalMVN(mean, std), GlobalMVN(mean, std)


@pytest.mark.parametrize("source", ["audio", "corpus"])
@pytest.mark.parametrize("norm", ["none", "global", "utterance"])
@pytest.mark.parametrize("use_fused", [True, False])
def test_featurize_matches_jax(use_fused, norm, source):
    pcm_batch, off_batch, corpus = _corpus_batch(1, **BATCH)
    batch = pcm_batch if source == "audio" else off_batch
    jnorm, tnorm = _normalizers(norm)
    kw = dict(use_fused=use_fused)
    jcorpus = tcorpus = None
    if source == "corpus":
        jcorpus, tcorpus = jnp.asarray(corpus), torch.tensor(corpus)
    want = jax_featurize(JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND)),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         normalizer=jnorm, corpus=jcorpus, **kw)
    got = featurize(LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu"),
                    batch, normalizer=tnorm, corpus=tcorpus, **kw)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["speech"].numpy(),
                               np.asarray(want["speech"]), atol=1e-5, rtol=0)
    for k in want:
        if k != "speech":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


def test_featurize_corpus_equals_audio_and_passes_spemb():
    """The corpus route gives the features of the same PCM passed as
    ``audio``, bit for bit; ``spemb`` passes through; a batch with offsets
    and no corpus raises."""
    pcm_batch, off_batch, corpus = _corpus_batch(2, **BATCH)
    fe = LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu")
    spemb = np.random.default_rng(3).standard_normal(
        (BATCH["batch_size"], 8)).astype(np.float32)
    a = featurize(fe, {**pcm_batch, "spemb": spemb})
    b = featurize(fe, off_batch, corpus=torch.tensor(corpus))
    for k in b:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(a["spemb"], torch.tensor(spemb)) and "spemb" not in b
    with pytest.raises(ValueError, match="corpus"):
        featurize(fe, off_batch)


def _jax_step():
    """One JAX step with GlobalMVN, the fused front-end and the corpus, from
    JAX's init, with the postnet's dropout set to 0 through the module
    namespace."""
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(CFG)
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        pcm_batch, off_batch, corpus = _corpus_batch(4, **BATCH)
        jnorm, _ = _normalizers("global")
        state = jax_create_train_state(
            model, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
            jax_featurize(fe, {k: jnp.asarray(v)
                               for k, v in pcm_batch.items()}))
        init = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        step = jax_make_train_step(model, fe, donate=False, normalizer=jnorm,
                                   use_fused=True,
                                   corpus=jnp.asarray(corpus))
        state, stats = step(state, {k: jnp.asarray(v)
                                    for k, v in off_batch.items()},
                            jax.random.PRNGKey(0))
    finally:
        jax_mlm.Postnet = postnet
    return off_batch, corpus, init, state, {k: float(v)
                                            for k, v in stats.items()}


def test_train_step_with_normalizer_and_corpus_matches_jax():
    off_batch, corpus, init, jstate, jstats = _jax_step()
    model = build_model(port_config(CFG), device="cpu")
    model.postnet.dropout.rate = 0.0
    load_state(model, mlm_state(init))
    state = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                               device="cpu")
    fe = LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu")
    _, tnorm = _normalizers("global")
    step = make_train_step(model, fe, device="cpu", normalizer=tnorm,
                           use_fused=True, corpus=torch.tensor(corpus))
    state, stats = step(state, off_batch, 0)
    assert float(stats["loss"]) == pytest.approx(jstats["loss"], rel=2e-5)
    assert float(stats["grad_norm"]) == pytest.approx(jstats["grad_norm"],
                                                      rel=2e-4)
    assert float(stats["masked_frames"]) == jstats["masked_frames"]
    assert int(stats["notfinite_count"]) == 0
    want = mlm_state({"params": jstate.params,
                      "batch_stats": jstate.batch_stats})
    got = state.model.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value,
                                       atol=PARAM_ATOL, rtol=0, err_msg=name)
