"""The trained stash artifacts/soak12k_params, restored with
``a3t_tpu.train.checkpoint.restore_portable`` and carried into the port by
a3t_tpu_torch/compat/from_jax.py: both forwards agree on one utterance.

The stash was trained with compute_dtype bfloat16; here BOTH packages run it
in float32 (compute_dtype overridden to "float32", the bf16 weights cast to
float32), so the comparison is of the algorithm, not of two bf16 rounding
schedules.  The stash holds parameters only: the BatchNorm statistics are
the model's initial ones (mean 0, variance 1) on both sides, which lets the
trained postnet's five 256-channel convolutions scale its output up to ~30.
Tolerance: 1e-4 of each output's largest magnitude (fp32 rounding grows
with the range; measured about 6e-6 before and 3e-5 after the postnet)."""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

STASH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "soak12k_params")


@pytest.fixture(scope="module")
def stash():
    if not os.path.isdir(STASH):
        pytest.skip("artifacts/soak12k_params is not in this checkout")
    from a3t_tpu.tasks.config import load_config
    from a3t_tpu.train.checkpoint import restore_portable

    cfg = load_config(os.path.join(STASH, "config.yaml"))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(np.float32),
        restore_portable(STASH)["params"])
    return cfg, params


def test_stash_forward_matches_jax(stash):
    import torch

    from a3t_tpu.dsp import LogMelFrontend
    from a3t_tpu.models import A3TMLMModel
    from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
    from a3t_tpu_torch.models import build_model
    from test_torch_mlm import port_config

    cfg, params = stash
    model_cfg = dataclasses.replace(
        cfg.model, vocab_size=params["text_embed"]["embedding"].shape[0],
        encoder=dataclasses.replace(cfg.model.encoder, compute_dtype="float32"),
        decoder=dataclasses.replace(cfg.model.decoder, compute_dtype="float32"))
    assert cfg.model.encoder.compute_dtype == "bfloat16"

    # one 1.6 s utterance of 16 phones at the stash's 16 kHz front-end,
    # the middle phones masked as in a [MASK] edit
    rng = np.random.default_rng(0)
    fe = LogMelFrontend(cfg.frontend)
    fs, hop = cfg.frontend.fs, cfg.frontend.hop_length
    t = np.arange(int(1.6 * fs)) / fs
    f0 = 120 + 30 * np.sin(2 * np.pi * 1.5 * t)
    wav = sum(np.sin(2 * np.pi * np.cumsum(f0 * k) / fs) / k
              for k in range(1, 6)) * 0.1
    wav = (wav + 0.003 * rng.standard_normal(t.size)).astype(np.float32)
    n_f = 1 + wav.size // hop
    f_pad = 192
    audio = np.zeros((1, (f_pad - 1) * hop), np.float32)
    audio[0, :wav.size] = wav
    feats = np.asarray(fe(jnp.asarray(audio), jnp.asarray([wav.size]))[0])
    n_ph, t_pad = 16, 16
    edges = np.linspace(0, n_f, n_ph + 1).astype(int)
    ssp = np.zeros((1, f_pad), np.int32)
    for j in range(n_ph):
        ssp[0, edges[j]:edges[j + 1]] = j + 1
    masked = np.zeros((1, f_pad), bool)
    masked[0, edges[6]:edges[10]] = True
    batch = dict(
        speech=feats,
        text=rng.integers(2, model_cfg.vocab_size - 1, (1, t_pad)).astype(
            np.int32),
        masked_position=masked,
        speech_mask=np.arange(f_pad)[None] < n_f,
        text_mask=np.ones((1, t_pad), bool),
        speech_segment_pos=ssp,
        text_segment_pos=np.arange(1, t_pad + 1, dtype=np.int32)[None])

    jm = A3TMLMModel(model_cfg)
    stats = jm.init(jax.random.PRNGKey(0),
                    **{k: jnp.asarray(a) for k, a in batch.items()}
                    )["batch_stats"]
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.asarray, stats)}
    jb, ja, _ = jm.apply(variables,
                         **{k: jnp.asarray(a) for k, a in batch.items()})

    model = build_model(port_config(model_cfg), device="cpu")
    load_state(model, mlm_state(variables))
    with torch.no_grad():
        before, after = model(**{k: torch.tensor(a) for k, a in batch.items()})
    for got, ref in ((before, jb), (after, ja)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max())
    assert np.isfinite(after.numpy()).all()
