"""The port's speaker-conditioned A3T model (a3t_tpu_torch/models/mlm.py
with ``spemb_dim > 0``), its batches (data/batcher.py ``spemb_map``,
tasks/mlm.py ``_build_spemb_map``), its train step and its editor
(inference/sedit.py ``spemb_fn``, bin/mcd_gate.py ``run_gate(spembs=)``)
against the JAX package on the CPU.

Tolerances (fp32): forwards atol 1e-4 on outputs of O(1..10) (as
test_torch_mlm.py); the trained stash artifacts/spemb_params within 1e-4
of each output's largest magnitude (as test_torch_stash.py); the
dropout-0 step as test_torch_train.py (loss rtol 2e-5, grad_norm rtol 2e-4,
parameters atol 2e-5); the editor's mel atol 1e-4 (as
test_torch_serve_cli.py); batches and the embedding maps bit for bit.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data import make_synthetic_batch as jax_synthetic_batch
from a3t_tpu.data.batcher import BatcherConfig as JaxBatcherConfig
from a3t_tpu.data.batcher import BucketBatcher as JaxBucketBatcher
from a3t_tpu.data.dataset import A3TDataset as JaxA3TDataset
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.inference import FileAlignmentSource as JaxFileAlignmentSource
from a3t_tpu.inference import SpeechEditor as JaxSpeechEditor
from a3t_tpu.models import A3TMLMModel, A3TModelConfig, EncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.models import xvector as jxv
from a3t_tpu.tasks import config as jax_config
from a3t_tpu.tasks.mlm import MLMTask as JaxMLMTask
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.bin import mcd_gate as port_mcd_gate
from a3t_tpu_torch.bin import sedit as port_sedit
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.data import make_synthetic_batch
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.inference import FileAlignmentSource, SpeechEditor
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models import xvector as xv
from a3t_tpu_torch.tasks.config import FRONTEND_16K, config_from_dict
from a3t_tpu_torch.tasks.mlm import MLMTask
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_optimizer, make_train_step)
from test_torch_mlm import jax_variables, make_batch, port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STASH = os.path.join(ROOT, "artifacts", "spemb_params")
XV_DIR = os.path.join(ROOT, "artifacts", "xvector")
ATOL = 1e-4
SPEMB = 12


def tiny_config(spemb_dim=SPEMB, odim=20, dropout=0.2):
    enc = EncoderConfig(attention_dim=32, attention_heads=2, linear_units=64,
                        num_blocks=1, cnn_module_kernel=7,
                        dropout_rate=dropout,
                        positional_dropout_rate=dropout,
                        attention_dropout_rate=dropout)
    return A3TModelConfig(odim=odim, vocab_size=40, encoder=enc, decoder=enc,
                          postnet_layers=2, postnet_chans=16,
                          spemb_dim=spemb_dim)


def _jb(batch):
    return {k: jnp.asarray(a) for k, a in batch.items()}


def _tb(batch):
    return {k: torch.tensor(a) for k, a in batch.items()}


@pytest.mark.parametrize("flash", [True, False])
def test_spemb_forward_matches_jax(rng, flash):
    """Random weights (spemb_out's away from its zero init): with an
    x-vector and without one (zeros: the projections' biases alone), the
    spemb layers under the JAX tree's names."""
    cfg = tiny_config()
    batch = make_batch(rng, 2, 24, 6, 20, 40)
    batch["spemb"] = 3.0 * rng.standard_normal((2, SPEMB)).astype(np.float32)
    jm = A3TMLMModel(cfg)
    v = jax_variables(jm, batch, rng)
    v["params"]["spemb_out"] = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        v["params"]["spemb_out"])
    model = build_model(port_config(cfg, flash), device="cpu")
    assert model.spemb_out.weight.abs().max() == 0  # zero-initialised
    load_state(model, mlm_state(v))
    assert {k for k in model.state_dict() if "spemb" in k} == {
        f"{n}.{w}" for n in ("spemb_proj", "spemb_proj_mid", "spemb_out")
        for w in ("weight", "bias")}
    for b in (batch, {k: a for k, a in batch.items() if k != "spemb"}):
        jb, ja, _ = jm.apply(v, **_jb(b))
        with torch.no_grad():
            before, after = model(**_tb(b))
        np.testing.assert_allclose(before.numpy(), np.asarray(jb), atol=ATOL)
        np.testing.assert_allclose(after.numpy(), np.asarray(ja), atol=ATOL)


def test_spemb_stash_forward_matches_jax(rng):
    """artifacts/spemb_params (trained in bf16, run in fp32 on both sides,
    as test_torch_stash.py) with speaker spk5's x-vector of
    artifacts/xvector/spk2xvector.npz on a 1 s, 12-phone utterance."""
    if not os.path.isdir(STASH):
        pytest.skip("artifacts/spemb_params is not in this checkout")
    from a3t_tpu.train.checkpoint import restore_portable

    cfg = jax_config.load_config(os.path.join(STASH, "config.yaml"))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(np.float32),
        restore_portable(STASH)["params"])
    model_cfg = dataclasses.replace(
        cfg.model, vocab_size=params["text_embed"]["embedding"].shape[0],
        encoder=dataclasses.replace(cfg.model.encoder,
                                    compute_dtype="float32"),
        decoder=dataclasses.replace(cfg.model.decoder,
                                    compute_dtype="float32"))
    assert model_cfg.spemb_dim == 192 and "spemb_out" in params
    fs, hop = cfg.frontend.fs, cfg.frontend.hop_length
    t = np.arange(fs) / fs
    wav = (0.1 * np.sin(2 * np.pi * (140 + 20 * t) * t)
           + 0.003 * rng.standard_normal(t.size)).astype(np.float32)
    n_f, f_pad, t_pad = 1 + wav.size // hop, 128, 12
    audio = np.zeros((1, (f_pad - 1) * hop), np.float32)
    audio[0, :wav.size] = wav
    feats = np.asarray(JaxLogMelFrontend(cfg.frontend)(
        jnp.asarray(audio), jnp.asarray([wav.size]))[0])
    edges = np.linspace(0, n_f, t_pad + 1).astype(int)
    ssp = np.zeros((1, f_pad), np.int32)
    for j in range(t_pad):
        ssp[0, edges[j]:edges[j + 1]] = j + 1
    masked = np.zeros((1, f_pad), bool)
    masked[0, edges[4]:edges[8]] = True
    with np.load(os.path.join(XV_DIR, "spk2xvector.npz")) as f:
        spemb = f["spk5"][None].astype(np.float32)
    batch = dict(
        speech=feats, masked_position=masked,
        text=rng.integers(2, model_cfg.vocab_size - 1, (1, t_pad)).astype(
            np.int32),
        speech_mask=np.arange(f_pad)[None] < n_f,
        text_mask=np.ones((1, t_pad), bool), speech_segment_pos=ssp,
        text_segment_pos=np.arange(1, t_pad + 1, dtype=np.int32)[None],
        spemb=spemb)
    jm = A3TMLMModel(model_cfg)
    stats = jm.init(jax.random.PRNGKey(0), **_jb(batch))["batch_stats"]
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.asarray, stats)}
    jb, ja, _ = jm.apply(variables, **_jb(batch))
    model = build_model(port_config(model_cfg), device="cpu")
    load_state(model, mlm_state(variables))
    with torch.no_grad():
        before, after = model(**_tb(batch))
    for got, ref in ((before, jb), (after, ja)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max())


# -- batches and the embedding map ------------------------------------------------

FE = dict(fs=24000, n_mels=20)
BATCHER = dict(batch_bins=4000, bucket_frames=[128, 256], min_frames=4,
               use_native_loader=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_mini_corpus(str(tmp_path_factory.mktemp("sp") / "d"),
                                n_utts=8, fs=24000, n_phones_range=(5, 12))


def test_batcher_spemb_matches_jax(corpus, rng):
    """Batches with a spemb_map (float32 (B, E), zero in empty slots) equal
    JAX's bit for bit; the other arrays are untouched by the map."""
    tokens = build_token_list(read_2column_text(f"{corpus}/text").values())
    ds = A3TDataset(corpus, TokenIDConverter(tokens))
    spemb_map = {u: rng.standard_normal(5).astype(np.float32)
                 for u in ds.uids}
    port = BucketBatcher(ds, LogMelConfig(**FE), BatcherConfig(**BATCHER),
                         spemb_map=spemb_map)
    plain = BucketBatcher(ds, LogMelConfig(**FE), BatcherConfig(**BATCHER))
    jax_b = JaxBucketBatcher(
        JaxA3TDataset(corpus, JaxTokenIDConverter(tokens)),
        JaxLogMelConfig(**FE), JaxBatcherConfig(**BATCHER),
        spemb_map=spemb_map)
    got = list(port.epoch_iterator(1))
    want = list(jax_b.epoch_iterator(1))
    base = list(plain.epoch_iterator(1))
    assert len(got) == len(want) >= 2
    for g, w, b in zip(got, want, base):
        assert g.keys() == w.keys() == set(b) | {"spemb"}
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in b:
            np.testing.assert_array_equal(g[k], b[k], err_msg=k)
        n = int(g["text_mask"].any(1).sum())
        assert (g["spemb"][n:] == 0).all()


def test_build_spemb_map_order_matches_jax(corpus, tmp_path, rng):
    """utt2xvector.npz in the data directory first, then spemb_file by uid,
    then spemb_file by speaker (utt2spk); JAX's map equal bit for bit; a
    uid that resolves nowhere, or no source at all, raises."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    for name in ("wav.scp", "text", "mfa_start", "mfa_end", "utt2spk"):
        os.symlink(os.path.join(corpus, name), os.path.join(data, name))
    ds = A3TDataset(data)
    uids = list(ds.uids)
    vec = {}

    def draw(key):
        vec[key] = rng.standard_normal(4).astype(np.float32)
        return vec[key]

    np.savez(os.path.join(data, "utt2xvector.npz"),
             **{u: draw(("local", u)) for u in uids[:2]})
    table = {u: draw(("uid", u)) for u in uids[1:4]}
    table.update({s: draw(("spk", s)) for s in ("spk0", "spk1", "spk2")})
    np.savez(str(tmp_path / "table.npz"), **table)
    base = dict(train_data_dir=data, spemb_file=str(tmp_path / "table.npz"),
                model={"spemb_dim": 4})
    got = MLMTask._build_spemb_map(config_from_dict(base), ds, data)
    want = JaxMLMTask._build_spemb_map(jax_config.config_from_dict(base),
                                       JaxA3TDataset(data), data)
    assert sorted(got) == sorted(want) == uids
    spk = read_2column_text(os.path.join(data, "utt2spk"))
    for i, u in enumerate(uids):
        src = (("local", u) if i < 2 else ("uid", u) if i < 4
               else ("spk", spk[u]))
        np.testing.assert_array_equal(got[u], vec[src])
        np.testing.assert_array_equal(got[u], want[u])
    del table["spk2"]
    np.savez(str(tmp_path / "table.npz"), **table)
    with pytest.raises(ValueError, match="no speaker embedding"):
        MLMTask._build_spemb_map(config_from_dict(base), ds, data)
    os.remove(os.path.join(data, "utt2xvector.npz"))
    with pytest.raises(ValueError, match="neither"):
        MLMTask._build_spemb_map(config_from_dict(
            {**base, "spemb_file": ""}), ds, data)


# -- one train step ---------------------------------------------------------------

OPTIM = dict(lr=1.0, model_size=32, warmup_steps=10, grad_clip=1.0,
             adam_eps=1e-3)
BATCH = dict(batch_size=2, n_samples=300 * 47, n_text=8, hop_length=300,
             vocab_size=40)


def test_spemb_train_step_matches_jax():
    """One dropout-0 step (the postnet's fixed 0.5 too, as in
    test_torch_train.py) on a batch carrying spemb: loss, grad_norm and
    every parameter after the update, the three spemb layers included."""
    cfg = tiny_config(dropout=0.0)
    batch = jax_synthetic_batch(np.random.default_rng(0), **BATCH)
    assert all(np.array_equal(a, batch[k]) for k, a in make_synthetic_batch(
        np.random.default_rng(0), **BATCH).items())
    batch["spemb"] = np.random.default_rng(1).standard_normal(
        (2, SPEMB)).astype(np.float32)
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        jm = jax_mlm.A3TMLMModel(cfg)
        fe = JaxLogMelFrontend(JaxLogMelConfig(n_mels=20))
        dev = _jb(batch)
        state = jax_create_train_state(
            jm, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
            jax_featurize(fe, dev, use_fused=False))
        init = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        state, want = jax_make_train_step(jm, fe, use_fused=False,
                                          donate=False)(
            state, dev, jax.random.PRNGKey(0))
        want_state = mlm_state(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))
    finally:
        jax_mlm.Postnet = postnet
    model = build_model(port_config(cfg), device="cpu")
    model.postnet.dropout.rate = 0.0
    load_state(model, mlm_state(init))
    st = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                            device="cpu")
    step = make_train_step(model, LogMelFrontend(LogMelConfig(n_mels=20),
                                                 device="cpu"),
                           device="cpu", use_fused=False)
    st, stats = step(st, batch, 0)
    assert float(stats["loss"]) == pytest.approx(float(want["loss"]),
                                                 rel=2e-5)
    assert float(stats["grad_norm"]) == pytest.approx(
        float(want["grad_norm"]), rel=2e-4)
    got = st.model.state_dict()
    moved = 0
    for name, value in want_state.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value, atol=2e-5,
                                       rtol=0, err_msg=name)
            moved += name.startswith("spemb_out") and bool(
                np.abs(value).max() > 0)
    assert moved == 2  # spemb_out left zero and moved, in both packages


# -- the editor and the MCD gate ------------------------------------------------------

FE16 = {k: getattr(FRONTEND_16K, k) for k in (
    "fs", "n_fft", "hop_length", "win_length", "n_mels", "fmin", "fmax")}


@pytest.fixture(scope="module")
def editor_case(tmp_path_factory):
    """A 16 kHz corpus, a tiny speaker-conditioned model (80 mel bins, the
    192-dim x-vectors of artifacts/xvector) with random spemb weights, and
    the same weights in a JAX editor."""
    if not os.path.isdir(XV_DIR):
        pytest.skip("artifacts/xvector is not in this checkout")
    data = generate_mini_corpus(str(tmp_path_factory.mktemp("ed") / "d"),
                                n_utts=3, fs=16000, n_phones_range=(9, 12))
    rng = np.random.default_rng(5)
    cfg = tiny_config(spemb_dim=192, odim=80)
    model = build_model(port_config(cfg), device="cpu", seed=2)
    with torch.no_grad():
        model.spemb_out.weight.normal_(generator=torch.Generator()
                                       .manual_seed(3))
    texts = read_2column_text(f"{data}/text")
    tokens = build_token_list(texts.values())
    lexicon = port_sedit.phone_lexicon(texts)
    variables = jax_mlm_variables(model)
    jed = JaxSpeechEditor(
        A3TMLMModel(cfg), variables, JaxLogMelConfig(**FE16),
        JaxTokenIDConverter(tokens), lexicon=lexicon,
        spemb_fn=jxv.make_spemb_extractor(
            XV_DIR, JaxLogMelFrontend(JaxLogMelConfig(**FE16))))
    fe = LogMelFrontend(LogMelConfig(**FE16), device="cpu")
    ed = SpeechEditor(model, LogMelConfig(**FE16), TokenIDConverter(tokens),
                      lexicon=lexicon, device="cpu",
                      spemb_fn=xv.make_spemb_extractor(XV_DIR, fe))
    return data, ed, jed, rng


def jax_mlm_variables(model):
    from a3t_tpu.compat.torch_import import convert_model_state

    v = convert_model_state(model.state_dict())
    # convert_model_state has no names for the spemb layers
    for name in ("spemb_proj", "spemb_proj_mid", "spemb_out"):
        v["params"][name] = {
            "kernel": getattr(model, name).weight.detach().numpy().T,
            "bias": getattr(model, name).bias.detach().numpy()}
    return v


def test_editor_spemb_fn_matches_jax(editor_case):
    """A [MASK] reconstruction through spemb_fn (the x-vector of the
    unmasked context) and with an explicit spemb: the mel against JAX's
    editor; the explicit x-vector changes it."""
    data, ed, jed, rng = editor_case
    uid = sorted(read_2column_text(f"{data}/text"))[0]
    text = read_2column_text(f"{data}/text")[uid]
    masked = port_mcd_gate.protocol_mask(text)
    wav = A3TDataset(data)[uid]["audio"]
    align, jalign = FileAlignmentSource(data)(uid), \
        JaxFileAlignmentSource(data)(uid)
    got = ed.reconstruct_masked_span(wav, align, text, masked)
    want = jed.reconstruct_masked_span(wav, jalign, text, masked)
    np.testing.assert_allclose(got.mel_edited, want.mel_edited, atol=ATOL)
    spemb = 5.0 * rng.standard_normal(192).astype(np.float32)
    got2 = ed.reconstruct_masked_span(wav, align, text, masked, spemb=spemb)
    want2 = jed.reconstruct_masked_span(wav, jalign, text, masked,
                                        spemb=spemb)
    np.testing.assert_allclose(got2.mel_edited, want2.mel_edited, atol=ATOL)
    assert np.abs(got2.mel_edited - got.mel_edited).max() > 1e-3


def test_run_gate_passes_spembs(editor_case, tmp_path, monkeypatch):
    """run_gate(spembs=...) hands each uid's x-vector to the edit (uids it
    lacks take the extractor), as JAX's does."""
    data, ed, _, rng = editor_case
    texts = read_2column_text(f"{data}/text")
    uids = sorted(texts)[:2]
    spembs = {uids[0]: rng.standard_normal(192).astype(np.float32)}
    seen = []
    edit = ed.edit

    def spy(*a, spemb=None, **kw):
        seen.append(spemb)
        return edit(*a, spemb=spemb, **kw)

    monkeypatch.setattr(ed, "edit", spy)
    report = port_mcd_gate.run_gate(ed, texts, A3TDataset(data),
                                    FileAlignmentSource(data), uids,
                                    str(tmp_path / "g"), spembs=spembs)
    assert report["n"] == 2
    assert seen[0] is spembs[uids[0]] and seen[1] is None
