"""The duration-aware A3T variant in the port (masking/alignment.py's
duration_reduction, the batcher's duration_collect, models/mlm.py's
duration predictor and tts_forward, train/train_step.py's
make_tts_train_step and the ordinary step's duration term, the weight
routes, tasks/mlm.py and the CLIs) against the JAX package, on the CPU, at
a tiny width (1+1 blocks of width 32, postnet 2x16, 20 mel bins, a
2-layer duration predictor at its fixed 256 channels).

Dropout: the JAX variant's duration predictor has a fixed rate of 0.1 and
its postnet one of 0.5, which no config sets, so for the step the test
hands the JAX model both modules with rate 0 through its module namespace
(as tests/test_torch_train.py does for the postnet), leaving the package's
files as they are; the port's modules get rate 0 as attributes.

Tolerances (fp32): the reduction and the batches bit for bit; the forward's
outputs within 1e-5 of their largest value (the frameworks sum in another
order); the step's losses rtol 2e-5 and each parameter after the update
atol 2e-5 (tests/test_torch_train.py's, whose Adam eps of 1e-3 this test
takes for the reason given there); the ESPnet keys exactly.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.compat.torch_import import convert_model_state
from a3t_tpu.data import batcher as jax_batcher
from a3t_tpu.data import dataset as jax_dataset
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.masking.alignment import duration_reduction as jax_reduction
from a3t_tpu.models import A3TModelConfig as JaxA3TModelConfig
from a3t_tpu.models import EncoderConfig as JaxEncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import TrainState as JaxTrainState
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu.train.train_step import make_tts_train_step as jax_tts_step
from a3t_tpu_torch.bin import sedit as port_sedit
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.compat import espnet
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state, predictor
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.miniature import generate_speechlike_corpus
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.masking import duration_reduction
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.tasks.mlm import MLMTask
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_optimizer, make_train_step)
from a3t_tpu_torch.train.train_step import featurize, make_tts_train_step
from test_torch_mlm import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml")
FE = dict(fs=24000, n_fft=2048, hop_length=300, win_length=1200, n_mels=20,
          fmin=80.0, fmax=7600.0)
BATCHER = dict(batch_bins=20 * 128 * 3, bucket_frames=(128, 256),
               min_frames=16, duration_collect=True)
STACK = dict(attention_dim=32, attention_heads=2, linear_units=32,
             num_blocks=1, dropout_rate=0.0, positional_dropout_rate=0.0,
             attention_dropout_rate=0.0)
OPTIM = dict(lr=1.0, model_size=32, warmup_steps=100, grad_clip=1.0,
             adam_eps=1e-3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tts24k")
    kw = dict(n_speakers=3, fs=24000, n_phones_range=(4, 18))
    return (generate_speechlike_corpus(str(d / "train"), n_utts=16, seed=5,
                                       **kw),
            generate_speechlike_corpus(str(d / "valid"), n_utts=4, seed=6,
                                       **kw))


@pytest.fixture(scope="module")
def batchers(corpus):
    texts = read_2column_text(os.path.join(corpus[0], "text")).values()
    tokens = build_token_list(texts)
    port = BucketBatcher(A3TDataset(corpus[0], TokenIDConverter(tokens)),
                         LogMelConfig(**FE), BatcherConfig(**BATCHER))
    jax_b = jax_batcher.BucketBatcher(
        jax_dataset.A3TDataset(corpus[0], JaxTokenIDConverter(tokens)),
        JaxLogMelConfig(**FE), jax_batcher.BatcherConfig(**BATCHER))
    return port, jax_b, len(tokens)


def _jax_config(vocab):
    enc = JaxEncoderConfig(**STACK, cnn_module_kernel=7)
    return JaxA3TModelConfig(odim=20, vocab_size=vocab, encoder=enc,
                             decoder=enc, postnet_layers=2, postnet_chans=16,
                             duration_predictor_layers=2)


@pytest.fixture(scope="module")
def jax_side(batchers):
    """JAX's initial variables, one TTS step and one ordinary step from
    them on the first batch of epoch 1, with the duration predictor's and
    the postnet's dropout at 0."""
    _, jax_b, vocab = batchers
    host = next(jax_b.epoch_iterator(1))
    saved = jax_mlm.Postnet, jax_mlm.DurationPredictor
    jax_mlm.Postnet = functools.partial(saved[0], dropout_rate=0.0)
    jax_mlm.DurationPredictor = functools.partial(saved[1], dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(_jax_config(vocab))
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FE))
        dev = {k: jnp.asarray(v) for k, v in host.items()}
        tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
        mb = jax.jit(jax_featurize, static_argnums=0)(fe, dev)
        # create_train_state's init, jitted (flax's eager init is slow)
        v = jax.jit(lambda b: model.init(jax.random.PRNGKey(0), **b))(mb)
        state0 = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
            tx=tx)
        init = jax.tree_util.tree_map(np.asarray, v)
        out = {"host": host, "init": init}
        for name, make in (
                ("tts", lambda: jax_tts_step(model, fe, donate=False)),
                ("plain", lambda: jax_make_train_step(
                    model, fe, use_fused=False, donate=False))):
            state, stats = make()(state0, dev, jax.random.PRNGKey(0))
            out[name] = (jax.tree_util.tree_map(np.asarray, {
                "params": state.params, "batch_stats": state.batch_stats}),
                {k: float(v) for k, v in stats.items()})
        # the forwards on the featurized batch, eval mode
        out["forward"] = [np.asarray(x) for x in jax.jit(
            lambda b: model.apply(v, **b))(mb)]
        red = _reduce_np({k: np.asarray(x) for k, x in mb.items()}, host)
        out["tts_forward"] = [np.asarray(x) for x in jax.jit(
            lambda b: model.apply(v, **b, out_frames=mb["speech"].shape[1],
                                  method=model.tts_forward))(red)]
        out["mb"] = {k: np.asarray(v) for k, v in mb.items()}
    finally:
        jax_mlm.Postnet, jax_mlm.DurationPredictor = saved
    return out


def _reduce_np(mb, host):
    """The TTS step's reduced inputs (JAX train_step.py:361-379), numpy."""
    ri = host["reordered_index"]
    n_f = mb["speech"].shape[1]

    def red(x):
        return np.take_along_axis(x, ri, axis=1)

    valid = (np.arange(n_f)[None] < host["reduced_lengths"][:, None]) \
        & red(mb["speech_mask"])
    return dict(speech=np.take_along_axis(mb["speech"], ri[..., None], 1),
                text=mb["text"], masked_position=red(mb["masked_position"])
                & valid, speech_mask=valid, text_mask=mb["text_mask"],
                speech_segment_pos=red(mb["speech_segment_pos"]),
                text_segment_pos=mb["text_segment_pos"],
                durations=red(host["durations"]))


def _port_model(init, vocab):
    model = build_model(port_config(_jax_config(vocab)), device="cpu")
    model.postnet.dropout.rate = 0.0
    for layer in model.duration_predictor.conv:
        layer[3].rate = 0.0
    return load_state(model, mlm_state(init))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_duration_reduction_matches_jax():
    """Random alignments and masks, with masked frames before the first
    phone (which collapse to position 0) and a padded tail."""
    rng = np.random.default_rng(0)
    for case in range(40):
        n_frames = int(rng.integers(20, 120))
        n_f = int(rng.integers(10, n_frames + 1))
        n_ph = int(rng.integers(1, 12))
        cuts = np.sort(rng.choice(np.arange(1, n_f), size=min(n_ph, n_f - 1),
                                  replace=False))
        starts = np.concatenate([[cuts[0] // 2 if case % 2 else 0],
                                 cuts[:-1]]).astype(np.int32)
        ends = cuts.astype(np.int32)
        masked = rng.random(n_frames) < 0.4
        masked[n_f:] = False
        got = duration_reduction(n_frames, starts, ends, len(ends), masked,
                                 n_f)
        want = jax_reduction(n_frames, starts, ends, len(ends), masked, n_f)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype


def test_duration_collect_batches_equal_jax(batchers):
    port, jax_b, _ = batchers
    for epoch in (1, 2):
        got = list(port.epoch_iterator(epoch))
        want = list(jax_b.epoch_iterator(epoch))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert {"durations", "reordered_index", "reduced_lengths"} <= set(got[0])


def test_forward_and_tts_forward_match_jax(batchers, jax_side):
    """Eval mode: the forward's log durations (by keyword; the tuple stays
    two long) and tts_forward's outputs within 1e-5 of their largest."""
    model = _port_model(jax_side["init"], batchers[2])
    mb = {k: torch.tensor(v) for k, v in jax_side["mb"].items()}
    with torch.no_grad():
        assert len(model(**mb)) == 2
        got = model(**mb, return_log_durations=True)
        red = _reduce_np(jax_side["mb"], jax_side["host"])
        tts = model.tts_forward(**{k: torch.tensor(v)
                                   for k, v in red.items()},
                                out_frames=mb["speech"].shape[1])
    for g, w in zip(list(got) + list(tts),
                    jax_side["forward"] + jax_side["tts_forward"]):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w, 1e-5)


def _assert_state(model, want):
    for name, value in mlm_state(want).items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                model.state_dict()[name].numpy(), value, atol=2e-5, rtol=0,
                err_msg=name)


@pytest.mark.parametrize("kind", ["tts", "plain"])
def test_step_matches_jax(batchers, jax_side, kind):
    """One dropout-0 step from the same weights: make_tts_train_step, and
    the ordinary step with its duration term over the masked frames (the
    rfft front-end on both sides there)."""
    model = _port_model(jax_side["init"], batchers[2])
    state = create_train_state(model, make_optimizer(OptimConfig(**OPTIM)),
                               device="cpu")
    fe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    step = (make_tts_train_step(model, fe, device="cpu") if kind == "tts"
            else make_train_step(model, fe, device="cpu", use_fused=False))
    state, stats = step(state, jax_side["host"], 0)
    want_state, want = jax_side[kind]
    for k in ("loss", "loss_mlm", "loss_duration"):
        assert float(stats[k]) == pytest.approx(want[k], rel=2e-5), k
    assert float(stats["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                      rel=2e-4)
    assert float(stats["loss_duration"]) > 0
    _assert_state(state.model, want_state)


def test_espnet_duration_keys_match_convert_model_state(batchers, tmp_path):
    """An ESPnet .pth of the variant: JAX's convert_model_state reads the
    predictor's keys into the tree that from_jax carries back to the same
    tensors, and load_espnet_a3t builds the variant with them."""
    vocab = batchers[2]
    model = build_model(port_config(_jax_config(vocab)), device="cpu",
                        seed=3)
    tokens = [f"t{i}" for i in range(vocab)]
    pth = espnet.save_espnet_a3t(model, LogMelConfig(**FE), tokens,
                                 str(tmp_path / "espnet"))
    tree = convert_model_state(torch.load(pth, weights_only=True))
    want = predictor(tree["params"]["duration_predictor"],
                     "duration_predictor")
    own = model.state_dict()
    assert set(want) == {k for k in own if k.startswith("duration_predictor")}
    loaded, _, _ = espnet.load_espnet_a3t(pth, device="cpu")
    assert loaded.config.duration_predictor_layers == 2
    for k, v in want.items():
        np.testing.assert_array_equal(v, own[k].numpy(), err_msg=k)
        assert torch.equal(loaded.state_dict()[k], own[k]), k


def test_train_cli_then_sedit(corpus, tmp_path):
    """bin.train on the 24 kHz yaml with the variant switched on, 2 steps
    on the CPU, -> build_model_from_dir -> bin.sedit edit."""
    exp = str(tmp_path / "exp")
    sets = [f"train_data_dir={corpus[0]}", f"valid_data_dir={corpus[1]}",
            f"exp_dir={exp}", "model.duration_predictor_layers=2",
            "model.postnet_layers=2", "model.postnet_chans=16",
            "batcher.batch_bins=7680", "batcher.bucket_frames=[128,256]",
            "frontend.n_mels=20", "trainer.max_epoch=1",
            "trainer.num_iters_per_epoch=2", "trainer.log_interval=1"]
    sets += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
             for k, v in dict(attention_dim=32, linear_units=32,
                              num_blocks=1).items()]
    argv = ["--config", CONFIG, "--device", "cpu", "--log-level", "WARNING"]
    for s in sets:
        argv += ["--set", s]
    trainer, state = train_main(argv)
    assert len(trainer.step_log) == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.step_log)
    assert int(state.opt_state.total_notfinite) == 0
    model, cfg, _ = MLMTask.build_model_from_dir(exp, device="cpu")
    assert model.config.duration_predictor_layers == 2
    texts = read_2column_text(os.path.join(corpus[1], "text"))
    uid = sorted(texts)[0]
    phones = texts[uid].split()
    k = len(phones) // 2
    out = str(tmp_path / "edit.wav")
    res = port_sedit.main([
        "edit", "--exp-dir", exp, "--data-dir", corpus[1], "--uid", uid,
        "--new-text", " ".join(phones[:k] + phones[k + 1:]), "--out", out,
        "--device", "cpu"])
    assert os.path.exists(out) and np.isfinite(res.origin_replaced).all()
