"""The port's Trainer, checkpoints, task and CLI (a3t_tpu_torch/train/
trainer.py, checkpoint.py, tasks/mlm.py, bin/train.py) on a generated
24 kHz mini corpus, on the CPU, at a tiny width (1+1 blocks of width 32,
postnet 2x16, 20 mel bins).

* Against the JAX package's Trainer: both start from one state (JAX's
  init, carried over by compat/from_jax.py::load_train_state) with every
  dropout rate 0 (the postnet's fixed 0.5 too, as in test_torch_train.py)
  and the same batches (the batchers agree bit for bit,
  test_torch_data.py); the per-epoch train and valid losses agree within
  rtol 2e-5, test_torch_train.py's loss tolerance (the two front-ends
  differ by ~1e-5 in log-mel, and the frameworks sum in another order).
  Adam's eps is 1e-3 for the reason given there.  The warmup is 100
  steps (lr 5.6e-4 per step of warmup, the losses still fall by a sixth in
  six steps): with test_torch_train.py's 10, six Adam steps of ~3e-2 each
  carry the frameworks' rounding differences to 1.5e-5 of the second
  epoch's valid loss; at 100 the largest gap read 1.3e-7.
* Resume, with the configs' dropout on: a run stopped after epoch 1 and
  one stopped at a mid-epoch save, each started again, end with
  parameters and BatchNorm statistics equal to the uninterrupted run's bit
  for bit.
* The n-best average, warm start, the all-non-finite stop, and
  ``bin.train.main([..., "--device", "cpu"])`` -> ``build_model_from_dir``.
"""

import dataclasses
import functools
import os
import types

import numpy as np
import pytest
import torch
import jax

from a3t_tpu.data.batcher import BatcherConfig as JaxBatcherConfig
from a3t_tpu.data.batcher import BucketBatcher as JaxBucketBatcher
from a3t_tpu.data.dataset import A3TDataset as JaxA3TDataset
from a3t_tpu.data.iterator import EpochIterFactory as JaxEpochIterFactory
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TModelConfig as JaxA3TModelConfig
from a3t_tpu.models import EncoderConfig as JaxEncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import Trainer as JaxTrainer
from a3t_tpu.train import TrainerConfig as JaxTrainerConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_eval_step as jax_make_eval_step
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.compat.from_jax import load_train_state
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.dsp import LogMelFrontend
from a3t_tpu_torch.tasks.config import config_from_dict
from a3t_tpu_torch.tasks.mlm import MLMTask
from a3t_tpu_torch.train import checkpoint as ckpt
from a3t_tpu_torch.train.checkpoint import CheckpointManager
from a3t_tpu_torch.train.trainer import Trainer, TrainerConfig
from a3t_tpu_torch.train.train_step import featurize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml")
FE = dict(fs=24000, n_fft=2048, hop_length=300, win_length=1200, n_mels=20,
          fmin=80.0, fmax=7600.0)
STACK = dict(attention_dim=32, attention_heads=2, linear_units=32,
             num_blocks=1)
NO_DROPOUT = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                  attention_dropout_rate=0.0)
OPTIM = dict(lr=1.0, model_size=32, warmup_steps=100, grad_clip=1.0,
             adam_eps=1e-3)
# one bucket of 256 frames, 3 utterances a batch: the 10 training
# utterances make 4 batches an epoch, of which 3 are taken
BATCHER = dict(batch_bins=20 * 256 * 3, bucket_frames=[256])
TRAINER = dict(max_epoch=2, num_iters_per_epoch=3, log_interval=2,
               keep_nbest_models=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the toy model's many small ops run no slower,
    and the test workers running beside this one do not oversubscribe the
    cores (with a thread pool per worker, these Trainer runs took over 10
    times their time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("mini24k")
    return (generate_mini_corpus(str(d / "train"), n_utts=10, fs=24000,
                                 seed=0),
            generate_mini_corpus(str(d / "valid"), n_utts=4, fs=24000,
                                 seed=1))


def _sets(corpus, exp_dir, **extra):
    """--set arguments: the tiny model on the yaml's layout."""
    out = [f"train_data_dir={corpus[0]}", f"valid_data_dir={corpus[1]}",
           f"exp_dir={exp_dir}", "model.postnet_layers=2",
           "model.postnet_chans=16",
           f"batcher.batch_bins={BATCHER['batch_bins']}",
           "batcher.bucket_frames=[256]", "frontend.n_mels=20"]
    out += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
            for k, v in STACK.items()]
    out += [f"trainer.{k}={v}" for k, v in {**TRAINER, **extra}.items()]
    argv = ["--config", CONFIG, "--device", "cpu", "--log-level", "WARNING"]
    for s in out:
        argv += ["--set", s]
    return argv


def _model_state(state) -> dict:
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _assert_bit_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_losses_equal_jax_trainer(corpus, tmp_path):
    port_cfg = config_from_dict(dict(
        train_data_dir=corpus[0], valid_data_dir=corpus[1],
        exp_dir=str(tmp_path / "exp"), frontend=FE,
        model=dict(encoder=dict(STACK, cnn_module_kernel=7, **NO_DROPOUT),
                   decoder=dict(STACK, cnn_module_kernel=31, **NO_DROPOUT),
                   postnet_layers=2, postnet_chans=16),
        optim=OPTIM, batcher=BATCHER, trainer=TRAINER))
    trainer, state = MLMTask.build(port_cfg, device="cpu")
    state.model.postnet.dropout.rate = 0.0
    conv_tokens = open(tmp_path / "exp" / "tokens.txt").read().split()

    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        conv = JaxTokenIDConverter(conv_tokens)
        model = jax_mlm.A3TMLMModel(JaxA3TModelConfig(
            odim=20, vocab_size=len(conv),
            encoder=JaxEncoderConfig(**STACK, cnn_module_kernel=7,
                                     **NO_DROPOUT),
            decoder=JaxEncoderConfig(**STACK, cnn_module_kernel=31,
                                     **NO_DROPOUT),
            postnet_layers=2, postnet_chans=16))
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FE))

        def batcher(d, factor):
            return JaxBucketBatcher(
                JaxA3TDataset(d, conv), JaxLogMelConfig(**FE),
                JaxBatcherConfig(**{**BATCHER, "bucket_frames": (256,)},
                                 mlm_prob_factor=factor))

        train_f = JaxEpochIterFactory(batcher(corpus[0], 0.8), 3, prefetch=0)
        valid_f = JaxEpochIterFactory(batcher(corpus[1], 1.0), None,
                                      prefetch=0)
        sample = next(iter(train_f(0)))
        jax_state = jax_create_train_state(
            model, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
            jax_featurize(fe, {k: v[:2] for k, v in sample.items()},
                          use_fused=False),
            rng=jax.random.PRNGKey(0))
        load_train_state(state, jax_state)
        jax_trainer = JaxTrainer(
            JaxTrainerConfig(**TRAINER, resume=False),
            jax_make_train_step(model, fe, donate=False),
            jax_make_eval_step(model, fe), train_f, valid_f,
            checkpoint_manager=None)
        jax_trainer.run(jax_state)
    finally:
        jax_mlm.Postnet = postnet

    trainer.run(state)
    want, got = jax_trainer.reporter.history, trainer.reporter.history
    assert sorted(got) == sorted(want) == [1, 2]
    for epoch in (1, 2):
        for phase in ("train", "valid"):
            assert got[epoch][phase]["loss"] == pytest.approx(
                want[epoch][phase]["loss"], rel=2e-5), (epoch, phase)
        assert got[epoch]["train"]["masked_frames"] == \
            want[epoch]["train"]["masked_frames"]
    # three steps an epoch, each bracketed in the step log
    assert [(r["epoch"], r["iteration"]) for r in trainer.step_log] == [
        (e, i) for e in (1, 2) for i in range(3)]
    assert all(r["batch"] == 3 and r["frames"] == 256
               for r in trainer.step_log)


@pytest.fixture(scope="module")
def run_a(corpus, tmp_path_factory):
    """The uninterrupted run through the CLI, the configs' dropout on, with
    a mid-epoch save every 2 steps."""
    exp = str(tmp_path_factory.mktemp("run_a") / "exp")
    trainer, state = train_main(_sets(corpus, exp, save_interval_steps=2))
    return exp, trainer, _model_state(state)


def test_cli_writes_the_experiment_and_build_model_from_dir_serves(
        corpus, run_a):
    exp, trainer, final = run_a
    assert sorted(os.listdir(exp)) == ["checkpoints", "config.yaml",
                                       "tokens.txt"]
    names = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    assert names == ["LATEST", "ave_2best.pt", "epoch_1.pt", "epoch_2.pt",
                     "meta.json"]
    assert trainer.config.num_iters_per_epoch == 3
    assert [b.batch_size for b in trainer.train_iter_factory.batcher.buckets
            ] == [3]
    assert all(np.isfinite(h["train"]["loss"]) and
               np.isfinite(h["valid"]["loss"])
               for h in trainer.reporter.history.values())

    model, cfg, conv = MLMTask.build_model_from_dir(exp, device="cpu")
    assert not model.training and cfg.trainer.max_epoch == 2
    ave = ckpt.load_params(os.path.join(exp, "checkpoints", "ave_2best.pt"))
    epoch2 = ckpt.load_params(os.path.join(exp, "checkpoints", "epoch_2.pt"))
    sd = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, ave[k] if k in ave else epoch2[k]), k
    # BatchNorm statistics come from the last epoch, not a fresh init
    bn = [k for k in sd if k.endswith("running_var")]
    assert bn and all(torch.equal(sd[k], final[k]) for k in bn)
    valid = MLMTask.build_batcher(cfg, corpus[1], conv, train=False)
    batch = next(valid.epoch_iterator(0))
    fe = LogMelFrontend(cfg.frontend, device="cpu")
    with torch.no_grad():
        before, after = model(**featurize(fe, batch))
    assert after.shape == (3, 256, 20)
    assert torch.isfinite(before).all() and torch.isfinite(after).all()


def test_average_nbest_is_the_mean_of_the_kept_epochs(run_a):
    exp, _, _ = run_a
    d = os.path.join(exp, "checkpoints")
    ave = ckpt.load_params(os.path.join(d, "ave_2best.pt"))
    e1, e2 = (ckpt.load_params(os.path.join(d, f"epoch_{e}.pt"))
              for e in (1, 2))
    assert ave.keys() < e1.keys()  # parameters only, no BatchNorm stats
    for k, v in ave.items():
        want = ((e1[k].double() + e2[k].double()) / 2).to(v.dtype)
        assert torch.equal(v, want), k
    assert not all(torch.equal(e1[k], e2[k]) for k in ave)


def test_epoch_resume_is_bit_exact(corpus, run_a, tmp_path):
    exp = str(tmp_path / "exp")
    train_main(_sets(corpus, exp, save_interval_steps=2, max_epoch=1))
    assert CheckpointManager(os.path.join(exp, "checkpoints")
                             ).latest_epoch() == 1
    trainer, state = train_main(_sets(corpus, exp, save_interval_steps=2))
    assert [r["epoch"] for r in trainer.step_log] == [2, 2, 2]
    _assert_bit_equal(_model_state(state), run_a[2])


def test_mid_epoch_resume_is_bit_exact(corpus, run_a, tmp_path, monkeypatch):
    exp = str(tmp_path / "exp")
    save = CheckpointManager.save_mid_epoch

    def save_then_stop(self, epoch, iteration, *args, **kw):
        save(self, epoch, iteration, *args, **kw)
        if epoch == 2:
            raise KeyboardInterrupt("stopped after the mid-epoch save")

    monkeypatch.setattr(CheckpointManager, "save_mid_epoch", save_then_stop)
    with pytest.raises(KeyboardInterrupt):
        train_main(_sets(corpus, exp, save_interval_steps=2))
    monkeypatch.undo()
    manager = CheckpointManager(os.path.join(exp, "checkpoints"))
    assert manager.latest_mid_epoch() == (2, 2)
    assert manager.latest_epoch() == 1
    trainer, state = train_main(_sets(corpus, exp, save_interval_steps=2))
    assert [(r["epoch"], r["iteration"]) for r in trainer.step_log] == [(2, 2)]
    _assert_bit_equal(_model_state(state), run_a[2])
    assert manager.latest_mid_epoch() is None  # cleared by the epoch save


def test_warm_start(run_a, corpus, tmp_path):
    exp, _, _ = run_a
    ave_path = os.path.join(exp, "checkpoints", "ave_2best.pt")
    trainer, state = train_main(_sets(
        corpus, str(tmp_path / "exp"), max_epoch=1, num_iters_per_epoch=1,
        init_params_dir=ave_path))
    assert trainer.step_log and state.step == 1
    cfg = config_from_dict({"frontend": FE, "model": dict(
        encoder=dict(STACK, cnn_module_kernel=7),
        decoder=dict(STACK, cnn_module_kernel=31), postnet_layers=2,
        postnet_chans=16)})
    ave = ckpt.load_params(ave_path)
    vocab = ave["encoder.text_embed.0.weight"].shape[0]
    model = MLMTask.build_model(cfg, vocab, device="cpu")
    ckpt.warm_start_params(model, ave_path)
    for k, p in model.named_parameters():
        assert torch.equal(p, ave[k]), k
    grown = MLMTask.build_model(cfg, vocab + 3, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.warm_start_params(grown, ave_path)
    ckpt.warm_start_params(grown, ave_path, grow_vocab=True)
    emb = grown.encoder.text_embed[0].weight
    assert torch.equal(emb[:vocab], ave["encoder.text_embed.0.weight"])
    no_postnet = MLMTask.build_model(
        dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, postnet_layers=0)), vocab, device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        ckpt.warm_start_params(no_postnet, ave_path)


def test_all_non_finite_epoch_stops_training():
    """Every step of epoch 1 skipped as non-finite: training stops before
    validating or saving (reference trainer.py:445-451)."""
    def make(skip_every):
        state = types.SimpleNamespace(
            model=torch.nn.Linear(1, 1),
            opt_state=types.SimpleNamespace(total_notfinite=torch.tensor(0)))
        calls = {"n": 0}

        def step(state, batch, gen):
            calls["n"] += 1
            if calls["n"] % skip_every == 0:
                state.opt_state.total_notfinite += 1
            return state, {"loss": torch.tensor(float("nan"))}

        def factory(epoch):
            return ({"masked_position": np.zeros((2, 8), bool)}
                    for _ in range(4))

        trainer = Trainer(TrainerConfig(max_epoch=3, num_iters_per_epoch=4),
                          step, lambda s, b: {"loss": torch.tensor(1.0)},
                          factory, factory)
        trainer.run(state)
        return trainer, calls["n"]

    trainer, n = make(skip_every=1)
    assert n == 4 and trainer.reporter.history == {}
    trainer, n = make(skip_every=2)
    assert n == 12 and sorted(trainer.reporter.history) == [1, 2, 3]


def test_task_refusals(corpus, tmp_path, caplog):
    base = dict(train_data_dir=corpus[0], exp_dir=str(tmp_path / "exp"),
                frontend=FE, model=dict(encoder=STACK, decoder=STACK,
                                        postnet_layers=1))
    # per-epoch plots are ported (tests/test_torch_plots.py); a mesh is not
    with pytest.raises(NotImplementedError, match="A10"):
        MLMTask.build(config_from_dict(
            {**base, "mesh": {"tensor_parallel": 2}}), device="cpu")
    # speaker conditioning is ported: without embeddings for its batches
    # the task raises
    with pytest.raises(ValueError, match="neither"):
        MLMTask.build(config_from_dict({**base, "model": {
            **base["model"], "spemb_dim": 8}}), device="cpu")
    # chained dispatch is ported (tests/test_torch_chained.py); the
    # duration-aware variant falls back to one step per call, as in JAX
    with caplog.at_level("WARNING", logger="a3t_tpu_torch"):
        trainer, _ = MLMTask.build(config_from_dict({
            **base, "model": {**base["model"], "duration_predictor_layers": 2},
            "trainer": {"steps_per_dispatch": 2}}), device="cpu")
    assert trainer.config.steps_per_dispatch == 1
    assert "falling back to 1" in caplog.text
    trainer, _ = MLMTask.build(config_from_dict({
        **base, "trainer": {"steps_per_dispatch": 4}}), device="cpu")
    assert trainer.train_iter_factory.chain == 4
    # record shards are ported (tests/test_torch_records.py)
    records = tmp_path / "records"
    records.mkdir()
    (records / "index.npz").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="meta.json"):
        MLMTask.build_batcher(config_from_dict(base), str(records), None,
                              True)
    with pytest.raises(ValueError, match="half-window"):
        MLMTask.build(config_from_dict({**base, "model": {"encoder": {
            **STACK, "selfattention_layer_type": "longformer",
            "attention_window": 512}}, "batcher": {
                "bucket_frames": [300]}}), device="cpu")
