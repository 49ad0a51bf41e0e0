"""Multi-corpus training in the port (a3t_tpu_torch/data/multi_corpus.py,
the task's ``corpora``) against the JAX package, on the CPU, on a toy copy
of configs/a3t_multi_corpus.yaml's layout: its three entries, with
``libritts`` and ``vctk`` on a 24 kHz corpus and ``librispeech`` on a 16
kHz speech-only corpus with the entry's own front-end, at a toy width (1+1
blocks of width 32, 20 mel bins, no postnet).

* ``MultiCorpusIterFactory``'s ``(name, batch)`` sequence equals JAX's bit
  for bit over two epochs (the portions' counts, the shuffled schedule,
  every array of every batch).
* ``bin.train --device cpu`` on the toy copy, every dropout rate 0, warm
  started from JAX's initial parameters (``trainer.init_params_dir``),
  against JAX's Trainer over ``MultiCorpusIterFactory`` and
  ``make_multi_corpus_train_step`` from the same parameters: the per-epoch
  train and valid losses within rtol 2e-5 over two epochs
  (test_torch_trainer.py's tolerance: the frameworks' front-ends differ by
  ~1e-5 in log-mel), the masked frames exactly, and each corpus's steps in
  the step log.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data.batcher import BatcherConfig as JaxBatcherConfig
from a3t_tpu.data.batcher import BucketBatcher as JaxBucketBatcher
from a3t_tpu.data.dataset import A3TDataset as JaxA3TDataset
from a3t_tpu.data.iterator import EpochIterFactory as JaxEpochIterFactory
from a3t_tpu.data.multi_corpus import CorpusSpec as JaxCorpusSpec
from a3t_tpu.data.multi_corpus import (
    MultiCorpusIterFactory as JaxMultiCorpusIterFactory)
from a3t_tpu.data.multi_corpus import (
    make_multi_corpus_train_step as jax_make_multi_corpus_train_step)
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TMLMModel as JaxA3TMLMModel
from a3t_tpu.models import A3TModelConfig as JaxA3TModelConfig
from a3t_tpu.models import EncoderConfig as JaxEncoderConfig
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import Trainer as JaxTrainer
from a3t_tpu.train import TrainerConfig as JaxTrainerConfig
from a3t_tpu.train import make_eval_step as jax_make_eval_step
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train.train_step import TrainState as JaxTrainState
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.data.multi_corpus import (CorpusSpec,
                                             MultiCorpusIterFactory)
from a3t_tpu_torch.dsp import LogMelConfig
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.tasks import yaml_subset
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from test_torch_mlm import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "a3t_multi_corpus.yaml")
N_MELS = 20
STACK = dict(attention_dim=32, attention_heads=2, linear_units=32,
             num_blocks=1, dropout_rate=0.0, positional_dropout_rate=0.0,
             attention_dropout_rate=0.0)
OPTIM = dict(lr=1.0, model_size=32, warmup_steps=100, grad_clip=1.0,
             adam_eps=1e-3)
BATCHER = dict(batch_bins=N_MELS * 256 * 2, bucket_frames=[128, 256])
ITERS = 5  # 3 + 1 + 1 batches an epoch by the yaml's portions
@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy copy of the yaml's layout: (config path, corpora entries,
    24 kHz train dir, 24 kHz valid dir, 16 kHz dir, token list)."""
    d = tmp_path_factory.mktemp("multi")
    c24 = generate_mini_corpus(str(d / "c24"), n_utts=10, fs=24000, seed=0)
    v24 = generate_mini_corpus(str(d / "v24"), n_utts=3, fs=24000, seed=1)
    c16 = generate_mini_corpus(str(d / "c16"), n_utts=6, fs=16000, seed=2)
    data = yaml_subset.load_file(CONFIG)
    dirs = {"libritts": c24, "librispeech": c16, "vctk": c24}
    for entry in data["corpora"]:
        entry["data_dir"] = dirs[entry["name"]]
        if "frontend" in entry:
            entry["frontend"]["n_mels"] = N_MELS
    data.update(train_data_dir=c24, valid_data_dir=v24,
                exp_dir=str(d / "exp"))
    data["frontend"]["n_mels"] = N_MELS
    path = str(d / "multi_toy.yaml")
    with open(path, "w") as f:
        f.write(yaml_subset.dump(data))
    tokens = build_token_list(read_2column_text(
        os.path.join(c24, "text")).values())
    return path, data["corpora"], c24, v24, c16, tokens


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


def _factories(toy, prefetch=0):
    _, corpora, _, _, _, tokens = toy
    port, jax_ = [], []
    for e in corpora:
        so = bool(e.get("speech_only", False))
        fe = e.get("frontend", {"fs": 24000, "n_fft": 2048,
                                "hop_length": 300, "win_length": 1200,
                                "n_mels": N_MELS, "fmin": 80.0,
                                "fmax": 7600.0})
        port.append(CorpusSpec(e["name"], BucketBatcher(
            A3TDataset(e["data_dir"], TokenIDConverter(tokens),
                       speech_only=so), LogMelConfig(**fe),
            BatcherConfig(**BATCHER)), e["portion"], speech_only=so))
        jax_.append(JaxCorpusSpec(e["name"], JaxBucketBatcher(
            JaxA3TDataset(e["data_dir"], JaxTokenIDConverter(tokens),
                          speech_only=so), JaxLogMelConfig(**fe),
            JaxBatcherConfig(**{**BATCHER, "bucket_frames": (128, 256)})),
            e["portion"], speech_only=so))
    return (MultiCorpusIterFactory(port, ITERS, prefetch=prefetch),
            JaxMultiCorpusIterFactory(jax_, ITERS, prefetch=prefetch))


def test_factory_sequence_equals_jax(toy):
    port, jax_ = _factories(toy)
    for epoch in (1, 2):
        got, want = list(port(epoch)), list(jax_(epoch))
        assert [n for n, _ in got] == [n for n, _ in want]
        assert sorted(n for n, _ in got) == [
            "librispeech", "libritts", "libritts", "libritts", "vctk"]
        for (name, a), (_, b) in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            if name == "librispeech":
                assert (a["text"][a["audio_lengths"] > 0, 0] == 1).all()


def test_cli_losses_equal_jax_trainer(toy, tmp_path):
    path, corpora, c24, v24, c16, tokens = toy
    enc = JaxEncoderConfig(**STACK, cnn_module_kernel=7)
    dec = JaxEncoderConfig(**STACK, cnn_module_kernel=31)
    cfg = JaxA3TModelConfig(odim=N_MELS, vocab_size=len(tokens),
                            encoder=enc, decoder=dec, postnet_layers=0)
    model = JaxA3TMLMModel(cfg)
    _, train_f = _factories(toy)
    fe24 = JaxLogMelFrontend(JaxLogMelConfig(**yaml_subset.load_file(
        path)["frontend"]))
    fes = {s.name: JaxLogMelFrontend(s.batcher.fe) for s in train_f.corpora}
    sample = next(train_f.corpora[0].batcher.epoch_iterator(0))
    v = jax.jit(lambda key, mb: model.init(key, **mb, train=False))(
        jax.random.PRNGKey(0), jax_featurize(
            fe24, {k: jnp.asarray(a)[:2] for k, a in sample.items()},
            use_fused=False))
    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), tx=tx)
    # the JAX init as a port parameter file, the CLI's warm start
    port_model = build_model(port_config(cfg), device="cpu")
    load_state(port_model, mlm_state(jax.tree_util.tree_map(np.asarray, v)))
    init = str(tmp_path / "init.pt")
    torch.save({"params": dict(port_model.named_parameters())}, init)

    valid_f = JaxEpochIterFactory(JaxBucketBatcher(
        JaxA3TDataset(v24, JaxTokenIDConverter(tokens)), fe24.config,
        JaxBatcherConfig(**{**BATCHER, "bucket_frames": (128, 256)},
                         mlm_prob_factor=1.0)), None, prefetch=0)
    trainer_cfg = dict(max_epoch=2, num_iters_per_epoch=ITERS,
                       log_interval=2, keep_nbest_models=2)
    jax_trainer = JaxTrainer(
        JaxTrainerConfig(**trainer_cfg, resume=False),
        jax_make_multi_corpus_train_step(model, fes, {
            s.name: s.speech_only for s in train_f.corpora}),
        jax_make_eval_step(model, fe24), train_f, valid_f,
        checkpoint_manager=None)
    jax_trainer.run(state)

    sets = [f"exp_dir={tmp_path / 'exp'}", "model.postnet_layers=0",
            f"optim.adam_eps={OPTIM['adam_eps']}",
            f"optim.model_size={OPTIM['model_size']}",
            f"optim.warmup_steps={OPTIM['warmup_steps']}",
            f"batcher.batch_bins={BATCHER['batch_bins']}",
            "batcher.bucket_frames=[128,256]",
            f"trainer.init_params_dir={init}",
            *(f"trainer.{k}={v}" for k, v in trainer_cfg.items())]
    sets += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
             for k, v in STACK.items()]
    argv = ["--config", path, "--device", "cpu", "--log-level", "WARNING"]
    for s in sets:
        argv += ["--set", s]
    trainer, port_state = train_main(argv)
    want, got = jax_trainer.reporter.history, trainer.reporter.history
    assert sorted(got) == sorted(want) == [1, 2]
    for epoch in (1, 2):
        for phase in ("train", "valid"):
            assert got[epoch][phase]["loss"] == pytest.approx(
                want[epoch][phase]["loss"], rel=2e-5), (epoch, phase)
        assert got[epoch]["train"]["masked_frames"] == \
            want[epoch]["train"]["masked_frames"]
    names = [r["corpus"] for r in trainer.step_log if r["epoch"] == 1]
    assert names == [n for n, _ in _factories(toy)[0](1)]
    assert port_state.step == 2 * ITERS
