"""Chained dispatch (``trainer.steps_per_dispatch = k > 1``) in the port:
data/batcher.py's ``chained_plan``/``stack_group``, train_step.py's
``make_chained_train_step``, the Trainer's groups and their mid-epoch
resume, and the pre-featurized step (``make_train_step(model, None)``),
against the JAX package, on the CPU, at a toy width (1+1 blocks of width
32, 20 mel bins) on a 24 kHz mini corpus whose two buckets make 3 + 2
batches, so that k = 2 pads the 96-frame bucket's last group.

* Plans and stacked groups equal JAX's bit for bit (values, dtypes,
  ``valid``, ``weights``), also through ``EpochIterFactory(chain=2)`` with
  its window edge.
* A dropout-0 chained step over a group with a padded sub-step against
  JAX's ``make_chained_train_step``: losses within rtol 2e-5, parameters
  within atol 2e-5 (test_torch_train.py's tolerances), zeros at the padded
  entry, one step counted.
* The chained step equals the same sub-steps taken one by one by
  ``make_train_step`` bit for bit, with dropout on and the same generators.
* The Trainer at ``steps_per_dispatch=2`` (through ``MLMTask.build``)
  against JAX's Trainer: per-epoch train and valid losses within rtol 2e-5
  over two epochs (test_torch_trainer.py's tolerance and setting).
* Through ``bin.train``: a run stopped at a mid-epoch save under k = 2 and
  resumed ends bit for bit where the uninterrupted run ends; resumed under
  k = 1 it warns and restarts the epoch from the epoch checkpoint.
* ``make_train_step(model, None)`` on featurized batches equals the step
  that featurizes, bit for bit.
"""

import functools
import logging
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
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TModelConfig as JaxA3TModelConfig
from a3t_tpu.models import EncoderConfig as JaxEncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import Trainer as JaxTrainer
from a3t_tpu.train import TrainerConfig as JaxTrainerConfig
from a3t_tpu.train import make_eval_step as jax_make_eval_step
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train.train_step import TrainState as JaxTrainState
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu.train.train_step import (
    make_chained_train_step as jax_make_chained_train_step)
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.compat.from_jax import load_train_state, mlm_state
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.iterator import EpochIterFactory
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.tasks.config import config_from_dict
from a3t_tpu_torch.tasks.mlm import MLMTask
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_optimizer, make_train_step)
from a3t_tpu_torch.train.checkpoint import CheckpointManager
from a3t_tpu_torch.train.train_step import featurize, make_chained_train_step
from test_torch_mlm import port_config

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
# buckets of 96 and 128 frames, 2 utterances a batch: 3 + 2 batches
BATCHER = dict(batch_bins=20 * 128 * 2, bucket_frames=[96, 128])
TRAINER = dict(max_epoch=2, num_iters_per_epoch=5, log_interval=2,
               keep_nbest_models=2)
K = 2
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("chained")
    return (generate_mini_corpus(str(d / "train"), n_utts=10, fs=24000,
                                 seed=0),
            generate_mini_corpus(str(d / "valid"), n_utts=4, fs=24000,
                                 seed=1))


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
def batchers(corpus):
    tokens = build_token_list(read_2column_text(
        os.path.join(corpus[0], "text")).values())
    port = BucketBatcher(A3TDataset(corpus[0], TokenIDConverter(tokens)),
                         LogMelConfig(**FE), BatcherConfig(**BATCHER))
    jax_ = JaxBucketBatcher(
        JaxA3TDataset(corpus[0], JaxTokenIDConverter(tokens)),
        JaxLogMelConfig(**FE), JaxBatcherConfig(**BATCHER))
    assert [len(m) for m in port.bucket_members] == [6, 4]
    return port, jax_, tokens


def _same_group(got, want):
    assert got[0] == want[0] == "chained"
    assert sorted(got[1]) == sorted(want[1])
    for key in want[1]:
        assert got[1][key].dtype == want[1][key].dtype, key
        np.testing.assert_array_equal(got[1][key], want[1][key], err_msg=key)
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_chained_plans_and_groups_equal_jax(batchers):
    port, jax_, _ = batchers
    for epoch in (1, 2):
        assert port.chained_plan(epoch, K) == jax_.chained_plan(epoch, K)
        groups = list(port.chained_epoch_iterator(epoch, K))
        for got, want in zip(groups, jax_.chained_epoch_iterator(epoch, K),
                             strict=True):
            _same_group(got, want)
        assert sorted(int(g[2].sum()) for g in groups) == [1, 2, 2]
    # the factory's window: 7 steps cut the third group of the second pass
    got = list(EpochIterFactory(port, 7, prefetch=0, chain=K)(3))
    want = list(JaxEpochIterFactory(jax_, 7, prefetch=0, chain=K)(3))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _same_group(a, b)
    assert sum(int(g[2].sum()) for g in got) == 7


def _tiny(dropout=True):
    enc = dict(STACK, cnn_module_kernel=7, **({} if dropout else NO_DROPOUT))
    dec = dict(STACK, cnn_module_kernel=31, **({} if dropout else NO_DROPOUT))
    return enc, dec


@pytest.fixture(scope="module")
def jax_side(batchers):
    """JAX's dropout-0 model (the postnet's 0.5 too, patched for the
    module), front-end, chained step (k = 2, one compile per bucket shared
    by the tests) and initial state."""
    _, _, tokens = batchers
    enc, dec = _tiny(dropout=False)
    cfg = JaxA3TModelConfig(odim=20, vocab_size=len(tokens),
                            encoder=JaxEncoderConfig(**enc),
                            decoder=JaxEncoderConfig(**dec),
                            postnet_layers=2, postnet_chans=16)
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(cfg)
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FE))
        sample = next(batchers[1].epoch_iterator(0))
        # create_train_state's init, jitted (flax's eager init is slow)
        v = jax.jit(functools.partial(model.init, train=False))(
            jax.random.PRNGKey(0), **jax_featurize(
                fe, {k: jnp.asarray(v)[:2] for k, v in sample.items()},
                use_fused=False))
        tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                              params=v["params"],
                              batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), tx=tx)
        step = jax_make_chained_train_step(model, fe, K, donate=False,
                                           use_fused=False)
        yield cfg, model, fe, step, state
    finally:
        jax_mlm.Postnet = postnet


def _port_twin(cfg, jax_state):
    """The port's dropout-0 state carrying JAX's."""
    tm = build_model(port_config(cfg), device="cpu")
    tm.postnet.dropout.rate = 0.0
    ts = create_train_state(tm, make_optimizer(OptimConfig(**OPTIM)),
                            device="cpu")
    return load_train_state(ts, jax_state)


def test_chained_step_matches_jax_with_a_padded_sub_step(batchers,
                                                         jax_side):
    cfg, _, _, step, state = jax_side
    _, stacked, valid, _ = next(g for g in batchers[0].chained_epoch_iterator(
        1, K) if not g[2].all())
    assert list(valid) == [True, False]
    ts = _port_twin(cfg, state)
    state, stats = step(state, {k: jnp.asarray(v) for k, v in
                                stacked.items()}, jax.random.PRNGKey(0),
                        jnp.asarray(valid))
    pfe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    ts, got = make_chained_train_step(ts.model, pfe, K, device="cpu",
                                      use_fused=False)(
        ts, stacked, [0, 1], valid)
    np.testing.assert_allclose(got["loss"].numpy(),
                               np.asarray(stats["loss"]), rtol=2e-5)
    assert float(got["loss"][1]) == 0.0 and float(got["grad_norm"][1]) == 0
    assert ts.step == int(state.step) == 1
    want = mlm_state(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    sd = ts.model.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[name].numpy(), value, atol=2e-5,
                                       rtol=0, err_msg=name)


def _port_model(tokens, seed=0):
    enc, dec = _tiny()
    cfg = config_from_dict({"frontend": FE, "model": dict(
        encoder=enc, decoder=dec, postnet_layers=2, postnet_chans=16)})
    return MLMTask.build_model(cfg, len(tokens), device="cpu")


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_chained_step_equals_sequential_steps(batchers):
    port_b, _, tokens = batchers
    fe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    tag, stacked, valid, weights = next(
        g for g in port_b.chained_epoch_iterator(2, K) if g[2].all())
    gens = [torch.Generator().manual_seed(10 + i) for i in range(K)]
    out = []
    for chained in (True, False):
        model = _port_model(tokens)
        state = create_train_state(model, make_optimizer(
            OptimConfig(**OPTIM)), device="cpu")
        gens = [torch.Generator().manual_seed(10 + i) for i in range(K)]
        if chained:
            state, stats = make_chained_train_step(model, fe, K,
                                                   device="cpu")(
                state, stacked, gens, valid)
            losses = list(stats["loss"])
        else:
            step = make_train_step(model, fe, device="cpu")
            losses = []
            for i in range(K):
                state, s = step(state, {k: v[i] for k, v in stacked.items()},
                                gens[i])
                losses.append(s["loss"])
        out.append((torch.stack(losses), _params(state), state))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[1][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    for f in ("mu", "nu", "count"):
        assert torch.equal(getattr(out[0][2].opt_state, f),
                           getattr(out[1][2].opt_state, f)), f


def test_trainer_losses_equal_jax_trainer(corpus, batchers, jax_side,
                                         tmp_path):
    cfg, model, fe, step, jax_state = jax_side
    enc, dec = _tiny(dropout=False)
    trainer_cfg = dict(TRAINER, steps_per_dispatch=K)
    port_cfg = config_from_dict(dict(
        train_data_dir=corpus[0], valid_data_dir=corpus[1],
        exp_dir=str(tmp_path / "exp"), frontend=FE,
        model=dict(encoder=enc, decoder=dec, postnet_layers=2,
                   postnet_chans=16),
        optim=OPTIM, batcher=BATCHER, trainer=trainer_cfg,
        use_fused_frontend=False))
    trainer, state = MLMTask.build(port_cfg, device="cpu")
    state.model.postnet.dropout.rate = 0.0
    tokens = open(tmp_path / "exp" / "tokens.txt").read().split()
    assert tokens == batchers[2]
    load_train_state(state, jax_state)
    conv = JaxTokenIDConverter(tokens)

    def batcher(d, factor):
        return JaxBucketBatcher(
            JaxA3TDataset(d, conv), JaxLogMelConfig(**FE),
            JaxBatcherConfig(**{**BATCHER, "bucket_frames": (96, 128)},
                             mlm_prob_factor=factor))

    # the eval steps take the matmul-DFT front-end on both sides
    jax_trainer = JaxTrainer(
        JaxTrainerConfig(**trainer_cfg, resume=False), step,
        jax_make_eval_step(model, fe),
        JaxEpochIterFactory(batcher(corpus[0], 0.8), 5, prefetch=0, chain=K),
        JaxEpochIterFactory(batcher(corpus[1], 1.0), None, prefetch=0),
        checkpoint_manager=None)
    jax_trainer.run(jax_state)
    trainer.run(state)
    want, got = jax_trainer.reporter.history, trainer.reporter.history
    assert sorted(got) == sorted(want) == [1, 2]
    for epoch in (1, 2):
        for phase in ("train", "valid"):
            assert got[epoch][phase]["loss"] == pytest.approx(
                want[epoch][phase]["loss"], rel=2e-5), (epoch, phase)
        assert got[epoch]["train"]["masked_frames"] == \
            want[epoch]["train"]["masked_frames"]
        # three groups an epoch, 2 + 2 + 1 sub-steps, in the step log
        recs = [r for r in trainer.step_log if r["epoch"] == epoch]
        assert sorted(r["steps"] for r in recs) == [1, 2, 2]
        assert [r["iteration"] for r in recs] == list(
            np.cumsum([0] + [r["steps"] for r in recs[:-1]]))
    assert state.step == 10


def _argv(corpus, exp, *sets):
    out = [f"train_data_dir={corpus[0]}", f"valid_data_dir={corpus[1]}",
           f"exp_dir={exp}", "model.postnet_layers=2",
           "model.postnet_chans=16", f"batcher.batch_bins="
           f"{BATCHER['batch_bins']}", "batcher.bucket_frames=[96,128]",
           "frontend.n_mels=20", "trainer.save_interval_steps=2"]
    out += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
            for k, v in STACK.items()]
    out += [f"trainer.{k}={v}" for k, v in TRAINER.items()]
    argv = ["--config", CONFIG, "--device", "cpu", "--log-level", "WARNING"]
    for s in (*out, *sets):
        argv += ["--set", s]
    return argv


def test_mid_epoch_resume_under_a_chain(corpus, tmp_path, monkeypatch,
                                        caplog):
    chain = f"trainer.steps_per_dispatch={K}"
    _, full = train_main(_argv(corpus, str(tmp_path / "a"), chain))
    want = _params(full)
    save = CheckpointManager.save_mid_epoch

    def save_then_stop(self, epoch, iteration, *args, **kw):
        save(self, epoch, iteration, *args, **kw)
        if epoch == 2:
            raise KeyboardInterrupt("stopped after the mid-epoch save")

    for exp in ("b", "c"):
        monkeypatch.setattr(CheckpointManager, "save_mid_epoch",
                            save_then_stop)
        with pytest.raises(KeyboardInterrupt):
            train_main(_argv(corpus, str(tmp_path / exp), chain))
        monkeypatch.undo()
        assert CheckpointManager(str(tmp_path / exp / "checkpoints")
                                 ).latest_mid_epoch() == (2, 2)
    trainer, state = train_main(_argv(corpus, str(tmp_path / "b"), chain))
    assert [(r["epoch"], r["iteration"]) for r in trainer.step_log] == [
        (2, 2), (2, 4)]
    got = _params(state)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # resumed under another k: the epoch restore stands
    with caplog.at_level(logging.WARNING, logger="a3t_tpu_torch"):
        trainer, _ = train_main(_argv(corpus, str(tmp_path / "c")))
    assert any("steps_per_dispatch=2" in r.getMessage()
               for r in caplog.records)
    assert [(r["epoch"], r["iteration"]) for r in trainer.step_log] == [
        (2, i) for i in range(5)]


def test_prefeaturized_step_equals_the_featurizing_step(batchers):
    port_b, _, tokens = batchers
    fe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    host = next(port_b.epoch_iterator(1))
    out = []
    for pre in (False, True):
        model = _port_model(tokens)
        state = create_train_state(model, make_optimizer(
            OptimConfig(**OPTIM)), device="cpu")
        if pre:
            step = make_train_step(model, None, device="cpu")
            batch = {k: v for k, v in featurize(fe, host).items()}
        else:
            step = make_train_step(model, fe, device="cpu")
            batch = host
        state, stats = step(state, batch, 4)
        out.append((stats["loss"], _params(state)))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    with pytest.raises(ValueError, match="model runs on cpu"):
        make_train_step(_port_model(tokens), None, device="meta")
