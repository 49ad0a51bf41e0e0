"""The port's per-epoch plots (a3t_tpu_torch/train/plots.py,
train/reporter.py::Reporter.plot, the trainer's plot_fn and its wiring in
tasks/mlm.py) against the JAX package's train/plots.py, on the CPU, on
tests/test_plots.py's tiny model (8 kHz, 2 + 1 blocks of width 32, postnet
1 x 8, 20 mel bins) with JAX's weights carried by compat/from_jax.py.

* The mel plot's arrays (target, reconstruction, masked positions, valid
  frames) equal JAX's forward in make_mel_plot_fn: features within 1e-4
  (the two rfft front-ends round differently; log10-mels of O(1)),
  reconstructions within 2e-4 (the model's fp32 summation order on top),
  the masks exactly.
* The attention plot's captured probabilities (in call order, where JAX's
  tree lists the decoder first) equal the probabilities JAX's modules sow,
  layer by layer, within 1e-5 (softmax outputs in [0, 1]), and each row
  sums to 1 within 1e-5.  The port's
  model takes its flash branch (K1's plain version on the CPU) in training
  and is back on it after the plot pass.
* PNG files are written (matplotlib is installed here), one per example and
  plot, and Reporter.plot writes one file per metric, the names JAX's
  writes.
* bin.train with num_plot_examples writes the plots after each epoch.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.train import plots as jax_plots
from a3t_tpu.train.reporter import Reporter as JaxReporter
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models.attention import RelPositionMultiHeadedAttention
from a3t_tpu_torch.train import plots
from a3t_tpu_torch.train.reporter import Reporter
from test_plots import tiny
from test_torch_bf16_24k import _random
from test_torch_mlm import port_config

FE = dict(fs=8000, n_fft=256, hop_length=64, win_length=256, n_mels=20,
          fmin=20, fmax=4000)


@pytest.fixture
def one_thread():
    """One intra-op thread for the Trainer run (tests/test_torch_trainer.py
    gives the reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX variables, port model, port front-end, batch)."""
    jmodel, jfe, batch = tiny()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = _random(jmodel.init(jax.random.PRNGKey(0),
                            **jax_featurize(jfe, jb, use_fused=False),
                            train=False))
    model = build_model(port_config(jmodel.config), device="cpu")
    from_jax.load_state(model, from_jax.mlm_state(v))
    return jmodel, jfe, v, model, LogMelFrontend(LogMelConfig(**FE),
                                                 device="cpu"), batch


class _State:
    def __init__(self, model):
        self.model = model


def test_mel_plot_arrays_match_jax(pair, tmp_path):
    jmodel, jfe, v, model, fe, batch = pair
    mb = jax_featurize(jfe, {k: jnp.asarray(a) for k, a in batch.items()},
                       use_fused=False)
    _, after, _ = jmodel.apply(v, **mb, train=False)
    model.train()
    fn = plots.make_mel_plot_fn(fe, None, batch, str(tmp_path), n_examples=2)
    target, pred, masked, valid = fn(_State(model), 3)
    assert model.training  # the plot pass leaves the mode as it was
    np.testing.assert_allclose(target.numpy(), np.asarray(mb["speech"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(pred.numpy(), np.asarray(after), atol=2e-4,
                               rtol=0)
    np.testing.assert_array_equal(masked.numpy(),
                                  np.asarray(mb["masked_position"]))
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(mb["speech_mask"]))
    assert sorted(os.listdir(tmp_path)) == ["epoch3_utt0.png",
                                            "epoch3_utt1.png"]


def test_attention_plot_arrays_match_jax(pair, tmp_path):
    jmodel, jfe, v, model, fe, batch = pair
    n = 1
    jb = {k: jnp.asarray(a[:n]) for k, a in batch.items()}
    _, inter = jmodel.apply(v, **jax_featurize(jfe, jb, use_fused=False),
                            train=False, mutable=["intermediates"])
    want = dict(jax_plots._attn_entries(jax.tree.map(
        np.asarray, inter["intermediates"])))
    fn = plots.make_attention_plot_fn(fe, None, batch, str(tmp_path),
                                      n_examples=n)
    got = fn(_State(model), 2)
    assert [name for name, _ in got] == [
        "encoder.encoders.0.self_attn", "encoder.encoders.1.self_attn",
        "decoder.encoders.0.self_attn"]
    assert len(want) == 3
    for name, a in got:
        stack, _, i, _ = name.split(".")
        w = want[f"{stack}/block_{i}/self_attn/attn"]
        assert a.shape == w.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, atol=1e-5)
    flash = [m.use_flash for m in model.modules()
             if isinstance(m, RelPositionMultiHeadedAttention)]
    assert flash == [True] * 3
    assert all(getattr(m, "capture", None) is None for m in model.modules())
    assert os.listdir(tmp_path) == ["att_epoch2_utt0.png"]


def test_longformer_attention_plot_is_skipped(caplog):
    from test_torch_longformer import _config

    model = build_model(port_config(_config("float32")), device="cpu")
    fe = LogMelFrontend(LogMelConfig(**{**FE, "fs": 16000}), device="cpu")
    with caplog.at_level("INFO", logger="a3t_tpu_torch"):
        got = plots.make_attention_plot_fn(fe, None, {}, "unused")(
            _State(model), 1)
    assert got == [] and "skipping attention plots" in caplog.text


def test_reporter_plot_writes_one_file_per_metric(tmp_path):
    history = {1: {"train": {"loss": 3.0, "grad_norm": 9.0},
                   "valid": {"loss": 2.5}},
               2: {"train": {"loss": 2.0, "grad_norm": 7.0},
                   "valid": {"loss": 2.1}}}
    port, jax_rep = Reporter(), JaxReporter()
    port.load_state_dict({"history": history, "epoch": 2})
    jax_rep.load_state_dict({"history": history, "epoch": 2})
    port.plot(str(tmp_path / "port"))
    jax_rep.plot(str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == ["grad_norm.png", "loss.png"]


def test_bin_train_writes_plots(tmp_path, one_thread):
    """bin.train on a 24 kHz mini corpus at a toy width with
    num_plot_examples=2: each epoch's mel and attention plots."""
    train = generate_mini_corpus(str(tmp_path / "train"), n_utts=6,
                                 fs=24000, seed=0)
    valid = generate_mini_corpus(str(tmp_path / "valid"), n_utts=2,
                                 fs=24000, seed=1)
    exp = tmp_path / "exp"
    sets = [f"train_data_dir={train}", f"valid_data_dir={valid}",
            f"exp_dir={exp}", "model.postnet_layers=1",
            "model.postnet_chans=8", "frontend.n_mels=20",
            "batcher.batch_bins=15360", "batcher.bucket_frames=[256]",
            "trainer.max_epoch=2", "trainer.num_iters_per_epoch=1",
            "num_plot_examples=2"]
    sets += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
             for k, v in dict(attention_dim=16, linear_units=16,
                              num_blocks=1).items()]
    argv = ["--config", os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "a3t_conformer_24k.yaml"),
            "--device", "cpu", "--log-level", "WARNING"]
    for s in sets:
        argv += ["--set", s]
    train_main(argv)
    files = sorted(os.listdir(exp / "plots"))
    assert files == sorted(f"{p}epoch{e}_utt{i}.png" for p in ("", "att_")
                           for e in (1, 2) for i in (0, 1))


def test_plots_without_matplotlib_compute_their_arrays(pair, tmp_path,
                                                        monkeypatch, caplog):
    """Where matplotlib is not installed the arrays are still computed and
    a line is logged; nothing is written."""
    _, _, _, model, fe, batch = pair

    def missing():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(plots, "_pyplot", missing)
    with caplog.at_level("WARNING", logger="a3t_tpu_torch"):
        arrays = plots.make_mel_plot_fn(fe, None, batch, str(tmp_path))(
            _State(model), 1)
        entries = plots.make_attention_plot_fn(fe, None, batch,
                                               str(tmp_path))(_State(model), 1)
    assert len(arrays) == 4 and len(entries) == 3
    assert caplog.text.count("plots not rendered") == 2
    assert os.listdir(tmp_path) == []
