"""The port's bin.export_params (a3t_tpu_torch/bin/export_params.py) and the
warm start from its output (train/checkpoint.py::load_params on a directory,
trainer.init_params_dir): a toy experiment trained by bin.train on the CPU,
exported in every dtype.  The bf16 cast is held against the one JAX's
export_params makes (numpy's astype to ml_dtypes' bfloat16, round to nearest
even) bit for bit; everything else is compared exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3t_tpu_torch.bin.export_params import main as export_main
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.tasks.mlm import MLMTask
from a3t_tpu_torch.train import trainer as trainer_mod
from a3t_tpu_torch.train.checkpoint import load_params, warm_start_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml")
TOY = ["frontend.n_mels=16", "model.postnet_layers=1",
       "model.postnet_chans=8", "batcher.batch_bins=4096",
       "batcher.bucket_frames=[256]", "trainer.max_epoch=1",
       "trainer.num_iters_per_epoch=1", "trainer.keep_nbest_models=1"] + [
    f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
    for k, v in (("attention_dim", 16), ("linear_units", 16),
                 ("num_blocks", 1))]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, so that the test workers beside this one are
    not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(data, exp, *sets):
    argv = ["--config", CONFIG, "--device", "cpu", "--log-level", "WARNING"]
    for s in (f"train_data_dir={data}", f"valid_data_dir={data}",
              f"exp_dir={exp}", *TOY, *sets):
        argv += ["--set", s]
    return argv


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """(data dir, exp dir, the trained parameters) of one toy step."""
    base = tmp_path_factory.mktemp("export")
    data = generate_mini_corpus(str(base / "data"), n_utts=4, fs=24000)
    exp = str(base / "exp")
    _, state = train_main(_argv(data, exp))
    params = {k: v.detach().clone()
              for k, v in state.model.named_parameters()}
    return data, exp, params


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "keep"])
def test_export_every_dtype(exp, tmp_path, dtype):
    """params.pt holds exactly the model's parameters (no BatchNorm
    statistics), cast as asked; tokens.txt and config.yaml come along."""
    _, exp_dir, params = exp
    out = str(tmp_path / "stash")
    assert export_main(["--exp", exp_dir, "--out", out, "--dtype", dtype,
                        "--device", "cpu"]) == out
    assert sorted(os.listdir(out)) == ["config.yaml", "params.pt",
                                       "tokens.txt"]
    for name in ("config.yaml", "tokens.txt"):
        with open(os.path.join(out, name), "rb") as f, \
                open(os.path.join(exp_dir, name), "rb") as g:
            assert f.read() == g.read()
    tree = torch.load(os.path.join(out, "params.pt"), weights_only=True)
    assert list(tree) == ["params"]
    got = tree["params"]
    assert sorted(got) == sorted(params)
    assert load_params(out).keys() == got.keys()
    for k, v in params.items():
        if dtype == "bfloat16":
            assert got[k].dtype == torch.bfloat16
            want = np.asarray(v.numpy()).astype(jnp.bfloat16)
            np.testing.assert_array_equal(
                got[k].view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert got[k].dtype == torch.float32
            assert torch.equal(got[k], v)


def test_export_epoch_and_checkpoint_file(exp, tmp_path):
    """--epoch 1 and --epoch with the checkpoint's file name export the same
    parameters as latest; an ave_* file exports too."""
    _, exp_dir, _ = exp
    ckpt = os.path.join(exp_dir, "checkpoints")
    outs = []
    for i, epoch in enumerate(("latest", "1", "epoch_1.pt")):
        outs.append(str(tmp_path / f"s{i}"))
        export_main(["--exp", exp_dir, "--epoch", epoch, "--out", outs[-1],
                     "--dtype", "keep", "--device", "cpu"])
    first = load_params(outs[0])
    for o in outs[1:]:
        other = load_params(o)
        assert all(torch.equal(first[k], other[k]) for k in first)
    ave = sorted(n for n in os.listdir(ckpt) if n.startswith("ave_"))
    export_main(["--exp", exp_dir, "--epoch", ave[-1], "--out",
                 str(tmp_path / "ave"), "--dtype", "keep", "--device", "cpu"])
    assert load_params(str(tmp_path / "ave")).keys() == first.keys()


def test_export_replaces_atomically(exp, tmp_path, monkeypatch):
    """An export replaces an earlier stash and a stale ``.tmp``; one that
    fails before its replace leaves the earlier stash whole."""
    _, exp_dir, _ = exp
    out = str(tmp_path / "stash")
    os.makedirs(out)
    with open(os.path.join(out, "old"), "w") as f:
        f.write("earlier stash")
    os.makedirs(out + ".tmp")
    export_main(["--exp", exp_dir, "--out", out, "--dtype", "float32",
                 "--device", "cpu"])
    assert not os.path.exists(out + ".tmp")
    assert "old" not in os.listdir(out)
    before = {n: open(os.path.join(out, n), "rb").read()
              for n in os.listdir(out)}

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        export_main(["--exp", exp_dir, "--out", out, "--dtype", "bfloat16",
                     "--device", "cpu"])
    assert {n: open(os.path.join(out, n), "rb").read()
            for n in os.listdir(out)} == before


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_warm_start_from_export(exp, tmp_path, monkeypatch, dtype):
    """bin.train with trainer.init_params_dir set to an export starts from
    the exported parameters cast back to float32, bit for bit (seen right
    after the warm start, before the first step); BatchNorm statistics keep
    their fresh values."""
    data, exp_dir, params = exp
    out = str(tmp_path / "stash")
    export_main(["--exp", exp_dir, "--out", out, "--dtype", dtype,
                 "--device", "cpu"])
    exported = load_params(out)
    seen = {}

    def watched(model, path, **kw):
        model = warm_start_params(model, path, **kw)
        seen["params"] = {k: v.detach().clone()
                          for k, v in model.named_parameters()}
        seen["buffers"] = {k: v.detach().clone()
                           for k, v in model.named_buffers()}
        return model

    monkeypatch.setattr(trainer_mod, "warm_start_params", watched)
    train_main(_argv(data, str(tmp_path / "warm"),
                     f"trainer.init_params_dir={out}"))
    assert sorted(seen["params"]) == sorted(params)
    for k, v in seen["params"].items():
        assert v.dtype == torch.float32
        assert torch.equal(v, exported[k].float())
        if dtype == "float32":
            assert torch.equal(v, params[k])
    fresh = MLMTask.build_model(*_fresh_cfg(data, tmp_path), device="cpu")
    for k, v in fresh.named_buffers():
        assert torch.equal(seen["buffers"][k], v)


def _fresh_cfg(data, tmp_path):
    from a3t_tpu_torch.tasks.config import load_config
    from a3t_tpu_torch.text import TokenIDConverter

    cfg = load_config(CONFIG, [f"train_data_dir={data}", *TOY])
    tokens = TokenIDConverter(os.path.join(str(tmp_path / "warm"),
                                           "tokens.txt"))
    return cfg, len(tokens)
