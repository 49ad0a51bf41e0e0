"""The port's config loader (a3t_tpu_torch/tasks/config.py and its YAML
subset reader, tasks/yaml_subset.py) against PyYAML and the JAX package's
``a3t_tpu/tasks/config.py``: the reader equals ``yaml.safe_load`` on every
config the repo ships or stashes and on JAX ``save_config`` output; override
values resolve as ``yaml.safe_load`` resolves them; the JAX loader reads the
port's ``save_config`` output back equal; the port's constants equal the
loaded yamls; and what the port cannot honour is refused.  The FastSpeech2
task configs (``configs/fs2_*.yaml``, ``tasks/fs2.py::FS2TaskConfig``) are
held the same way against JAX's ``_build(FS2TaskConfig, ...)``."""

import dataclasses
import glob
import math
import os

import pytest
import yaml

from a3t_tpu.tasks import config as jax_config
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.tasks import config as port_config
from a3t_tpu_torch.tasks import yaml_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the A3T task configs; configs/fs2_*.yaml are FastSpeech2 task configs
FS2_SHIPPED = sorted(glob.glob(os.path.join(ROOT, "configs", "fs2_*.yaml")))
SHIPPED = sorted(set(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
                 - set(FS2_SHIPPED))
STASHED = [os.path.join(ROOT, "artifacts", n, "config.yaml")
           for n in ("soak12k_params", "spemb_params")]
ALL = SHIPPED + STASHED


def _rel(path):
    return os.path.relpath(path, ROOT)


def test_all_five_config_files_are_present():
    assert len(SHIPPED) == 3 and all(os.path.exists(p) for p in ALL)


@pytest.mark.parametrize("path", ALL + FS2_SHIPPED, ids=_rel)
def test_reader_equals_safe_load(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    want = yaml.safe_load(text)
    assert yaml_subset.load(text) == want
    # the writer's output reads back equal through both readers
    out = yaml_subset.dump(want)
    assert yaml.safe_load(out) == want
    assert yaml_subset.load(out) == want


@pytest.mark.parametrize("path", ALL, ids=_rel)
def test_reader_equals_safe_load_on_jax_save_config(path, tmp_path):
    out = tmp_path / "config.yaml"
    jax_config.save_config(jax_config.load_config(path), str(out))
    text = out.read_text()
    assert yaml_subset.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", ALL, ids=_rel)
def test_port_config_equals_jax_config(path):
    want = jax_config._to_dict(jax_config.load_config(path))
    assert port_config._to_dict(port_config.load_config(path)) == want


@pytest.mark.parametrize("path", ALL, ids=_rel)
def test_jax_reads_port_save_config_back_equal(path, tmp_path):
    out = tmp_path / "config.yaml"
    port_config.save_config(port_config.load_config(path), str(out))
    got = jax_config.load_config(str(out))
    assert jax_config._to_dict(got) == jax_config._to_dict(
        jax_config.load_config(path))


def test_fs2_config_files_are_present():
    assert [_rel(p) for p in FS2_SHIPPED] == ["configs/fs2_conformer_24k.yaml"]


@pytest.mark.parametrize("path", FS2_SHIPPED, ids=_rel)
def test_fs2_config_equals_jax_config(path, tmp_path):
    """load_fs2_config equals JAX's _build(FS2TaskConfig, ...) on the file
    and on JAX's save_config of it; JAX reads the port's save_config back
    equal; the reader equals safe_load on JAX's output."""
    from a3t_tpu.tasks.fs2 import FS2TaskConfig
    from a3t_tpu_torch.tasks.fs2 import load_fs2_config

    def jax_load(p):
        return jax_config._build(FS2TaskConfig, jax_config.load_yaml_dict(p))

    want = jax_config._to_dict(jax_load(path))
    assert port_config._to_dict(load_fs2_config(path)) == want
    jax_out = tmp_path / "jax.yaml"
    jax_config.save_config(jax_load(path), str(jax_out))
    text = jax_out.read_text()
    assert yaml_subset.load(text) == yaml.safe_load(text)
    assert port_config._to_dict(load_fs2_config(str(jax_out))) == want
    port_out = tmp_path / "port.yaml"
    port_config.save_config(load_fs2_config(path), str(port_out))
    assert jax_config._to_dict(jax_load(str(port_out))) == \
        jax_config._to_dict(jax_load(path))


VALUES = ["1e-3", "1.0e-3", "0.5", "[1, 2]", "null", "true", '"x"', "'x'",
          "yes", "off", "~", "", "0x1f", "017", "08", "1_000", ".5", "-.inf",
          "1:30", "3.0e+5", "-2", "exp/a3t", "[valid, loss, min]",
          "{a: 1, b: [2, 3]}", "don't", "a #b", '"a # b"', "'it''s'"]


@pytest.mark.parametrize("raw", VALUES)
def test_override_values_resolve_like_safe_load(raw):
    got = port_config.apply_overrides({}, [f"trainer.x={raw}"])["trainer"]["x"]
    want = yaml.safe_load(raw)
    assert type(got) is type(want)
    assert got == want or (isinstance(want, float) and math.isnan(want)
                           and math.isnan(got))
    # and as the JAX package applies them
    assert jax_config.apply_overrides({}, [f"trainer.x={raw}"]) == {
        "trainer": {"x": got}}


def test_overrides_reach_the_config():
    cfg = port_config.load_config(SHIPPED[0], [
        "trainer.max_epoch=2", "optim.lr=1.0e-3", "batcher.bucket_frames=[256]",
        "model.encoder.compute_dtype=bfloat16", "exp_dir=/tmp/x"])
    assert cfg.trainer.max_epoch == 2 and cfg.optim.lr == 1e-3
    assert cfg.batcher.bucket_frames == (256,)
    assert cfg.model.encoder.compute_dtype == "bfloat16"
    assert cfg.model.decoder.compute_dtype == "float32"
    assert cfg.exp_dir == "/tmp/x"
    # "1e-3" is a string for PyYAML, so it is one here too
    assert port_config.load_config(
        SHIPPED[0], ["optim.lr=1e-3"]).optim.lr == "1e-3"


def test_constants_equal_the_loaded_yamls():
    from a3t_tpu_torch.tasks.config import (FRONTEND_16K, FRONTEND_24K,
                                            OPTIM_24K, a3t_conformer_24k,
                                            a3t_longformer_16k)

    c24 = port_config.load_config(os.path.join(ROOT, "configs",
                                               "a3t_conformer_24k.yaml"))
    assert c24.frontend == FRONTEND_24K and c24.optim == OPTIM_24K
    assert dataclasses.replace(c24.model, vocab_size=80) == a3t_conformer_24k()
    assert dataclasses.replace(
        port_config.load_config(SHIPPED[0], [
            "model.encoder.compute_dtype=bfloat16",
            "model.decoder.compute_dtype=bfloat16"]).model,
        vocab_size=80) == a3t_conformer_24k(compute_dtype="bfloat16")
    c16 = port_config.load_config(os.path.join(ROOT, "configs",
                                               "a3t_longformer_16k.yaml"))
    assert c16.frontend == FRONTEND_16K and c16.optim == OPTIM_24K
    assert dataclasses.replace(c16.model, vocab_size=80) == \
        a3t_longformer_16k()


def test_numerics_neutral_jax_knobs_are_accepted_and_logged():
    """The JAX EncoderConfig's lowering, memory and BatchNorm knobs are
    fields of the port's EncoderConfig, read like any other key and equal
    to what JAX's loader reads."""
    knobs = ["model.encoder.cnn_module_shifted=true",
             "model.decoder.remat=true", "model.encoder.remat_attention=true",
             "model.encoder.positionwise_layer_type=conv1d_shifted",
             "model.decoder.cnn_module_bn_compute_dtype=true"]
    cfg = port_config.load_config(SHIPPED[0], knobs)
    enc, dec = cfg.model.encoder, cfg.model.decoder
    assert enc.cnn_module_shifted and enc.remat_attention and not enc.remat
    assert enc.positionwise_layer_type == "conv1d_shifted"
    assert dec.remat and dec.cnn_module_bn_compute_dtype
    assert not dec.cnn_module_shifted
    assert port_config._to_dict(cfg) == jax_config._to_dict(
        jax_config.load_config(SHIPPED[0], knobs))


def test_refusals():
    with pytest.raises(ValueError, match="true or false"):
        port_config.load_config(SHIPPED[0], ["model.encoder.remat=1"])
    with pytest.raises(KeyError, match="no_such_key"):
        port_config.load_config(SHIPPED[0], ["trainer.no_such_key=1"])
    with pytest.raises(KeyError):
        port_config.load_config(SHIPPED[0], ["model.encoder.nope=1"])
    with pytest.raises(ValueError, match="KEY=VALUE"):
        port_config.apply_overrides({}, ["trainer.max_epoch"])
    for text in ("a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "---\na: 1",
                 "a: 2001-12-14", "? a\n: b", "a: [1, 2", "a: b: c"):
        with pytest.raises(ValueError):
            yaml_subset.load(text)
    with pytest.raises(TypeError):
        yaml_subset.dump({"a": object()})


def test_cli_print_config_and_refused_flags(capsys):
    assert train_main(["--config", SHIPPED[0], "--print-config", "--set",
                       "trainer.max_epoch=3"]) is None
    printed = yaml.safe_load(capsys.readouterr().out)
    want = port_config._to_dict(port_config.load_config(
        SHIPPED[0], ["trainer.max_epoch=3"]))
    assert printed == want
    for flag in (["--prng", "threefry2x32"], ["--coordinator", "h:1"],
                 ["--num-hosts", "2"], ["--host-id", "0"]):
        with pytest.raises(SystemExit):
            train_main(["--config", SHIPPED[0], *flag])
    assert "not ported" in capsys.readouterr().err
