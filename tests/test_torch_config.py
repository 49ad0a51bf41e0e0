"""The port's config loader (a3t_tpu_torch/tasks/config.py and its YAML
subset reader, tasks/yaml_subset.py) against PyYAML and the JAX package's
``a3t_tpu/tasks/config.py``: the reader equals ``yaml.safe_load`` on every
config the repo ships or stashes and on JAX ``save_config`` output; override
values resolve as ``yaml.safe_load`` resolves them; the JAX loader reads the
port's ``save_config`` output back equal; the port's constants equal the
loaded yamls; and what the port cannot honour is refused."""

import dataclasses
import glob
import logging
import math
import os

import pytest
import yaml

from a3t_tpu.tasks import config as jax_config
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.tasks import config as port_config
from a3t_tpu_torch.tasks import yaml_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
STASHED = [os.path.join(ROOT, "artifacts", n, "config.yaml")
           for n in ("soak12k_params", "spemb_params")]
ALL = SHIPPED + STASHED
JAX_ONLY = ("cnn_module_shifted", "cnn_module_bn_compute_dtype", "remat",
            "remat_attention")


def _rel(path):
    return os.path.relpath(path, ROOT)


def _without_jax_only(d):
    """A JAX config dict without the four EncoderConfig keys the port has
    no field for."""
    d = dict(d)
    model = dict(d["model"])
    for stack in ("encoder", "decoder"):
        if model.get(stack) is not None:
            model[stack] = {k: v for k, v in model[stack].items()
                            if k not in JAX_ONLY}
    d["model"] = model
    return d


def test_all_five_config_files_are_present():
    assert len(SHIPPED) == 3 and all(os.path.exists(p) for p in ALL)


@pytest.mark.parametrize("path", ALL, ids=_rel)
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
    want = _without_jax_only(jax_config._to_dict(jax_config.load_config(path)))
    assert port_config._to_dict(port_config.load_config(path)) == want


@pytest.mark.parametrize("path", ALL, ids=_rel)
def test_jax_reads_port_save_config_back_equal(path, tmp_path):
    out = tmp_path / "config.yaml"
    port_config.save_config(port_config.load_config(path), str(out))
    got = jax_config.load_config(str(out))
    assert jax_config._to_dict(got) == jax_config._to_dict(
        jax_config.load_config(path))


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


def test_numerics_neutral_jax_knobs_are_accepted_and_logged(caplog):
    knobs = ["model.encoder.cnn_module_shifted=true",
             "model.decoder.remat=true", "model.encoder.remat_attention=false",
             "model.encoder.cnn_module_bn_compute_dtype=false"]
    with caplog.at_level(logging.INFO, logger="a3t_tpu_torch"):
        cfg = port_config.load_config(SHIPPED[0], knobs)
    lines = [r.getMessage() for r in caplog.records if "dropped" in
             r.getMessage()]
    assert len(lines) == 1
    assert "config.model.encoder.cnn_module_shifted" in lines[0]
    assert "config.model.decoder.remat" in lines[0]
    assert "remat_attention" not in lines[0]
    assert cfg.model.encoder == port_config.load_config(SHIPPED[0]).model.encoder


def test_refusals():
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        port_config.load_config(
            SHIPPED[0], ["model.decoder.cnn_module_bn_compute_dtype=true"])
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
